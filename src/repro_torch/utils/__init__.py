"""Helpers of the port: tracing spans, timers and the bookkeeping of
parameter trees."""
from repro_torch.utils.timing import span, summary, timed, tracing
from repro_torch.utils.trees import tree_bytes, tree_param_count

__all__ = ["span", "summary", "timed", "tracing", "tree_bytes",
           "tree_param_count"]
