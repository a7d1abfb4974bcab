"""The port's tracing: named spans in the program, on the profiler's clock.

``span(name)`` marks a phase of the program where its work happens (the
GSON loop's spans are ``gson.tick``, ``gson.draws``, ``gson.find_winners``,
``gson.update``, ``gson.tail``, ``gson.refresh``, ``gson.screen``,
``gson.check`` and ``gson.wait``, the last around each blocking read of
the device). Spans nest; the innermost open span owns the host time and
the device operations launched inside it.

Tracing is off unless switched on. Off, ``span`` returns one shared
no-op context: no allocation, no profiler event, no clock read. On,
a span opens a ``torch.profiler.record_function`` range, so that it
shows in any active profiler trace on the clock the device's operations
are on, and appends ``(name, start_ns, end_ns, depth, tick)`` to an
in-memory log on ``time.perf_counter_ns``: ``depth`` counts the spans
open around it, ``tick`` is the cohort tick it ran in (every span of one
``Cohort.tick`` carries that tick's number; ``None`` outside a tick).

An operator sees where a fleet iteration's host and device time go::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.utils import timing

    timing.clear()
    with timing.tracing(True), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sess.run(budget=16)                 # a FleetSession
    print(timing.summary())                 # host ms and calls per span
    print(prof.key_averages().table(sort_by="cuda_time_total"))

``summary()`` gives each span's host time, in all and of its own (the
part not inside a nested span), and calls: ``gson.wait`` is the host
blocked on a read of the device, the rest of ``gson.tick`` the host
issuing work (or blocked inside an operation that synchronises on its
own). The profiler is optional; without it the log alone costs a clock
read and a tuple per span. The log lives in this process and grows
until ``clear()``; spans are recorded from the thread that drives the
loop.

``timed`` and ``synchronize`` time whole calls, waited for on the device.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.utils.trees import tree_leaves

_NOOP = contextlib.nullcontext()


class _Log:
    """The process's switch, its open spans and the finished spans."""

    def __init__(self):
        self.on = False
        self.depth = 0
        self.tick = None
        self.spans: list = []


_LOG = _Log()


class _Span:
    __slots__ = ("name", "tick", "prev_tick", "rf", "t0", "depth")

    def __init__(self, name: str, tick):
        self.name, self.tick = name, tick

    def __enter__(self):
        log = _LOG
        self.prev_tick = log.tick
        if self.tick is not None:
            log.tick = self.tick
        self.depth = log.depth
        log.depth += 1
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        log = _LOG
        log.depth -= 1
        log.spans.append((self.name, self.t0, t1, self.depth, log.tick))
        log.tick = self.prev_tick
        return False


def span(name: str, tick: int | None = None):
    """A context that records ``name`` while tracing is on (a shared
    no-op context while it is off). ``tick`` marks the spans opened
    inside it, itself included, as that tick's."""
    if not _LOG.on:
        return _NOOP
    return _Span(name, tick)


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switch tracing ``on`` (or off) for the process, inside the
    ``with`` block; the previous setting returns after it."""
    prev = _LOG.on
    _LOG.on = bool(on)
    try:
        yield
    finally:
        _LOG.on = prev


def spans() -> list:
    """The finished spans, ``(name, start_ns, end_ns, depth, tick)``,
    in the order they ended."""
    return list(_LOG.spans)


def clear() -> None:
    """Empty the log."""
    _LOG.spans.clear()


def summary() -> str:
    """Per span name of the log: host ms in all, host ms of its own
    (outside the spans nested in it), its share of all own time, and
    calls; largest own time first."""
    log = _LOG.spans
    total: dict = {}
    own: dict = {}
    calls: dict = {}
    for name, s, e, _, _ in log:
        total[name] = total.get(name, 0) + (e - s)
        own[name] = own.get(name, 0) + (e - s)
        calls[name] = calls.get(name, 0) + 1
    # in the order they opened, outer first: a span's time is taken off
    # the span it opened in
    stack: list = []
    for name, s, e, _, _ in sorted(log, key=lambda x: (x[1], x[3])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            own[stack[-1][0]] -= e - s
        stack.append((name, e))
    whole = sum(own.values()) or 1
    lines = [f"{'span':>18s} {'ms':>10s} {'own ms':>10s} {'own':>6s} "
             f"{'calls':>7s}"]
    for name in sorted(own, key=own.get, reverse=True):
        lines.append(f"{name:>18s} {total[name] / 1e6:10.3f} "
                     f"{own[name] / 1e6:10.3f} "
                     f"{100.0 * own[name] / whole:5.1f}% {calls[name]:7d}")
    return "\n".join(lines)


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a
    tensor or a dict/list/tuple tree of them)."""
    for dev in {t.device for t in tree_leaves(result)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def timed(fn, *args, n: int = 5, warmup: int = 1, **kwargs):
    """Return (result, seconds_per_call), each call waited for on the
    devices its result lies on."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        synchronize(result)
    t0 = time.perf_counter()
    for _ in range(n):
        result = fn(*args, **kwargs)
        synchronize(result)
    return result, (time.perf_counter() - t0) / n
