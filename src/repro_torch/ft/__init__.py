"""Fault tolerance for the port: heartbeats, failure injection and the
elastic checkpoint-restart loop (``repro_torch.ft.elastic``)."""
from repro_torch.ft.elastic import (ElasticRunner, FailureInjector, PodHealth,
                                    downed_pods)

__all__ = ["ElasticRunner", "FailureInjector", "PodHealth", "downed_pods"]
