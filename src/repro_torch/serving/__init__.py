"""Serving for the port (``repro.serving``): the LM ``ServeEngine`` and
reconstruction serving.

``ServeEngine`` serves LM requests in waves over one shared KV cache
(``ServeConfig``, ``Request``); ``ReconstructionServer`` admits queued
``RunSpec`` jobs as fleet waves, streams their history, snapshots them
and retries faulted jobs from checkpoint (``repro_torch.serving.engine``).
"""
from repro_torch.serving.engine import (ReconstructionJob,
                                        ReconstructionServer, Request,
                                        ServeConfig, ServeEngine)

__all__ = ["ReconstructionJob", "ReconstructionServer", "Request",
           "ServeConfig", "ServeEngine"]
