"""Serving for the port: the reconstruction half of ``repro.serving``.

``ReconstructionServer`` admits queued ``RunSpec`` jobs as fleet waves,
streams their history, snapshots them and retries faulted jobs from
checkpoint (``repro_torch.serving.engine``). The LM half of the JAX
package's serving (``ServeEngine``, ``ServeConfig``) waits for the LM
substrate (ROADMAP A15).
"""
from repro_torch.serving.engine import ReconstructionJob, ReconstructionServer

__all__ = ["ReconstructionJob", "ReconstructionServer"]
