"""Launchers of the port (``repro.launch``): ``serve`` (the LM
``ServeEngine`` over a queue of requests), ``train`` (the LM's train loop
on the world's mesh, with checkpoints), ``steps`` (the deployment table,
the sharding specs and the sharded train / prefill / decode steps) and
``mesh`` (``LMMesh``: ranks laid out over named axes on
``torch.distributed``). The XLA tooling (``dryrun``, ``hlo_analysis``,
``roofline``) waits for ROADMAP A15g."""
