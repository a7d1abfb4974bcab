"""Launchers of the port (``repro.launch``): ``serve`` (the LM
``ServeEngine`` over a queue of requests), ``train`` (the LM's train loop
on one device, with checkpoints) and ``steps`` (the deployment table and
the train step). ``mesh`` waits for ROADMAP A15f, and the XLA tooling
(``dryrun``, ``hlo_analysis``, ``roofline``) for A15g."""
