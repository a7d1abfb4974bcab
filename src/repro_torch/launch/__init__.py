"""Launchers of the port (``repro.launch``): ``serve`` (the LM
``ServeEngine`` over a queue of requests). Training (``train``, ``steps``)
waits for ROADMAP A15b, ``mesh`` for A15f, and the XLA tooling
(``dryrun``, ``hlo_analysis``, ``roofline``) for A15g."""
