"""Training of the port's LM (``repro.training``'s counterpart) on one
device: the optimizers (``optimizer``), the train step with microbatch
accumulation (``trainer``) and the error-feedback state
(``compression``). The pod-manual step and ``compressed_psum`` need a
process group and wait for the LM's meshes (ROADMAP A15f)."""
