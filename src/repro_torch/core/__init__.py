"""Core of the port: the network state, the multi-signal step and its
fused loop (``repro_torch.core.gson``)."""
