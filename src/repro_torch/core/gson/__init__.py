"""Growing self-organizing networks: state, topology, the multi-signal
step, samplers, metrics and the fused loop."""
