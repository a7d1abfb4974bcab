"""The LM substrate of the port (``repro.models``): configs and
primitives (``common``), attention, the dense/VLM transformer and the
model registry. Plain PyTorch: the JAX package computes these in jnp,
outside any Pallas kernel."""
