"""The LM substrate of the port (``repro.models``): configs, sharding
rules and primitives (``common``), attention, the dense/VLM transformer,
the MoE FFN, the SSM, hybrid and enc-dec families and the model registry;
on a mesh, ``placement`` (how a rank holds its shards and computes) and
``act_sharding`` (activation layouts). Plain PyTorch: the JAX package
computes these in jnp, outside any Pallas kernel."""
