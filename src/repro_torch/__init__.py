"""repro_torch — the PyTorch and CUDA port of ``repro``, for one NVIDIA H100.

The package keeps the layout and names of the JAX package ``repro``,
which stays the reference it is tested against. It imports ``torch`` and
never ``jax`` or ``repro``. Its public run API is ``repro_torch.gson``;
its hot phases run through hand-written Hopper kernels under
``repro_torch.kernels``. Entry points run on the card unless the caller
asks for the CPU (``RunSpec(device="cpu")``).
"""
