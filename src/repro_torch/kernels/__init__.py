"""Hand-written Hopper kernels for the two hot phases of the step.

Each kernel package holds ``kernel.py`` (the wrapper that launches the
CUDA kernel for CUDA tensors, the plain PyTorch version that runs for CPU
tensors, and a launch counter), ``ops.py`` (the engine-facing op around
it) and ``ref.py`` (an independent oracle for the tests). The CUDA
sources live in each package's ``csrc/`` and are built by ``_build.py``
on first use.
"""
