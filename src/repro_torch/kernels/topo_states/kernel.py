"""The SOAM topology refresh on Hopper: the state ladder's kernel wrapper.

Replaces no Pallas kernel: the JAX package's refresh is plain jnp. Its
plain PyTorch version, ``repro_torch.core.gson.topology.
compute_topo_states_plain``, builds every slot's link graph as a
(B, C, K, K, K) comparison and its connectivity by ``bmm`` squarings,
several GB of intermediates a refresh at the paper's pool (B = 32,
C = 32768), where under 1% of the slots hold a unit with edges. The CUDA
source, ``csrc/topo_states.cu``, computes the same states bit for bit in
two launches: the first reads every row's K ids once and builds the link
graph of each row that has edges as K bit masks in registers; the second
(programmatic dependent launch) decides PATCH from the neighbors' states.
Nothing on the device is larger than the (B, C) output.

Bound on an H100: bytes, the id table, the firing counters, the flags and
the states once each; at the paper.fleet32 shape (B = 32, C = 32768,
K = 16) 76.5 MB, 23 us at 3.35 TB/s, at sphere4k.fleet64 (B = 64,
C = 4096) 19 MB, 6 us.

``topology.compute_topo_states`` calls ``topo_states`` for a CUDA tensor
and ``compute_topo_states_plain`` for a CPU tensor.
``topo_states.launches`` counts the calls that launched the kernel (two
device launches each).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

MAX_DEG = 32   # a row's link graph is K masks of 32 bits


@functools.lru_cache(maxsize=64)
def threshold_bits(x: float) -> int:
    """The bits of ``x`` as float32, the precision in which PyTorch
    compares a float32 tensor with a Python float."""
    return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))


def topo_states(nbr: torch.Tensor, active: torch.Tensor,
                firing: torch.Tensor, firing_threshold: float) -> torch.Tensor:
    """The SOAM state ladder of every slot: nbr (B, C, K) i32 with
    1 <= K <= 32, active (B, C) bool, firing (B, C) f32, all contiguous
    on one CUDA device -> (B, C) i32 states, bitwise those of
    ``compute_topo_states_plain``. Raises for anything else."""
    if nbr.dim() != 3:
        raise ValueError(f"nbr: expected (B, C, K), got {tuple(nbr.shape)}")
    B, C, K = nbr.shape
    dev = nbr.device
    _build.check("nbr", nbr, torch.int32, (B, C, K), dev)
    _build.check("active", active, torch.bool, (B, C), dev)
    _build.check("firing", firing, torch.float32, (B, C), dev)
    if not 1 <= K <= MAX_DEG:
        raise ValueError(f"topo_states kernel takes 1 <= max_deg <= "
                         f"{MAX_DEG}, got {K}")
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    if B * C == 0:
        return out
    pre = torch.empty((B, C), dtype=torch.uint8, device=dev)
    _build.launch("topo_states", "repro_topo_states",
                  [nbr, active, firing, pre, out],
                  [B, C, K, threshold_bits(float(firing_threshold))])
    topo_states.launches += 1
    return out


topo_states.launches = 0
