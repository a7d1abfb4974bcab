"""Find Winners on Hopper: the kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel
``src/repro/kernels/find_winners/kernel.py:52`` (``_find_winners_kernel``,
launched by ``find_winners_pallas_padded``). For each signal it finds the
two nearest *active* units:

    d2 = max(|x|^2 - 2 x.w + |w|^2, 0) + (inactive ? 1e30 : 0),

the two smallest, ties to the lowest id. The CUDA source,
``csrc/find_winners.cu``, is the paper's own design: one signal per
lane, unit tiles staged in shared memory, a top-2 in registers, in
float32 FMA (a tensor-core product would round to TF32 and flip
winners). Each tile is compacted to its active units as it is staged,
so a mostly empty pool costs the scan of its active units only.

Bound on an H100 at the main path's shapes (M = 8192, about 300 active
of C = 4096 units, d = 3): 8 flops per (signal, active unit) pair,
20 MFLOP, about 0.3 us at the FP32 peak of 67 TFLOP/s; the bytes
(0.25 MB) take under 0.1 us. Operations bound it.

``find_winners_top2`` launches the kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs ``find_winners_top2_plain``, the same
function in plain PyTorch. ``find_winners_top2.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LARGE = 1e30


def find_winners_top2_plain(signals: torch.Tensor, w: torch.Tensor,
                            active: torch.Tensor):
    """Plain PyTorch version: (B, M, d), (B, C, d), (B, C) bool ->
    (B, M, 2) f32 distances, (B, M, 2) i32 ids. Needs C >= 2."""
    x2 = (signals * signals).sum(dim=-1, keepdim=True)          # (B, M, 1)
    w2 = (w * w).sum(dim=-1)[:, None, :]                        # (B, 1, C)
    xw = torch.bmm(signals, w.transpose(1, 2))                  # (B, M, C)
    bias = torch.where(active, 0.0, LARGE)[:, None, :]
    d2 = (x2 - 2.0 * xw + w2).clamp(min=0.0) + bias
    i1 = d2.argmin(dim=-1, keepdim=True)
    d1 = torch.gather(d2, -1, i1)
    d2m = d2.scatter(-1, i1, torch.inf)
    i2 = d2m.argmin(dim=-1, keepdim=True)
    ds = torch.gather(d2m, -1, i2)
    return (torch.cat([d1, ds], dim=-1),
            torch.cat([i1, i2], dim=-1).to(torch.int32))


def find_winners_top2(signals: torch.Tensor, w: torch.Tensor,
                      active: torch.Tensor):
    """Top-2 nearest active units per signal, batched over B networks.

    signals (B, M, d) f32, w (B, C, d) f32, active (B, C) bool ->
    (B, M, 2) f32 distances, (B, M, 2) i32 ids.
    """
    if signals.device.type == "cpu":
        return find_winners_top2_plain(signals, w, active)
    B, M, D = signals.shape
    C = w.shape[1]
    dev = signals.device
    _build.check("signals", signals, torch.float32, (B, M, D), dev)
    _build.check("w", w, torch.float32, (B, C, D), dev)
    _build.check("active", active, torch.bool, (B, C), dev)
    if not 1 <= D <= 8:
        raise ValueError(f"find_winners kernel takes 1 <= dim <= 8, got {D}")
    out_d = torch.empty((B, M, 2), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, M, 2), dtype=torch.int32, device=dev)
    _build.launch("find_winners", "repro_find_winners",
                  [signals, w, active, out_d, out_i], [B, M, C, D])
    find_winners_top2.launches += 1
    return out_d, out_i


find_winners_top2.launches = 0
