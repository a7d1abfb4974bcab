"""Find Winners on Hopper: the kernel's wrapper and its plain versions.

Replaces the Pallas TPU kernel
``src/repro/kernels/find_winners/kernel.py:52`` (``_find_winners_kernel``,
launched by ``find_winners_pallas_padded``). For each signal it finds the
two nearest *active* units:

    d2 = max(|x|^2 - 2 x.w + |w|^2, 0) + (inactive ? 1e30 : 0),

the two smallest, ties to the lowest id, in float32 FMA (a tensor-core
product would round to TF32 and flip winners). The CUDA source,
``csrc/find_winners.cu``, makes two launches per call: the first packs
each network's active units once, in id order, with |w|^2 beside each
row (``compact_active_plain`` is that step in plain PyTorch); the second,
launched with programmatic dependent launch, scans only those rows. It
has two regimes (``regime``): for many signals, 32 signals per block
whose 8 warps split the rows; for few, one signal per block whose 256
threads split them.

Bound on an H100 at the main path's shapes (M = 8192, about 300 active
of C = 4096 units, d = 3): 8 flops per (signal, active unit) pair,
20 MFLOP, about 0.3 us at the FP32 peak of 67 TFLOP/s; the bytes
(0.25 MB) take under 0.1 us. Operations bound it.

``find_winners_top2`` launches the kernel for a CUDA tensor and raises if
it cannot; for a CPU tensor it runs ``find_winners_top2_plain``, the same
function in plain PyTorch. ``find_winners_top2.launches`` counts its
calls that launched the kernel (two device launches each).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LARGE = 1e30
REGIMES = ("many", "few")
# The few-signal regime while a call has at most this many signals in
# all (B * M): on an H100 it was the faster of the two up to B * M = 256
# on the grown pools of ~290 active units at C = 4096 and 32768, and
# the slower from 512 on at C = 4096 (`tools/bench_find_winners.py
# --sweep`).
FEW_MAX_SIGNALS = 256


def regime(B: int, M: int) -> str:
    """The scan's regime for B networks of M signals each: ``"few"`` (one
    signal per block, its 256 threads split the units) while B * M is at
    most ``FEW_MAX_SIGNALS``, else ``"many"`` (32 signals per block, its
    8 warps split the units)."""
    return "few" if B * M <= FEW_MAX_SIGNALS else "many"


def padded_dim(d: int) -> int:
    """Floats per packed row: d weights and |w|^2, rounded up to 4."""
    return (d + 4) // 4 * 4


def _id_stride(C: int) -> int:
    """Ids per network in the workspace: C rounded up to whole 16 bytes."""
    return -(-C // 4) * 4


def workspace_words(B: int, C: int, d: int) -> int:
    """32-bit words of the kernel's workspace: the packed rows
    (B, C, Dp) f32, the ids (B, round_up(C, 4)) i32 (each network's on a
    16-byte boundary) and the counts (B,) i32."""
    return B * (C * padded_dim(d) + _id_stride(C) + 1)


def _split(ws: torch.Tensor, B: int, C: int, d: int):
    rows, stride = B * C * padded_dim(d), _id_stride(C)
    packed = ws[:rows].view(torch.float32).view(B, C, padded_dim(d))
    ids = ws[rows:rows + B * stride].view(B, stride)[:, :C]
    return packed, ids, ws[rows + B * stride:]


def compact_active_plain(w: torch.Tensor, active: torch.Tensor):
    """The kernel's first step in plain PyTorch: w (B, C, d) f32, active
    (B, C) bool -> packed (B, C, Dp) f32 (the active units' rows in id
    order, |w|^2 in lane d, zeros after), ids (B, C) i32 (their ids) and
    count (B,) i32. |w|^2 is summed in k order, one rounding per product
    and per sum, as the kernel sums it. Rows past count are zero, ids
    there -1; the kernel leaves them unwritten."""
    B, C, d = w.shape
    count = active.sum(dim=1, dtype=torch.int32)
    # a stable sort puts the active ids first, in id order
    order = torch.sort((~active).to(torch.int8), dim=1, stable=True).indices
    rows = torch.gather(w, 1, order[..., None].expand(B, C, d))
    sq = torch.zeros((B, C), dtype=torch.float32, device=w.device)
    for k in range(d):
        sq = sq + rows[..., k] * rows[..., k]
    live = torch.arange(C, device=w.device)[None, :] < count[:, None]
    packed = torch.zeros((B, C, padded_dim(d)), dtype=torch.float32,
                         device=w.device)
    packed[..., :d] = rows
    packed[..., d] = sq
    packed = torch.where(live[..., None], packed, 0.0)
    ids = torch.where(live, order, -1).to(torch.int32)
    return packed, ids, count


def compact_active(w: torch.Tensor, active: torch.Tensor):
    """The kernel's first launch alone (for tests): the workspace's packed
    rows, ids and count as ``compact_active_plain`` returns them, rows
    past count unwritten. Needs CUDA tensors: it has no CPU version."""
    B, C, D = w.shape
    dev = w.device
    _build.check("w", w, torch.float32, (B, C, D), dev)
    _build.check("active", active, torch.bool, (B, C), dev)
    if not 1 <= D <= 8:
        raise ValueError(f"find_winners kernel takes 1 <= dim <= 8, got {D}")
    ws = torch.empty(workspace_words(B, C, D), dtype=torch.int32, device=dev)
    _build.launch("find_winners", "repro_compact_active", [w, active, ws],
                  [B, C, D])
    return _split(ws, B, C, D)


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
                      active: torch.Tensor, *, scan: str | None = None):
    """Top-2 nearest active units per signal, batched over B networks.

    signals (B, M, d) f32, w (B, C, d) f32, active (B, C) bool ->
    (B, M, 2) f32 distances, (B, M, 2) i32 ids. ``scan`` forces a regime
    (``"many"`` or ``"few"``; by default ``regime(B, M)``): both give the
    same answer.
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
    scan = regime(B, M) if scan is None else scan
    if scan not in REGIMES:
        raise ValueError(f"scan must be one of {REGIMES}, got {scan!r}")
    out_d = torch.empty((B, M, 2), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, M, 2), dtype=torch.int32, device=dev)
    ws = torch.empty(workspace_words(B, C, D), dtype=torch.int32, device=dev)
    _build.launch("find_winners", "repro_find_winners",
                  [signals, w, active, out_d, out_i, ws],
                  [B, M, C, D, REGIMES.index(scan)])
    find_winners_top2.launches += 1
    return out_d, out_i


find_winners_top2.launches = 0
