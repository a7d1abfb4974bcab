"""Public wrapper for the Find Winners kernel (paper Sec. 2.5): padding of
a pool smaller than two units, the degenerate second slot, and the
engine-facing ``FindWinnersFn``. One kernel launch serves every network
of a fleet; called without the network axis, a fleet of one."""
from __future__ import annotations

import torch

from repro_torch.core.gson.batch import batchable
from repro_torch.kernels.find_winners.kernel import LARGE, find_winners_top2


@batchable(3)
def find_winners_op(signals: torch.Tensor, w: torch.Tensor,
                    active: torch.Tensor):
    """Top-2 nearest active units for each signal of each network, via
    the kernel.

    signals (B, m, d), w (B, C, d), active (B, C) bool -> (top2_d2
    (B, m, 2) f32, top2_ids (B, m, 2) i32). Where a network has fewer
    than 2 active units its winner is duplicated into the second slot
    instead of reporting an inactive unit (per element, no host branch).
    """
    signals = signals.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    active = active.contiguous()
    B, C, D = w.shape
    if C < 2:   # the top-2 needs two slots; the pad is inactive
        w = torch.cat([w, w.new_zeros((B, 2 - C, D))], dim=1)
        active = torch.cat([active, active.new_zeros((B, 2 - C))], dim=1)
    out_d, out_i = find_winners_top2(signals, w, active)
    invalid2 = out_d[..., 1] >= LARGE / 2
    out_i = torch.stack(
        [out_i[..., 0], torch.where(invalid2, out_i[..., 0], out_i[..., 1])],
        -1)
    out_d = torch.stack(
        [out_d[..., 0], torch.where(invalid2, out_d[..., 0], out_d[..., 1])],
        -1)
    return out_d, out_i


@batchable(3)
def cuda_find_winners(signals: torch.Tensor, w: torch.Tensor,
                      active: torch.Tensor):
    """The engine's ``FindWinnersFn`` through the kernel: (winner_ids,
    second_ids, d2_winner, d2_second), each (B, m)."""
    d2, ids = find_winners_op(signals, w, active)
    return ids[..., 0], ids[..., 1], d2[..., 0], d2[..., 1]
