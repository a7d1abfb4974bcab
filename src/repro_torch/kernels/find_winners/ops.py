"""Public wrapper for the Find Winners kernel (paper Sec. 2.5): padding of
a pool smaller than two units, the degenerate second slot, and the
engine-facing ``FindWinnersFn``."""
from __future__ import annotations

import torch

from repro_torch.kernels.find_winners.kernel import LARGE, find_winners_top2


def find_winners_op(signals: torch.Tensor, w: torch.Tensor,
                    active: torch.Tensor):
    """Top-2 nearest active units for each signal, via the kernel.

    signals (m, d), w (C, d), active (C,) bool -> (top2_d2 (m, 2) f32,
    top2_ids (m, 2) i32). With fewer than 2 active units the winner is
    duplicated into the second slot instead of reporting an inactive
    unit.
    """
    signals = signals.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    active = active.contiguous()
    if w.shape[0] < 2:   # the top-2 needs two slots; the pad is inactive
        pad = 2 - w.shape[0]
        w = torch.cat([w, w.new_zeros((pad, w.shape[1]))])
        active = torch.cat([active, active.new_zeros((pad,))])
    out_d, out_i = find_winners_top2(signals[None], w[None], active[None])
    out_d, out_i = out_d[0], out_i[0]
    invalid2 = out_d[:, 1] >= LARGE / 2
    out_i = torch.stack(
        [out_i[:, 0], torch.where(invalid2, out_i[:, 0], out_i[:, 1])], 1)
    out_d = torch.stack(
        [out_d[:, 0], torch.where(invalid2, out_d[:, 0], out_d[:, 1])], 1)
    return out_d, out_i


def cuda_find_winners(signals: torch.Tensor, w: torch.Tensor,
                      active: torch.Tensor):
    """The engine's ``FindWinnersFn`` through the kernel: (winner_ids,
    second_ids, d2_winner, d2_second)."""
    d2, ids = find_winners_op(signals, w, active)
    return ids[:, 0], ids[:, 1], d2[:, 0], d2[:, 1]
