"""Plain oracle for the find_winners kernel.

Computes distances the direct way (sum of squared differences) rather
than the kernel's quadratic expansion, so the two are numerically
independent witnesses. O(m C d) memory: for tests at small sizes.
"""
from __future__ import annotations

import torch


def find_winners_ref(signals: torch.Tensor, w: torch.Tensor,
                     active: torch.Tensor):
    """Returns (top2_d2 (m, 2) f32, top2_ids (m, 2) i32). Ties -> lowest id.

    With fewer than 2 active units the winner occupies both slots."""
    diff = signals[:, None, :] - w[None, :, :]                 # (m, C, d)
    d2 = (diff * diff).sum(dim=-1)
    d2 = torch.where(active[None, :], d2, 1e30)
    if d2.shape[1] < 2:
        d2 = torch.cat([d2, d2.new_full((d2.shape[0], 1), 1e30)], dim=1)
    order = torch.sort(d2, dim=1, stable=True)
    vals, idx = order.values[:, :2], order.indices[:, :2].to(torch.int32)
    second_invalid = vals[:, 1] >= 1e30
    idx = torch.stack(
        [idx[:, 0], torch.where(second_invalid, idx[:, 0], idx[:, 1])], 1)
    vals = torch.stack(
        [vals[:, 0], torch.where(second_invalid, vals[:, 0], vals[:, 1])], 1)
    return vals, idx
