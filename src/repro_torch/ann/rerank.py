"""Exact top-2 rerank over a shortlisted candidate set.

The port's ``repro.ann.rerank``: the second stage shared by every
approximate backend, with the engine's tie-break contract — that of
``multi.find_winners_reference`` and the Find Winners kernel:

  * ties break to the LOWEST unit id among the minima;
  * the second pass excludes every slot carrying the winner's id (the
    shortlist may contain duplicates: stencil cells overlap anchors);
  * invalid slots carry ``inf`` distance;
  * degenerate rows (< 2 finite candidates) duplicate the winner into
    the second slot, like the reference;
  * distances are clamped at 0.

The same min / compare / select passes as the JAX function, so on the
same inputs the output is bitwise the JAX package's.
"""
from __future__ import annotations

import torch

BIG_ID = 2 ** 30   # sentinel above any unit id (as in the kernel)


def exact_top2(d2: torch.Tensor, ids: torch.Tensor):
    """Exact top-2 over the last axis of a candidate set.

    ``d2``: (..., S) f32 squared distances, ``inf`` on invalid slots.
    ``ids``: (..., S) int unit ids (duplicates allowed; invalid slots may
    carry :data:`BIG_ID`). Leading axes are free: (m, S) for one network,
    (B, m, S) for a fleet.

    Returns ``(winner_ids, second_ids, d2_winner, d2_second)`` in the
    ``FindWinnersFn`` result form, each (...,): int32 ids, distances
    clamped at 0, degenerate rows duplicating the winner.
    """
    ids = ids.to(torch.int32)
    m1 = d2.amin(dim=-1)
    is1 = d2 <= m1[..., None]
    i1 = torch.where(is1, ids, BIG_ID).amin(dim=-1)
    masked = torch.where(ids == i1[..., None], torch.inf, d2)
    m2 = masked.amin(dim=-1)
    is2 = masked <= m2[..., None]
    i2 = torch.where(is2, ids, BIG_ID).amin(dim=-1)
    # degenerate (< 2 finite candidates): duplicate the winner, like the
    # reference's < 2 active units case
    invalid = ~torch.isfinite(m2)
    i2 = torch.where(invalid, i1, i2)
    m2 = torch.where(invalid, m1, m2)
    return i1, i2, m1.clamp(min=0.0), m2.clamp(min=0.0)
