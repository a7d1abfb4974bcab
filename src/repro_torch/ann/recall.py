"""The birthday-collision recall model (after ``jax.experimental.ann``).

The port's copy of ``repro.ann.recall``: pure Python, kept here so the
port imports nothing of the JAX package.

Model the two-stage search as throwing the true top-k elements into L
shortlist slots uniformly at random; an element is *lost* when it
collides with a better one in the same slot. For top-k over L
per-window winners the expected recall is

    recall ~= exp((1 - k) / L)

(arXiv:2206.14286 Sec. 4). Inverting for the window count at a target
recall r gives

    L = ceil((k - 1) / -ln(r))

For the paper's top-2 search (k = 2) and r = 0.95 this is L = 20: the
winner is always found (it wins its own window); the *second* winner is
lost only when it shares the winner's window, probability ~1/L.

The same budget is reused as a heuristic shortlist size for the grid
quantizer's per-cell candidate cap; the closed-form model strictly
applies to the uniform windowed partition only.
"""
from __future__ import annotations

import math


def shortlist_size(recall_target: float, k: int = 2) -> int:
    """Shortlist slots L needed for an expected top-``k`` recall of
    ``recall_target`` under the birthday-collision model."""
    if not 0.0 < recall_target < 1.0:
        raise ValueError(
            f"recall_target must be in (0, 1), got {recall_target} "
            "(1.0 means exact search — use the reference backend)")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k == 1:
        return 1
    return max(k, math.ceil((k - 1) / -math.log(recall_target)))


def expected_recall(n_slots: int, k: int = 2) -> float:
    """Expected top-``k`` recall of an ``n_slots``-slot shortlist."""
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    return math.exp((1 - k) / n_slots)
