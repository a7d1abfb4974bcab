"""Windowed approximate top-2 (the ``ann-windowed`` backend).

The port's ``repro.ann.windowed``: the two-stage search of
``jax.experimental.ann`` (arXiv:2206.14286), specialized to the engine's
top-2 contract:

  stage 1  partition the capacity axis into L windows and take the
           top-1 of each — the distance matrix comes from the same
           quadratic-expansion product the reference uses, and the
           per-window reduction is one min / argmin pass;
  stage 2  exact top-2 rerank (:func:`repro_torch.ann.rerank.exact_top2`)
           over the L per-window champions.

Windows are *interleaved* (unit i -> window ``i % L``) rather than
contiguous: growing networks allocate correlated ids for spatially nearby
units, and the second winner is lost exactly when it shares the winner's
window, so striding decorrelates ids from space.

The winner itself is always exact (it wins its own window), so the only
fallible output is the *second*. The default ``refine=True`` re-reads the
winner's window exactly and merges its runner-up into the rerank set;
any true second outside that window is already another window's
champion, so the refined set contains the true top-2 and the search is
exact. ``refine=False`` exposes the pure birthday-collision regime
(recall ~ exp(-1/L)).

With ``n_windows >= capacity`` every window holds one unit and the search
is the reference, bitwise, tie-breaks included.

Stage 1 is plain PyTorch, as it is jnp (not Pallas) in the JAX package:
``torch.bmm`` exactly as ``multi.find_winners_reference`` computes it.
Its ids are exact only if that product is true float32, so on the card a
call raises while TensorFloat-32 is allowed for matrix products
(``torch.backends.cuda.matmul.allow_tf32`` or a float32 matmul precision
other than ``"highest"``) instead of returning other winners.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.ann.recall import shortlist_size
from repro_torch.ann.rerank import BIG_ID, exact_top2
from repro_torch.core.gson.batch import batchable


def require_f32_matmul(x: torch.Tensor) -> None:
    """Raise if a matrix product on ``x``'s device may round through
    TensorFloat-32 (CUDA only: the CPU has no TF32)."""
    if x.device.type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the approximate Find Winners backends need float32 matrix "
            "products, but TensorFloat-32 is allowed "
            "(torch.backends.cuda.matmul.allow_tf32 = True or "
            "torch.set_float32_matmul_precision != 'highest'), which "
            "changes which unit is nearest; turn it off for this run")


def _distances(signals, w, active):
    """(B, m, C) squared distances, the reference's expansion, ``inf`` on
    inactive units."""
    require_f32_matmul(signals)
    x2 = (signals * signals).sum(dim=-1, keepdim=True)
    w2 = (w * w).sum(dim=-1)
    d2 = (x2 - torch.bmm(2.0 * signals, w.transpose(1, 2))
          + w2[:, None, :])
    return torch.where(active[:, None, :], d2, torch.inf)


@dataclass(frozen=True)
class WindowedFindWinners:
    """A batched ``FindWinnersFn``: windowed top-1 -> exact top-2 rerank.

    Frozen and hashable, so cohorts group on it like on every other
    backend. ``recall_target`` is carried for reporting; ``n_windows`` is
    the knob the search uses.
    """

    n_windows: int
    recall_target: float | None = None
    refine: bool = True            # winner-window runner-up merge

    def __post_init__(self):
        if self.n_windows < 2:
            raise ValueError(
                f"n_windows must be >= 2 for a top-2 search, got "
                f"{self.n_windows}")

    def __call__(self, signals: torch.Tensor, w: torch.Tensor,
                 active: torch.Tensor):
        return windowed_search(signals, w, active, self.n_windows,
                               self.refine)


@batchable(3)
def windowed_search(signals, w, active, n_windows: int, refine: bool = True):
    """The windowed search over (B, m, d) signals and (B, C, d) pools:
    ``FindWinnersFn`` results, each (B, m)."""
    B, m = signals.shape[:2]
    C = w.shape[1]
    L = min(n_windows, C)
    rows = -(-C // L)                       # units per window (ceil)
    d2 = _distances(signals, w, active)
    pad = rows * L - C
    if pad:
        d2 = torch.cat([d2, d2.new_full((B, m, pad), torch.inf)], -1)
    # column j*L + l lands in window l at row j: the interleaved
    # assignment (unit id stride L within a window)
    d2w = d2.view(B, m, rows, L)
    vals = d2w.amin(dim=2)                                   # (B, m, L)
    # argmin returns the FIRST minimum; rows go by ascending id within a
    # window, so ties break to the lowest id
    row = d2w.argmin(dim=2).to(torch.int32)
    lanes = torch.arange(L, dtype=torch.int32, device=w.device)
    ids = row * L + lanes
    if not refine:
        return exact_top2(vals, ids)
    # refinement: re-read the winner's window exactly and merge its
    # runner-up; the merged set then contains the true top-2
    wid = exact_top2(vals, ids)[0]
    lstar = (wid % L).long()                                 # (B, m)
    col = torch.gather(
        d2w, 3, lstar[..., None, None].expand(B, m, rows, 1))[..., 0]
    col_ids = (torch.arange(rows, dtype=torch.int32, device=w.device) * L
               + lstar[..., None].to(torch.int32))           # (B, m, rows)
    col = torch.where(col_ids == wid[..., None], torch.inf, col)
    r2 = col.amin(dim=-1)
    r2_id = torch.where(col <= r2[..., None], col_ids, BIG_ID).amin(dim=-1)
    return exact_top2(torch.cat([vals, r2[..., None]], -1),
                      torch.cat([ids, r2_id[..., None]], -1))


def windowed_find_winners(recall_target: float = 0.95
                          ) -> WindowedFindWinners:
    """The backend for a recall target: the window count is the
    birthday-model shortlist size for top-2 at that recall."""
    return WindowedFindWinners(
        n_windows=shortlist_size(recall_target, k=2),
        recall_target=recall_target)
