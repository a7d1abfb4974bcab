"""repro_torch.ann: recall-tunable approximate Find Winners.

The port's ``repro.ann``. The paper's Find Winners phase is an exact
top-2 over the full ``(m, capacity)`` distance matrix. This package
provides two sub-linear replacements that plug into the same
``FindWinnersFn`` slot every exact backend uses, batched on a leading
network axis like the rest of the port:

  * :class:`~repro_torch.ann.windowed.WindowedFindWinners`
    (``ann-windowed``) — the windowed top-k of ``jax.experimental.ann``:
    L interleaved windows of the capacity axis, per-window top-1, then
    the exact top-2 rerank over the L champions. L is derived from a
    ``recall_target`` by the birthday-collision model
    (:mod:`repro_torch.ann.recall`).
  * :class:`~repro_torch.ann.grid.GridFindWinners` (``ann-grid`` /
    ``indexed``) — the paper's hash-grid coarse quantizer (Sec. 3.1):
    bucket units into a uniform grid, shortlist the signal's 3^d-cell
    stencil, exact-rerank the shortlist. The grid is an explicit aux
    rebuilt on the topology-refresh cadence (the stateful-backend
    protocol below).

Both are accepted on topology quality (Euler characteristic equal to the
exact backend's, quantization error within tolerance:
``repro_torch.core.gson.metrics.topology_quality``), not on bitwise
parity; the exact rerank (:func:`repro_torch.ann.rerank.exact_top2`)
shares the reference's tie-break contract bitwise. Everything here is
plain PyTorch, as it is jnp (no Pallas kernel) in the JAX package.

Stateful backend protocol
-------------------------
A backend with a precomputed search structure declares ``stateful =
True`` and provides ``build(w, active) -> aux`` (a NamedTuple whose
tensors carry the network axis) plus ``__call__(signals, w, active,
aux=None)``. Call sites that carry no aux pass nothing and the backend
rebuilds, which is always correct. The fleet superstep carries the aux
and rebuilds it on the ``refresh_every`` cadence
(``core/gson/fleet.py``), and ``indexed_scan`` every ``rebuild_every``
signals.
"""
from __future__ import annotations

from repro_torch.ann.grid import (GridAux, GridFindWinners, build_grid,
                                  cell_ids, grid_find_winners, grid_search,
                                  indexed_find_winners, indexed_scan)
from repro_torch.ann.recall import expected_recall, shortlist_size
from repro_torch.ann.rerank import exact_top2
from repro_torch.ann.windowed import (WindowedFindWinners,
                                      windowed_find_winners)

__all__ = [
    "GridAux",
    "GridFindWinners",
    "WindowedFindWinners",
    "build_grid",
    "cell_ids",
    "exact_top2",
    "expected_recall",
    "grid_find_winners",
    "grid_search",
    "indexed_find_winners",
    "indexed_scan",
    "shortlist_size",
    "windowed_find_winners",
]
