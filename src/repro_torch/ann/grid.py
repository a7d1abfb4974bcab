"""Hash-grid coarse quantizer (the ``ann-grid`` / ``indexed`` backends).

The port's ``repro.ann.grid``: the paper's *Indexed* search (Sec. 3.1,
after Hockney & Eastwood) as a two-stage backend. A uniform grid of
cubes quantizes the units (a stable sort by cell id -> CSR buckets);
each signal shortlists its cell's 3^d stencil and the exact top-2 rerank
(:func:`repro_torch.ann.rerank.exact_top2`) runs over the shortlist. It
is "slightly approximate": the nearest unit can live outside the stencil
when cells are small relative to the unit spacing.

Three fallback disciplines for signals the stencil cannot cover:

  * ``"guard"`` (the ``ann-grid`` backend) — the coverage radius test:
    any unit within one cell width of a signal lies in its stencil, so
    when the shortlist's second distance is below ``cell`` (and distinct
    from the winner) the answer is exact. Where any signal of a network
    fails the test, that network takes the exhaustive reference search.
    The JAX package decides per network with a ``lax.cond`` under the
    fleet's ``vmap``; here the host reads the batch's B pass flags in one
    sync: when every network passes, the grid result is returned and the
    reference is not run; otherwise the reference runs once for the
    batch and each network takes the result its flag selects. The
    re-search is the algorithm, exact by construction, and counted:
    ``guarded_search.calls`` and ``guarded_search.fires`` (calls in
    which some network took the reference).
  * ``"anchors"`` — the first ``n_anchors`` cell-sorted units are
    appended to every shortlist. Branchless, no fallback: the pure
    approximate regime.
  * ``"exact"`` (the ``indexed`` baseline) — the paper's discipline: a
    signal whose stencil yields < 2 candidates takes the exhaustive
    search. The JAX package's per-signal ``lax.cond`` under ``vmap`` is a
    select, and so it is here: both results, then ``torch.where`` per
    signal.

The grid is the package's *stateful* backend: ``build`` returns a
:class:`GridAux` that loop drivers carry and rebuild on the
topology-refresh cadence; calling with ``aux=None`` rebuilds in place,
which is always correct. Every function takes a leading network axis B
(``core/gson/batch.py``); called without it, a fleet of one.
"""
from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.ann.recall import shortlist_size
from repro_torch.ann.rerank import BIG_ID, exact_top2
from repro_torch.ann.windowed import require_f32_matmul
from repro_torch.core.gson.batch import batchable, take
from repro_torch.core.gson.multi import (find_winners_reference,
                                         multi_signal_step, refresh_topology)
from repro_torch.core.gson.state import GSONParams, NetworkState


class GridAux(NamedTuple):
    """The quantizer state of each network: CSR buckets of unit ids,
    sorted by cell."""

    origin: torch.Tensor        # (B, dim) f32 grid origin (bbox min)
    cell: torch.Tensor          # (B,) f32 cube edge length
    sorted_units: torch.Tensor  # (B, capacity) i32 unit ids by cell id
    cell_start: torch.Tensor    # (B, n_cells + 1) i32 CSR offsets
    dims: tuple                 # (g,) * dim, static


def _strides(dims: tuple) -> tuple:
    """Row-major flat-index strides for a ``dims`` grid."""
    out, acc = [], 1
    for g in reversed(dims):
        out.append(acc)
        acc *= g
    return tuple(reversed(out))


def cell_ids(points: torch.Tensor, origin: torch.Tensor, cell: torch.Tensor,
             dims: tuple) -> torch.Tensor:
    """(B, n, dim) points -> (B, n) int32 flat cell ids, clipped into the
    grid (the clip comes before the integer conversion, which is then
    exact, as XLA's saturating one is)."""
    dev = points.device
    ijk = torch.floor((points - origin[:, None, :]) / cell[:, None, None])
    hi = torch.tensor([g - 1 for g in dims], dtype=torch.float32, device=dev)
    ijk = torch.minimum(ijk.clamp(min=0.0), hi).to(torch.int32)
    strides = torch.tensor(_strides(dims), dtype=torch.int32, device=dev)
    return (ijk * strides).sum(dim=-1, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _stencil(dims: tuple) -> tuple:
    strides = _strides(dims)
    return tuple(sum(o * s for o, s in zip(combo, strides))
                 for combo in itertools.product((-1, 0, 1),
                                                repeat=len(dims)))


def _stencil_offsets(dims: tuple, device="cpu") -> torch.Tensor:
    """(3^d,) int32 flat-id offsets of the cell-plus-neighbors stencil."""
    return torch.tensor(_stencil(dims), dtype=torch.int32, device=device)


@batchable(3)
def build_grid(w: torch.Tensor, active: torch.Tensor, dims: tuple,
               bbox: tuple | None = None) -> GridAux:
    """Quantize each network's pool: stable sort by cell id -> CSR buckets.

    ``bbox = ((lo,)*dim, (hi,)*dim)`` fixes the grid frame; ``None``
    derives it from each network's active units. Inactive units sort
    past the last cell and never enter a bucket; an empty pool gives
    empty buckets.
    """
    B, C, d = w.shape
    dev = w.device
    if bbox is not None:
        lo = torch.tensor(bbox[0], dtype=torch.float32,
                          device=dev).expand(B, d)
        hi = torch.tensor(bbox[1], dtype=torch.float32,
                          device=dev).expand(B, d)
    else:
        any_active = active.any(dim=-1)[:, None]
        col = active[..., None]
        lo = torch.where(any_active,
                         torch.where(col, w, torch.inf).amin(dim=1), 0.0)
        hi = torch.where(any_active,
                         torch.where(col, w, -torch.inf).amax(dim=1), 1.0)
    extent = (hi - lo).amax(dim=-1).clamp(min=1e-6)
    cell = extent / dims[0] + 1e-6
    n_cells = math.prod(dims)
    cid = torch.where(active, cell_ids(w, lo, cell, dims), n_cells)
    order = torch.argsort(cid, dim=-1, stable=True)
    sorted_cid = torch.gather(cid, 1, order)
    bounds = torch.arange(n_cells + 1, dtype=torch.int32,
                          device=dev).expand(B, -1).contiguous()
    starts = torch.searchsorted(sorted_cid, bounds, out_int32=True)
    return GridAux(origin=lo.contiguous(), cell=cell,
                   sorted_units=order.to(torch.int32), cell_start=starts,
                   dims=tuple(dims))


@batchable(3, arg=1)
def grid_search(aux: GridAux, signals: torch.Tensor, w: torch.Tensor,
                active: torch.Tensor, *, per_cell_cap: int,
                n_anchors: int = 0):
    """Stencil shortlist + exact rerank for every signal of every network
    (no data-dependent branch). Returns the ``FindWinnersFn`` 4-tuple."""
    B, m = signals.shape[:2]
    C = w.shape[1]
    n_cells = math.prod(aux.dims)
    offs = _stencil_offsets(aux.dims, signals.device)          # (S,)
    sig_cell = cell_ids(signals, aux.origin, aux.cell, aux.dims)
    cells = (sig_cell[..., None] + offs).clamp(0, n_cells - 1).long()
    flat = cells.view(B, -1)
    start = torch.gather(aux.cell_start, 1, flat).view(cells.shape)
    count = torch.gather(aux.cell_start, 1, flat + 1).view(cells.shape) - start
    take_n = count.clamp(max=per_cell_cap)
    slots = torch.arange(per_cell_cap, dtype=torch.int32,
                         device=signals.device)
    pos = start[..., None] + slots                         # (B, m, S, cap)
    valid = slots < take_n[..., None]
    units = torch.gather(aux.sorted_units, 1,
                         pos.clamp(0, C - 1).view(B, -1).long())
    cand = torch.where(valid, units.view(pos.shape), -1).view(B, m, -1)
    if n_anchors:
        # the first n_anchors cell-sorted entries are active units spread
        # across occupied cells (inactive sort past them); surplus slots
        # alias units already present, which the duplicate-aware rerank
        # absorbs
        anchors = aux.sorted_units[:, :n_anchors]
        cand = torch.cat([cand, anchors[:, None, :].expand(
            B, m, anchors.shape[-1])], dim=-1)
    safe = cand.clamp(0, C - 1).long()
    diff = signals[:, :, None, :] - take(w, safe)
    sq = diff * diff
    d2 = sq[..., 0]
    for k in range(1, sq.shape[-1]):    # the sum over dims, left to right
        d2 = d2 + sq[..., k]
    d2 = torch.where((cand >= 0) & take(active, safe), d2, torch.inf)
    ids = torch.where(cand >= 0, cand, BIG_ID)
    return exact_top2(d2, ids)


def guarded_search(aux: GridAux, signals: torch.Tensor, w: torch.Tensor,
                   active: torch.Tensor, *, per_cell_cap: int,
                   n_anchors: int):
    """The radius-guarded search over a batch (B, ...): the shortlist's
    answer for each network whose every signal passes the guard, the
    exhaustive reference for the others. One host read of the B flags; the
    reference runs only when some network fails. The guard matters: SOAM
    freezes a spurious winner-second edge for good, so an unguarded
    error rate poisons the topology."""
    out = grid_search(aux, signals, w, active, per_cell_cap=per_cell_cap,
                      n_anchors=n_anchors)
    wid, sid, _, ds = out
    cell2 = aux.cell * aux.cell
    ok = ((sid != wid) & (ds < cell2[:, None])).all(dim=-1)     # (B,)
    guarded_search.calls += 1
    if bool(ok.all()):
        return out
    guarded_search.fires += 1
    require_f32_matmul(signals)
    ref = find_winners_reference(signals, w, active)
    keep = ok[:, None]
    return tuple(torch.where(keep, g, r) for g, r in zip(out, ref))


guarded_search.calls = 0
guarded_search.fires = 0


def exact_fallback_search(aux: GridAux, signals: torch.Tensor,
                          w: torch.Tensor, active: torch.Tensor, *,
                          per_cell_cap: int):
    """The paper's discipline over a batch (B, ...): a signal whose stencil
    yields < 2 distinct candidates (the rerank duplicated the winner, or
    returned the sentinel of an empty shortlist) takes the exhaustive
    search; a per-signal select of both results."""
    out = grid_search(aux, signals, w, active, per_cell_cap=per_cell_cap,
                      n_anchors=0)
    wid, sid = out[:2]
    short_ok = (wid < w.shape[1]) & (sid != wid)
    require_f32_matmul(signals)
    ref = find_winners_reference(signals, w, active)
    return tuple(torch.where(short_ok, g, r) for g, r in zip(out, ref))


@dataclass(frozen=True)
class GridFindWinners:
    """A stateful ``FindWinnersFn``: hash-grid quantizer -> shortlist ->
    exact rerank.

    Frozen and hashable, so cohorts group on it like on every backend.
    ``stateful`` marks the aux protocol for loop drivers: ``build``
    produces the :class:`GridAux`, ``__call__`` takes it as ``aux=`` (or
    rebuilds when ``None``).

    ``grid_per_axis=None`` derives the resolution from the pool capacity,
    targeting ~16 expected units inside the coverage disk of radius
    ``cell`` for 2-manifold data at full occupancy: ``g ~ sqrt(capacity /
    16)``, clipped to [4, 128].
    """

    grid_per_axis: int | None = None
    per_cell_cap: int = 24
    n_anchors: int = 64
    bbox: tuple | None = None      # ((lo,)*dim, (hi,)*dim) | None=derive
    fallback: str = "guard"        # "guard" | "anchors" | "exact"
    recall_target: float | None = None

    stateful = True                # class attribute, not a field

    def __post_init__(self):
        if self.fallback not in ("guard", "anchors", "exact"):
            raise ValueError(
                f"fallback must be 'guard', 'anchors' or 'exact', got "
                f"{self.fallback!r}")
        if self.per_cell_cap < 1:
            raise ValueError(
                f"per_cell_cap must be >= 1, got {self.per_cell_cap}")

    def dims_for(self, capacity: int) -> tuple:
        if self.grid_per_axis is not None:
            g = self.grid_per_axis
        else:
            g = max(4, min(128, round(math.sqrt(capacity / 16.0))))
        return (g,) * 3

    def build(self, w: torch.Tensor, active: torch.Tensor) -> GridAux:
        return build_grid(w, active, self.dims_for(w.shape[-2]),
                          bbox=self.bbox)

    def __call__(self, signals: torch.Tensor, w: torch.Tensor,
                 active: torch.Tensor, aux: GridAux | None = None):
        return _grid_find(self, signals, w, active, aux)


@batchable(3, arg=1)
def _grid_find(fw: GridFindWinners, signals, w, active, aux):
    if aux is None:
        aux = fw.build(w, active)
    if fw.fallback == "anchors":
        return grid_search(aux, signals, w, active,
                           per_cell_cap=fw.per_cell_cap,
                           n_anchors=fw.n_anchors)
    if fw.fallback == "guard":
        return guarded_search(aux, signals, w, active,
                              per_cell_cap=fw.per_cell_cap,
                              n_anchors=fw.n_anchors)
    return exact_fallback_search(aux, signals, w, active,
                                 per_cell_cap=fw.per_cell_cap)


def grid_find_winners(recall_target: float = 0.95,
                      grid_per_axis: int | None = None,
                      n_anchors: int = 64) -> GridFindWinners:
    """The ``ann-grid`` backend for a recall target: the per-cell
    candidate cap reuses the birthday shortlist budget, floored at 24 so
    the radius guard's coverage argument is not undercut by bucket
    overflow, and capped at 64."""
    return GridFindWinners(
        grid_per_axis=grid_per_axis,
        per_cell_cap=max(24, min(64, shortlist_size(recall_target, k=2))),
        n_anchors=n_anchors,
        fallback="guard",
        recall_target=recall_target)


def indexed_find_winners(grid_per_axis: int = 24,
                         per_cell_cap: int = 24,
                         bbox: tuple | None = None) -> GridFindWinners:
    """The paper's *Indexed* baseline: a fixed grid resolution and the
    per-signal exhaustive fallback."""
    return GridFindWinners(
        grid_per_axis=grid_per_axis, per_cell_cap=per_cell_cap,
        n_anchors=0, bbox=bbox, fallback="exact")


@batchable(3)
def indexed_scan(state: NetworkState, signals: torch.Tensor,
                 params: GSONParams, fw: GridFindWinners,
                 rebuild_every: int = 64,
                 refresh_every: int = 50) -> NetworkState:
    """Process ``signals`` (B, n, dim) one at a time with the grid aux
    carried (the ``indexed`` variant's chunk): built at the start of the
    chunk and rebuilt after signal i where ``(i + 1) % rebuild_every ==
    0``; SOAM refreshes where ``(i + 1) % refresh_every == 0``, both
    counters restarting with every chunk, as the JAX scan's do. The
    Update phase is the reference's; the lone signal of a step always
    survives the lock, so its priority is 0."""
    B, n = signals.shape[:2]
    prio = torch.zeros((B, 1), dtype=torch.int32, device=signals.device)
    is_soam = params.model == "soam"
    aux = fw.build(state.w, state.active)
    for i in range(n):
        state = multi_signal_step(state, signals[:, i:i + 1], params, prio,
                                  refresh_states=False, find_winners=fw,
                                  fw_aux=aux)
        if is_soam and (i + 1) % refresh_every == 0:
            state = refresh_topology(state, params)
        if (i + 1) % rebuild_every == 0:
            aux = fw.build(state.w, state.active)
    return state
