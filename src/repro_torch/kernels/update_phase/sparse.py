"""Sparse winner-neighborhood Update phase: the kernels on a gathered slab.

The port's counterpart of ``repro.kernels.update_phase.sparse``. One
multi-signal iteration only writes the units its batch touches: the
winners, the seconds and the winners' neighbor rows (edge symmetry makes
the mirror-aging targets exactly the winners' neighbors). On a compact
pool (the allocator fills free slots lowest id first) those ids cluster
in a few tiles of ``SLAB_TILE`` units. This module gathers the touched
tiles into a contiguous slab, runs the UNCHANGED kernels of
``kernels/update_phase`` (the lock B2 and the fused accumulators with
edge aging B3 + B4) at slab capacity, and sets the slab's rows back into
the pool.

The tile is the JAX slab's Pallas ``block_c`` (256). The port's kernels
have no tile of their own; it stays the slab's gather unit, so the slab
budget (:func:`default_slab_tiles`), the touched-tile set and the branch
taken are the JAX package's.

The slab budget must be fixed before the batch is seen, so the
touched-tile count is checked at run time: the host reads the batch's
``n_touched <= G`` flags in one sync and takes the slab for the whole
batch only when every network passes, else the dense
``update_phase_op``. Both branches are exact, so a choice per batch
gives the state that the JAX package's choice per network (``lax.cond``
under ``vmap``) gives. When the slab would be the whole pool (``G >=
n_tiles``) the dense path runs with no check. Each branch counts its
calls (``update_phase_sparse.slab_calls`` / ``.dense_calls`` /
``.pool_calls``), so a run can show which one ran.

Slab-local neighbor ids. The fused accumulator launch reads neighbor ids
from the ``nbr`` table it is given and relies on symmetric edges, so the
slab's ``nbr`` holds slab-local ids, with off-slab neighbors set to -1.
That is exact: every winner, every second and every neighbor of a winner
lies in the slab, so an off-slab neighbor belongs to the row of a
non-winner and is itself a non-winner; its slot ages by 0, gets no
neighbor pull and is no winner-second slot, whether it is valid or not.
Every edge with a winner at either end keeps both of its halves.

Numerics are those of ``update_phase_op``: the slab runs the same kernels
on the same values in the same slot order, only at other unit ids, so on
the card its result equals the dense path's bitwise, and on the CPU the
plain versions add in the same order.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson.batch import batchable, put, take
from repro_torch.core.gson.multi import (UpdateOut, stable_units,
                                         update_phase_inputs)
from repro_torch.core.gson.state import GSONParams, NetworkState
from repro_torch.kernels.update_phase.kernel import (BIG_PRIO, update_accum,
                                                     winner_lock_min)
from repro_torch.kernels.update_phase.ops import update_phase_op

SLAB_TILE = 256


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def default_slab_tiles(m: int, tile: int, n_tiles: int) -> int:
    """Slab budget: ``min(n_tiles, ceil(2m / tile))`` tiles, at least 1.

    Winners and seconds are at most 2m distinct ids; on a compact pool
    the winners' neighbor rows share their tiles. The budget does not
    depend on the capacity, and it is not the worst case for neighbors
    (a fragmented pool can exceed it): the run-time check falls back to
    the dense path then.
    """
    return max(1, min(n_tiles, -(-2 * m // tile)))


def slab_shape(capacity: int, m: int, tile: int = SLAB_TILE,
               slab_tiles: int | None = None) -> tuple[int, int, int]:
    """``(tile, n_tiles, G)`` of the slab at a pool of ``capacity`` units
    and m signals: the tile (at most the pool rounded up to 128), the
    pool's tiles and the slab's budget (``slab_tiles``, or
    :func:`default_slab_tiles`, at most ``n_tiles``). The slab engages
    only where ``G < n_tiles``; otherwise it is the dense path."""
    tile = min(tile, _round_up(capacity, 128))
    n_tiles = _round_up(capacity, tile) // tile
    G = (default_slab_tiles(m, tile, n_tiles) if slab_tiles is None
         else max(1, min(slab_tiles, n_tiles)))
    return tile, n_tiles, G


def _pad_rows(x: torch.Tensor, rows: int, value) -> torch.Tensor:
    """x (B, C, ...) with ``value`` rows appended up to ``rows`` (x itself
    when it has them)."""
    C = x.shape[1]
    if rows == C:
        return x
    return torch.cat([x, x.new_full((x.shape[0], rows - C, *x.shape[2:]),
                                    value)], dim=1)


@batchable(3)
def update_phase_sparse(
    state: NetworkState,
    signals: torch.Tensor,
    wid: torch.Tensor,
    sid: torch.Tensor,
    d2b: torch.Tensor,
    prio: torch.Tensor,
    params: GSONParams,
    signal_mask: torch.Tensor | None = None,
    *,
    tile: int = SLAB_TILE,
    slab_tiles: int | None = None,
) -> UpdateOut:
    """The dense Update phase on a gathered winner-neighborhood slab, for
    every network of a fleet.

    Same ``UpdatePhaseFn`` contract as ``ops.update_phase_op``.
    ``slab_tiles`` caps the slab in ``tile``-unit tiles (``None``:
    :func:`default_slab_tiles`). A batch in which some network touches
    more tiles than the slab holds takes the dense path.
    """
    if params.neighbor_collision != "sum":
        raise NotImplementedError(
            "the sparse update-phase kernel implements the deterministic "
            '"sum" neighbor-collision mode only; use the reference '
            'backend to study neighbor_collision="last"')
    C = state.capacity
    B, m = signals.shape[:2]
    tile, n_tiles, G = slab_shape(C, m, tile, slab_tiles)
    cp = n_tiles * tile
    dense = (state, signals, wid, sid, d2b, prio, params, signal_mask)
    if G >= n_tiles:
        # the slab would be the whole pool: the dense path is the slab
        update_phase_sparse.pool_calls += 1
        return update_phase_op(*dense)

    # ---- touched tiles: winners, seconds, winners' neighbors ---------------
    # (before the lock, so every signal's rows count: a superset of the
    # rows any output can differ on)
    dev = signals.device
    wc = wid.clamp(0, C - 1).long()
    nb_w = take(state.nbr, wc)                                  # (B, m, K)
    touched_ids = torch.cat([wc, sid.clamp(0, C - 1).long(),
                             nb_w.clamp(min=0).flatten(1).long()], dim=1)
    touched = torch.zeros((B, n_tiles), dtype=torch.bool, device=dev)
    touched.scatter_(1, touched_ids // tile, True)
    if not bool((touched.sum(dim=1) <= G).all()):   # the one host sync
        update_phase_sparse.dense_calls += 1
        return update_phase_op(*dense)
    update_phase_sparse.slab_calls += 1

    # touched tiles first (ascending id), untouched filler after: the
    # filler rows round the slab to its size and are updated as identity
    tile_ids = torch.arange(n_tiles, device=dev)
    tiles = torch.where(touched, tile_ids, tile_ids + n_tiles).argsort(
        dim=1)[:, :G]                                           # (B, G)
    rows = (tiles[..., None] * tile
            + torch.arange(tile, device=dev)).flatten(1)        # (B, Gs)
    Gs = G * tile
    # slab-local id of each pool unit, -1 off the slab
    slab_of = torch.full((B, cp), -1, dtype=torch.int32, device=dev)
    slab_of.scatter_(1, rows, torch.arange(
        Gs, dtype=torch.int32, device=dev).expand(B, Gs))

    def remap(ids: torch.Tensor) -> torch.Tensor:
        """Pool ids -> slab-local ids; -1 for negative ids and off-slab
        units."""
        return torch.where(ids >= 0, take(slab_of, ids.clamp(min=0).long()),
                           -1)

    # ---- B2: the winner lock at slab capacity ------------------------------
    wid_s = remap(wid).contiguous()
    mask = (torch.ones((B, m), dtype=torch.bool, device=dev)
            if signal_mask is None else signal_mask)
    prio_masked = torch.where(mask, prio.to(torch.int32), BIG_PRIO)
    best = winner_lock_min(wid_s, prio_masked.contiguous(), Gs)
    selected = (prio_masked == take(best, wid_s.clamp(0, Gs - 1).long())
                ) & mask

    (ins, adapt, scale_b, dec_b, _h_b, _nb, _nb_valid, scale_n,
     dec_n) = update_phase_inputs(state, wid, d2b, selected, params)

    # ---- the slab's rows ---------------------------------------------------
    is_gng = params.model == "gng"
    w_pad = _pad_rows(state.w, cp, 0.0)
    age_pad = _pad_rows(state.age, cp, 0.0)
    nbr_s = remap(take(_pad_rows(state.nbr, cp, -1), rows))    # (B, Gs, K)
    stable_s = take(_pad_rows(stable_units(state, params), cp, False), rows)

    # ---- B3 + B4: accumulators and edge aging on the slab ------------------
    w1, nsc, nsx, err_u, decb_u, decn_u, _wind, age_s = update_accum(*(
        t.contiguous() for t in (
            signals, wid_s, selected, adapt, scale_b, d2b, dec_b, scale_n,
            dec_n, nbr_s, take(w_pad, rows), remap(sid), take(age_pad, rows),
            stable_s)))
    w2_s = w1 + (nsx - nsc[..., None] * w1)

    # ---- set the slab back (its rows are distinct) -------------------------
    idx = (rows,)
    w = put(w_pad, idx, w2_s)[:, :C]
    age = put(age_pad, idx, age_s)[:, :C]
    firing, error = state.firing, state.error
    if is_gng:
        error_pad = _pad_rows(error, cp, 0.0)
        error = put(error_pad, idx, take(error_pad, rows) + err_u)[:, :C]
    else:
        firing_pad = _pad_rows(firing, cp, 1.0)
        firing = put(firing_pad, idx, (take(firing_pad, rows) - decb_u
                                       - decn_u).clamp(params.h_min, 1.0)
                     )[:, :C]
    return UpdateOut(selected=selected, adapt=adapt, ins=ins, w=w,
                     firing=firing, error=error, age=age)


update_phase_sparse.slab_calls = 0
update_phase_sparse.dense_calls = 0
update_phase_sparse.pool_calls = 0

