"""Vectorized topology ops on fixed-degree neighbor lists, for a fleet.

The network graph is stored as per-unit neighbor lists ``nbr: (C, K) i32``
(``NO_NBR``/-1 = empty slot) plus aligned edge ages ``age: (C, K) f32``.
Every edge (a, b) is stored twice — in row a and in row b — and all ops
below keep exact symmetry (same neighbor sets, identical ages).

Every op takes a leading network axis B: tables are ``(B, C, K)`` and
``(B, C)``, batches of edges or winners ``(B, m)``; gathers and scatters
go through ``repro_torch.core.gson.batch``, sorts and ranks run along the
last dim. Called without the axis, an op runs as a fleet of one.

The winner lock makes winners distinct, but distinct winners may still
touch the same rows (shared neighbors, the same new edge), so each op
resolves collisions in a batch deterministically (sort + rank + masked
scatter). The results are bitwise those of ``repro.core.gson.topology``
for each network: every sort is stable, as ``jnp.argsort`` is, and the
JAX scatters that drop out-of-range rows write here into one spare row
that is cut off.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson.batch import add, batchable, put, take
from repro_torch.core.gson.state import (ACTIVE, CONNECTED, DISK,
                                         HABITUATED, HALF_DISK, NO_NBR,
                                         PATCH, SINGULAR)

_BIG = 2 ** 30
_INT32_MAX = 2 ** 31 - 1


@batchable(3)
def degrees(nbr: torch.Tensor) -> torch.Tensor:
    """(B, C) number of occupied neighbor slots per unit."""
    return (nbr >= 0).sum(dim=-1, dtype=torch.int32)


@batchable(3)
def find_slots(nbr: torch.Tensor, rows: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Slot index of ``vals[b, i]`` inside ``nbr[b, rows[b, i]]`` or -1 if
    absent.

    ``rows`` entries that are out of range are treated as absent.
    """
    C = nbr.shape[1]
    row_vals = take(nbr, rows.clamp(0, C - 1).long())        # (B, n, K)
    hit = (row_vals == vals[..., None]) & (vals[..., None] >= 0)
    slot = hit.to(torch.int32).argmax(dim=-1).to(torch.int32)
    found = hit.any(dim=-1) & (rows >= 0) & (rows < C)
    return torch.where(found, slot, torch.full_like(slot, -1))


@batchable(2)
def _rank_within_rows(rows: torch.Tensor) -> torch.Tensor:
    """For each entry, its 0-based rank among equal values of its
    network's ``rows``.

    Invalid rows must already be set to a large sentinel so they group
    together (their ranks are unused).
    """
    order = torch.argsort(rows, dim=-1, stable=True)
    sorted_rows = torch.gather(rows, -1, order).contiguous()
    first = torch.searchsorted(sorted_rows, sorted_rows, side="left")
    rank_sorted = (torch.arange(rows.shape[-1], device=rows.device,
                                dtype=torch.int32)
                   - first.to(torch.int32))
    return torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)


@batchable(3)
def edge_slots(nbr: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """(B, C, K) bool: the slots of the existing edges (a[i], b[i]) where
    mask[i], both directions."""
    C = nbr.shape[1]
    rows = torch.cat([a, b], dim=-1)
    vals = torch.cat([b, a], dim=-1)
    m2 = torch.cat([mask, mask], dim=-1)
    slots = find_slots(nbr, torch.where(m2, rows, -1), vals)
    ok = m2 & (slots >= 0)
    return put(torch.zeros_like(nbr, dtype=torch.bool),
               (torch.where(ok, rows, C), slots.clamp(min=0).long()), True)


@batchable(3)
def reset_edge_ages(nbr: torch.Tensor, age: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Set age of existing edges (a, b) to zero, both directions."""
    return torch.where(edge_slots(nbr, a, b, mask), 0.0, age)


@batchable(3)
def insert_edges(nbr: torch.Tensor, age: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, mask: torch.Tensor):
    """Symmetric insert-or-refresh of edges (a[i], b[i]) where mask[i].

    Existing edges get their age reset to 0. New edges are placed in free
    slots; duplicates within the batch are deduplicated; an edge is
    dropped (counted) unless BOTH endpoint rows have a free slot.

    Returns (nbr, age, dropped_count (B,)).
    """
    C, K = nbr.shape[1:]
    m = a.shape[-1]
    valid = mask & (a >= 0) & (b >= 0) & (a != b)

    # --- refresh existing edges ---
    slot_ab = find_slots(nbr, torch.where(valid, a, -1), b)
    exists = slot_ab >= 0
    age = reset_edge_ages(nbr, age, a, b, valid & exists)

    new = valid & ~exists
    # --- deduplicate identical new edges within the batch ---
    # int64 keys; the order (lo, hi) is that of the reference's int32 key
    lo = torch.minimum(a, b).long()
    hi = torch.maximum(a, b).long()
    key = torch.where(new, lo * C + hi, _INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, -1, order)
    first = torch.cat([torch.ones_like(skey[..., :1], dtype=torch.bool),
                       skey[..., 1:] != skey[..., :-1]], dim=-1)
    uniq = torch.empty_like(first).scatter_(-1, order, first)
    new = new & uniq

    # --- directed entries, rank within target row, pick free slots ---
    rows = torch.cat([a, b], dim=-1)
    vals = torch.cat([b, a], dim=-1)
    emask = torch.cat([new, new], dim=-1)
    rrows = torch.where(emask, rows, _BIG)
    rank = _rank_within_rows(rrows)

    occupied = take(nbr, rows.clamp(0, C - 1).long()) >= 0   # (B, 2m, K)
    free_count = K - occupied.sum(dim=-1, dtype=torch.int32)
    # stable argsort: free slots first, ascending position
    slot_order = torch.argsort(occupied.to(torch.int32), dim=-1, stable=True)
    slot = torch.gather(slot_order, -1,
                        rank.clamp(max=K - 1).long()[..., None])[..., 0]
    fits = emask & (rank < free_count)

    # an edge lands only if BOTH directions fit (symmetry)
    edge_ok = fits[..., :m] & fits[..., m:]
    dropped = (new & ~edge_ok).sum(dim=-1, dtype=torch.int32)
    ok2 = torch.cat([edge_ok, edge_ok], dim=-1)
    srows = torch.where(ok2, rows, C).long()
    nbr = put(nbr, (srows, slot), vals.to(torch.int32))
    age = put(age, (srows, slot), 0.0)
    return nbr, age, dropped


@batchable(3)
def remove_edge_pairs(nbr: torch.Tensor, age: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, mask: torch.Tensor):
    """Remove edges (a[i], b[i]) where mask[i], both directions."""
    C = nbr.shape[1]
    rows = torch.cat([a, b], dim=-1)
    vals = torch.cat([b, a], dim=-1)
    m2 = torch.cat([mask, mask], dim=-1)
    slots = find_slots(nbr, torch.where(m2, rows, -1), vals)
    ok = m2 & (slots >= 0)
    index = (torch.where(ok, rows, C).long(), slots.clamp(min=0).long())
    nbr = put(nbr, index, NO_NBR)
    age = put(age, index, 0.0)
    return nbr, age


@batchable(3)
def age_incident_edges(nbr: torch.Tensor, age: torch.Tensor,
                       winners: torch.Tensor, mask: torch.Tensor,
                       amount: float = 1.0,
                       protect: torch.Tensor | None = None):
    """Increment the age of every edge incident to ``winners`` (symmetric).

    After the winner lock winners are distinct, so each winner row is
    touched once; mirrored increments on neighbor rows may collide across
    winners and are summed (whole-number increments: exact in any order).

    ``protect``: (B, C) bool — edges whose BOTH endpoints are protected do
    not age (SOAM's crystallization of stable neighborhoods).
    """
    B, C, K = nbr.shape
    dev = nbr.device
    if protect is None:
        protect = torch.zeros((B, C), dtype=torch.bool, device=dev)
    w = torch.where(mask, winners, C)
    wc = winners.clamp(0, C - 1).long()
    row_nbrs = take(nbr, wc)                                  # (B, m, K)
    row_valid = row_nbrs >= 0
    safe_nbrs = row_nbrs.clamp(0, C - 1).long()
    keep = take(protect, wc)[..., None] & take(protect, safe_nbrs)
    inc = row_valid & ~keep
    m = winners.shape[-1]
    cols = torch.arange(K, device=dev)
    age = add(age, (w[..., None].expand(B, m, K),
                    cols.expand(B, m, K)), amount * inc.to(age.dtype))
    # mirror: for each neighbor c of winner b, slot of b inside row c
    back = take(nbr, safe_nbrs)                               # (B, m, K, K)
    onehot = ((back == winners[..., None, None])
              & (row_nbrs[..., None] >= 0))
    onehot = onehot & ~keep[..., None]
    tgt_rows = torch.where(mask[..., None] & (row_nbrs >= 0), row_nbrs, C)
    age = add(age, (tgt_rows[..., None].expand(B, m, K, K),
                    cols.expand(B, m, K, K)),
              amount * onehot.to(age.dtype))
    return age


@batchable(3)
def expire_edges(nbr: torch.Tensor, age: torch.Tensor, age_max: float):
    """Drop all edges with age > age_max. Symmetric because ages are."""
    expired = (nbr >= 0) & (age > age_max)
    nbr = torch.where(expired, NO_NBR, nbr)
    age = torch.where(expired, 0.0, age)
    return nbr, age, expired.sum(dim=(-2, -1), dtype=torch.int32) // 2


@batchable(2)
def prune_isolated(active: torch.Tensor, nbr: torch.Tensor,
                   firing: torch.Tensor):
    """Deactivate units that lost all their edges (and have fired)."""
    deg = degrees(nbr)
    remove = active & (deg == 0) & (firing < 1.0 - 1e-6)
    return active & ~remove, remove.sum(dim=-1, dtype=torch.int32)


@batchable(3)
def drop_edges_to_inactive(nbr: torch.Tensor, age: torch.Tensor,
                           active: torch.Tensor):
    """Remove dangling references to deactivated units."""
    safe = nbr.clamp(0, active.shape[-1] - 1).long()
    ok = (nbr >= 0) & take(active, safe)
    return torch.where(ok, nbr, NO_NBR), torch.where(ok, age, 0.0)


# ---------------------------------------------------------------------------
# SOAM topological state ladder
# ---------------------------------------------------------------------------

def _neighborhood_linkgraph(nbr: torch.Tensor) -> torch.Tensor:
    """M[b, c, p, q] = True iff neighbors p and q of unit c are linked.

    Batched over all networks and C rows. Returns (B, C, K, K) bool.
    """
    C, K = nbr.shape[1:]
    valid = nbr >= 0
    rows = take(nbr, nbr.clamp(0, C - 1).long())             # (B, C, K, K)
    m = (rows[..., None, :] == nbr[..., None, :, None]).any(dim=-1)
    m = m & valid[..., :, None] & valid[..., None, :]
    eye = torch.eye(K, dtype=torch.bool, device=nbr.device)
    return m & ~eye


def _is_connected(m: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, C) all valid nodes mutually reachable in each (K, K) link
    graph.

    Repeated squaring of the 0/1 reachability matrix in float: the sums
    are small whole numbers, exact in any float format.
    """
    K = m.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=m.device)
    reach = m | eye
    for _ in range(max(1, K.bit_length())):
        r = reach.to(torch.float32).reshape(-1, K, K)
        reach = reach | (torch.bmm(r, r) > 0).view(reach.shape)
    first = valid.to(torch.int32).argmax(dim=-1)              # (B, C)
    from_first = torch.gather(
        reach, -2, first[..., None, None].expand(*first.shape, 1, K))
    return torch.where(valid, from_first[..., 0, :], True).all(dim=-1)


@batchable(3)
def compute_topo_states(nbr: torch.Tensor, active: torch.Tensor,
                        firing: torch.Tensor,
                        firing_threshold: float) -> torch.Tensor:
    """Full-network SOAM state ladder (vectorized over all capacity rows
    of every network).

    Returns (B, C) int32 states. Inactive rows get ACTIVE (ignored
    upstream).
    """
    K = nbr.shape[-1]
    C = nbr.shape[1]
    valid = nbr >= 0
    deg = valid.sum(dim=-1)
    m = _neighborhood_linkgraph(nbr)
    rowsum = torch.where(valid, m.sum(dim=-1), 0)
    conn = _is_connected(m, valid)
    all1plus = torch.where(valid, rowsum >= 1, True).all(dim=-1)
    n_end = (valid & (rowsum == 1)).sum(dim=-1)
    n_mid = (valid & (rowsum == 2)).sum(dim=-1)
    over = (valid & (rowsum > 2)).any(dim=-1)
    path_s = (deg >= 2) & conn & (n_end == 2) & (n_mid == deg - 2)
    cycle_s = (deg >= 3) & conn & (n_mid == deg) & ~over
    conn_s = (deg >= 2) & all1plus
    habituated = firing < firing_threshold

    def put_state(cond, value, state):
        return torch.where(cond, value, state)

    state = torch.full(deg.shape, ACTIVE, dtype=torch.int32,
                       device=nbr.device)
    state = put_state(habituated, HABITUATED, state)
    state = put_state(habituated & conn_s, CONNECTED, state)
    state = put_state(habituated & path_s, HALF_DISK, state)
    state = put_state(habituated & cycle_s, DISK, state)
    singular = habituated & ((deg >= K) | (over & ~cycle_s & (deg >= 3)))
    state = put_state(singular, SINGULAR, state)

    # PATCH: disk whose neighbors are all disk-or-patch
    nb_state = take(state, nbr.clamp(0, C - 1).long())
    nb_disk = (nb_state >= DISK) & (nb_state != SINGULAR)
    nb_ok = torch.where(valid, nb_disk, True).all(dim=-1)
    state = put_state((state == DISK) & nb_ok, PATCH, state)
    return put_state(active, state, torch.full_like(state, ACTIVE))
