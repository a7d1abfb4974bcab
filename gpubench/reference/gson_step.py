"""The plain reference: one multi-signal SOAM iteration of one network.

A frozen, self-contained copy of the rules the benchmark's cells run
(the paper's multi-signal iteration, arXiv:1503.08294 Sec. 2.2, with
SOAM's state ladder and adaptive threshold, on a fixed pool of C unit
slots of K neighbor slots each), written for one network at a time in
plain PyTorch, float32. It imports nothing of the program under test.

One iteration (``step``), from the state before it, its signal buffer
and its lock priorities:

  1. m-schedule: the first m = next power of two above the active count
     (clipped to [min_m, the rows of the signal buffer]) signals are
     live;
  2. Find Winners: squared distances |x|^2 - 2 x.w + |w|^2 by a matrix
     product (float32 with TF32 off; ``tf32=True``, its inputs rounded
     to TF32, is the control), the two nearest active units;
  3. winner lock: of the signals sharing a winner, the lowest priority
     survives;
  4. insertion test (SOAM): a survivor whose winner is habituated and
     farther than the winner's threshold inserts a unit, the others
     adapt: winner and neighbor pulls, habituation, edge aging on the
     winners' rows, the winner-second edge reset;
  5. structural tail: new units in the lowest free slots, edges (new,
     winner), (new, second) in, (winner, second) out for inserts,
     (winner, second) refreshed or inserted for adapting signals, edge
     expiry, pruning of isolated units;
  6. SOAM's state ladder and threshold update when the refresh cadence or
     the convergence check is due.

Beside the new state, ``step`` says whether the iteration held a near
tie: a decision that float32 rounding can take either way (two
candidate winners or seconds whose distances lie within ``D2_TIE``, a
distance within ``D2_TIE`` of a threshold, a firing counter within
``FIRING_TIE`` of a threshold). The check leaves such an iteration out.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

NO_NBR = -1
ACTIVE, HABITUATED, CONNECTED, HALF_DISK, DISK, PATCH, SINGULAR = range(7)
INT32_MAX = 2 ** 31 - 1
BIG_ROW = 2 ** 30

# near-tie margins: far above the float32 rounding of a squared distance
# of unit-scale points (a few 1e-7) and of a firing counter, far below
# the gaps that a lower precision opens (TF32: ~1e-3)
D2_TIE = 2e-6
FIRING_TIE = 1e-5

FIELDS = ("w", "active", "nbr", "age", "error", "firing", "threshold",
          "topo_state", "inconsistent_for", "n_active", "signal_count",
          "discarded", "dropped_edges", "dropped_units")


@dataclass
class Params:
    """The rule set and loop cadences, as the configuration states them."""

    eps_b: float
    eps_n: float
    age_max: float
    insertion_threshold: float
    firing_threshold: float
    tau_b: float
    tau_n: float
    h_min: float
    thr_decay: float
    thr_recover: float
    thr_min_frac: float
    stuck_window: int
    freeze_stable: bool
    min_m: int
    refresh_every: int
    check_every: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        model = cfg["model"]
        if model["model"] != "soam" or model["neighbor_collision"] != "sum":
            raise ValueError("the reference implements SOAM with summed "
                             "neighbor pulls")
        vc = cfg["variant_config"]
        if vc.get("fixed_m") is not None:
            raise ValueError("the reference implements the m-schedule")
        return cls(
            **{k: model[k] for k in (
                "eps_b", "eps_n", "age_max", "insertion_threshold",
                "firing_threshold", "tau_b", "tau_n", "h_min",
                "thr_decay", "thr_recover", "thr_min_frac",
                "stuck_window", "freeze_stable")},
            min_m=vc["min_m"],
            refresh_every=vc["refresh_every"],
            check_every=cfg["check_every"])


@dataclass
class Net:
    """One network's state: per-unit tensors and 0-d int64 counters."""

    w: torch.Tensor
    active: torch.Tensor
    nbr: torch.Tensor
    age: torch.Tensor
    error: torch.Tensor
    firing: torch.Tensor
    threshold: torch.Tensor
    topo_state: torch.Tensor
    inconsistent_for: torch.Tensor
    n_active: torch.Tensor
    signal_count: torch.Tensor
    discarded: torch.Tensor
    dropped_edges: torch.Tensor
    dropped_units: torch.Tensor

    @classmethod
    def of(cls, fields: dict) -> "Net":
        """From any object's tensors, copied: ints to int64 counters."""
        out = {}
        for f in FIELDS:
            t = torch.as_tensor(fields[f]).clone()
            if t.dim() == 0:
                t = t.to(torch.int64)
            out[f] = t
        return cls(**out)

    def replace(self, **kw) -> "Net":
        return dataclasses.replace(self, **kw)


def init(seed_points: torch.Tensor, capacity: int, max_deg: int,
         threshold: float) -> Net:
    """A fresh network: the seed points active, unconnected."""
    n, d = seed_points.shape
    dev = seed_points.device
    w = torch.zeros((capacity, d), dtype=torch.float32, device=dev)
    w[:n] = seed_points.to(torch.float32)
    active = torch.zeros(capacity, dtype=torch.bool, device=dev)
    active[:n] = True

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    def cnt(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)
    return Net(w=w, active=active,
               nbr=full((capacity, max_deg), NO_NBR, torch.int32),
               age=full((capacity, max_deg), 0.0, torch.float32),
               error=full((capacity,), 0.0, torch.float32),
               firing=full((capacity,), 1.0, torch.float32),
               threshold=full((capacity,), threshold, torch.float32),
               topo_state=full((capacity,), ACTIVE, torch.int32),
               inconsistent_for=full((capacity,), 0, torch.int32),
               n_active=cnt(n), signal_count=cnt(0), discarded=cnt(0),
               dropped_edges=cnt(0), dropped_units=cnt(0))


# --- Find Winners -----------------------------------------------------------

def squared_distances(x: torch.Tensor, w: torch.Tensor, active: torch.Tensor,
                      tf32: bool = False) -> torch.Tensor:
    """(m, C) squared distances to the active units (inf elsewhere). With
    ``tf32`` the product's inputs are rounded to TF32, as a tensor core
    takes them (the products of such inputs are exact in float32, which
    sums them): the same on every device and every matrix shape, where
    the library's TF32 setting leaves some shapes in float32."""
    a, b = 2.0 * x, w
    if tf32:
        a, b = _round_tf32(a), _round_tf32(b)
    d2 = (x * x).sum(-1, keepdim=True) - a @ b.T + (w * w).sum(-1)[None]
    return torch.where(active[None], d2, torch.inf)


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def top3(d2: torch.Tensor):
    """Three nearest (ids, d2), ascending; fewer active units give inf."""
    k = min(3, d2.shape[1])
    vals, ids = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    if k < 3:
        pad = 3 - k
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                              torch.inf)], 1)
        ids = torch.cat([ids, ids[:, :1].expand(-1, pad)], 1)
    return ids, vals


# --- edges --------------------------------------------------------------------

def find_slots(nbr, rows, vals):
    """Slot of vals[i] in row rows[i] (-1: absent or row out of range)."""
    C = nbr.shape[0]
    inside = (rows >= 0) & (rows < C)
    row_vals = nbr[rows.clamp(0, C - 1).long()]
    hit = (row_vals == vals[:, None]) & (vals[:, None] >= 0)
    slot = hit.to(torch.int32).argmax(dim=1)
    return torch.where(hit.any(1) & inside, slot, -1)


def _set(t, rows, cols, value, ok):
    """t[rows[ok], cols[ok]] = value (value a scalar or per entry)."""
    r, c = rows[ok].long(), cols[ok].long()
    if torch.is_tensor(value):
        value = value[ok].to(t.dtype)
    t = t.clone()
    t[r, c] = value
    return t


def reset_ages(nbr, age, a, b, mask):
    rows = torch.cat([a, b])
    vals = torch.cat([b, a])
    m2 = torch.cat([mask, mask])
    slots = find_slots(nbr, torch.where(m2, rows, -1), vals)
    return _set(age, rows, slots, 0.0, m2 & (slots >= 0))


def insert_edges(nbr, age, a, b, mask):
    """Insert-or-refresh the edges (a[i], b[i]) where mask[i]: an existing
    edge's age goes to 0; a new one, the first of its duplicates, takes
    the lowest free slot of each row in the order of the batch (all a
    rows before all b rows) and lands only if both rows have one.
    Returns (nbr, age, dropped)."""
    C, K = nbr.shape
    n = a.shape[0]
    valid = mask & (a >= 0) & (b >= 0) & (a != b)
    exists = find_slots(nbr, torch.where(valid, a, -1), b) >= 0
    age = reset_ages(nbr, age, a, b, valid & exists)
    new = valid & ~exists
    lo = torch.minimum(a, b).long()
    hi = torch.maximum(a, b).long()
    key = torch.where(new, lo * C + hi, INT32_MAX)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    first_sorted = torch.ones_like(skey, dtype=torch.bool)
    first_sorted[1:] = skey[1:] != skey[:-1]
    first = torch.empty_like(first_sorted)
    first[order] = first_sorted
    new = new & first

    rows = torch.cat([a, b])
    vals = torch.cat([b, a])
    emask = torch.cat([new, new])
    # rank of each entry among the earlier entries for the same row
    rrows = torch.where(emask, rows, BIG_ROW).long()
    order = torch.argsort(rrows, stable=True)
    srows = rrows[order]
    start = torch.searchsorted(srows, srows, side="left")
    rank = torch.empty_like(srows)
    rank[order] = torch.arange(2 * n, device=nbr.device) - start
    occupied = nbr[rows.clamp(0, C - 1).long()] >= 0
    free = K - occupied.sum(1)
    slot_order = torch.argsort(occupied.to(torch.int32), dim=1, stable=True)
    slot = torch.gather(slot_order, 1, rank.clamp(max=K - 1)[:, None])[:, 0]
    fits = emask & (rank < free)
    ok = fits[:n] & fits[n:]
    dropped = (new & ~ok).sum()
    ok2 = torch.cat([ok, ok])
    nbr = _set(nbr, rows, slot, vals, ok2)
    age = _set(age, rows, slot, 0.0, ok2)
    return nbr, age, dropped


def remove_edges(nbr, age, a, b, mask):
    rows = torch.cat([a, b])
    vals = torch.cat([b, a])
    m2 = torch.cat([mask, mask])
    slots = find_slots(nbr, torch.where(m2, rows, -1), vals)
    ok = m2 & (slots >= 0)
    return _set(nbr, rows, slots, NO_NBR, ok), _set(age, rows, slots, 0.0, ok)


def age_winner_edges(nbr, age, winners, protect):
    """+1 on every edge at a winner (distinct winners), in both rows,
    unless both ends are protected."""
    C, K = nbr.shape
    row = nbr[winners.long()]                                  # (s, K)
    valid = row >= 0
    safe = row.clamp(0, C - 1).long()
    inc = valid & ~(protect[winners.long()][:, None] & protect[safe])
    age = age.clone()
    cols = torch.arange(K, device=nbr.device).expand_as(row)
    age.index_put_((winners.long()[:, None].expand_as(row)[inc],
                    cols[inc]), torch.ones_like(age[:1, 0]).expand(
                        int(inc.sum())), accumulate=True)
    back = nbr[safe]                                           # (s, K, K)
    hit = (back == winners[:, None, None]) & inc[..., None]
    tgt = safe[..., None].expand_as(back)
    kk = torch.arange(K, device=nbr.device).expand_as(back)
    age.index_put_((tgt[hit], kk[hit]), torch.ones_like(age[:1, 0]).expand(
        int(hit.sum())), accumulate=True)
    return age


# --- SOAM state ladder ----------------------------------------------------------

def topo_states(nbr, active, firing, firing_threshold):
    C, K = nbr.shape
    valid = nbr >= 0
    deg = valid.sum(1)
    rows = nbr[nbr.clamp(0, C - 1).long()]                     # (C, K, K)
    link = (rows[:, :, None, :] == nbr[:, None, :, None]).any(-1)
    eye = torch.eye(K, dtype=torch.bool, device=nbr.device)
    link = link & valid[:, :, None] & valid[:, None, :] & ~eye
    rowsum = torch.where(valid, link.sum(-1), 0)
    # connectivity of each neighborhood's link graph: closure by squaring
    reach = link | eye
    for _ in range(K.bit_length()):
        r = reach.to(torch.float32)
        reach = reach | (torch.bmm(r, r) > 0)
    first = valid.to(torch.int32).argmax(1)
    from_first = reach[torch.arange(C, device=nbr.device), first]
    conn = torch.where(valid, from_first, True).all(1)
    all1 = torch.where(valid, rowsum >= 1, True).all(1)
    n_end = (valid & (rowsum == 1)).sum(1)
    n_mid = (valid & (rowsum == 2)).sum(1)
    over = (valid & (rowsum > 2)).any(1)
    path = (deg >= 2) & conn & (n_end == 2) & (n_mid == deg - 2)
    cycle = (deg >= 3) & conn & (n_mid == deg) & ~over
    connected = (deg >= 2) & all1
    hab = firing < firing_threshold
    st = torch.full((C,), ACTIVE, dtype=torch.int32, device=nbr.device)
    st = torch.where(hab, HABITUATED, st)
    st = torch.where(hab & connected, CONNECTED, st)
    st = torch.where(hab & path, HALF_DISK, st)
    st = torch.where(hab & cycle, DISK, st)
    st = torch.where(hab & ((deg >= K) | (over & ~cycle & (deg >= 3))),
                     SINGULAR, st)
    nb = st[nbr.clamp(0, C - 1).long()]
    nb_ok = torch.where(valid, (nb >= DISK) & (nb != SINGULAR), True).all(1)
    st = torch.where((st == DISK) & nb_ok, PATCH, st)
    return torch.where(active, st, ACTIVE).to(torch.int32)


def refresh(net: Net, p: Params) -> Net:
    """The state ladder, then the threshold: tighten where stuck non-disk
    for ``stuck_window`` refreshes, relax toward the initial value where
    stable."""
    st = topo_states(net.nbr, net.active, net.firing, p.firing_threshold)
    stable = (st >= DISK) & (st != SINGULAR)
    stuck = net.active & (net.firing < p.firing_threshold) & ~stable
    inc = torch.where(stuck, net.inconsistent_for + 1, 0)
    tighten = inc >= p.stuck_window
    thr = torch.where(
        tighten, (net.threshold * p.thr_decay).clamp(
            min=p.insertion_threshold * p.thr_min_frac), net.threshold)
    inc = torch.where(tighten, 0, inc)
    thr = torch.where(net.active & stable, (thr * p.thr_recover).clamp(
        max=p.insertion_threshold), thr)
    return net.replace(topo_state=st, threshold=thr,
                       inconsistent_for=inc.to(torch.int32))


# --- the iteration ----------------------------------------------------------------

def live_signals(n_active: int, p: Params, rows: int) -> int:
    """The m-schedule: the smallest power of two above the active count,
    clipped to [min_m, rows], ``rows`` the signal buffer's."""
    m = 1 << int(n_active).bit_length()
    return max(min(m, rows), min(p.min_m, rows))


def step(net: Net, x: torch.Tensor, prio: torch.Tensor, t: int, p: Params,
         tf32: bool = False):
    """Iteration t of one network: ``x`` (buffer rows, d) signals,
    ``prio`` (buffer rows,) lock priorities. Returns (state, near_tie)."""
    C, K = net.nbr.shape
    dev = net.w.device
    m = live_signals(int(net.n_active), p, x.shape[0])
    x, prio = x[:m].to(torch.float32), prio[:m].long()

    d2 = squared_distances(x, net.w, net.active, tf32)
    ids, dist = top3(d2)
    wid, sid = ids[:, 0], ids[:, 1]
    d2b = dist[:, 0].clamp(min=0.0)
    if not torch.isfinite(dist[:, 1]).all():     # < 2 active: duplicate
        bad = ~torch.isfinite(dist[:, 1])
        sid = torch.where(bad, wid, sid)

    best = torch.full((C,), INT32_MAX, dtype=torch.int64, device=dev)
    best = best.scatter_reduce(0, wid, prio, reduce="amin")
    sel = prio == best[wid]
    n_sel = int(sel.sum())

    h_b = net.firing[wid]
    thr_b = net.threshold[wid]
    ins = sel & (torch.sqrt(d2b) > thr_b) & (h_b < p.firing_threshold)
    adapt = sel & ~ins

    tie = bool(((dist[:, 1] - dist[:, 0]) < D2_TIE).any())
    tie |= bool(((dist[:, 2] - dist[:, 1])[sel] < D2_TIE).any())
    tie |= bool(((d2b - thr_b.double() ** 2).abs()[
        sel & (h_b < p.firing_threshold)] < D2_TIE).any())

    stable = ((net.topo_state >= DISK) & (net.topo_state != SINGULAR)
              if p.freeze_stable else torch.zeros_like(net.active))

    # adaptation: winner pulls (distinct winners), then neighbor pulls
    # from the pulled weights, summed per unit
    w = net.w.clone()
    aw = wid[adapt]
    scale_b = torch.where(stable[aw], 0.0, p.eps_b * net.firing[aw])
    w[aw] = net.w[aw] + scale_b[:, None] * (x[adapt] - net.w[aw])
    nb = net.nbr[aw]                                           # (a, K)
    nv = nb >= 0
    nbs = nb.clamp(0, C - 1).long()
    scale_n = torch.where(stable[nbs] | ~nv, 0.0, p.eps_n * net.firing[nbs])
    delta = scale_n[..., None] * (x[adapt][:, None, :] - w[nbs])
    w2 = w.clone()
    w2.index_put_((nbs[nv],), delta[nv], accumulate=True)

    firing = net.firing.clone()
    firing[aw] = firing[aw] - p.tau_b * (net.firing[aw] - p.h_min)
    dec_n = p.tau_n * (net.firing[nbs] - p.h_min)
    firing.index_put_((nbs[nv],), -dec_n[nv], accumulate=True)
    firing = firing.clamp(p.h_min, 1.0)

    age = age_winner_edges(net.nbr, net.age, wid[sel], stable)
    age = reset_ages(net.nbr, age, wid, sid, adapt)

    # unit insertion into the lowest free slots, in signal order
    free_order = torch.argsort(net.active.to(torch.int32), stable=True)
    rank = torch.cumsum(ins.long(), 0) - 1
    n_free = C - int(net.n_active)
    fits = ins & (rank < n_free)
    new_id = torch.where(fits, free_order[rank.clamp(0, C - 1)], -1)
    nid = new_id[fits]
    active = net.active.clone()
    threshold = net.threshold.clone()
    error = net.error.clone()
    topo = net.topo_state.clone()
    incons = net.inconsistent_for.clone()
    w_new = 0.5 * (w2[wid[fits]] + x[fits])
    w2[nid] = w_new
    active[nid] = True
    firing[nid] = 1.0
    error[nid] = 0.0
    threshold[nid] = net.threshold[wid[fits]]
    topo[nid] = ACTIVE
    incons[nid] = 0

    nid32 = new_id.to(torch.int32)
    w32, s32 = wid.to(torch.int32), sid.to(torch.int32)
    nbr, age, d1 = insert_edges(net.nbr, age, torch.cat([nid32, nid32]),
                                torch.cat([w32, s32]),
                                torch.cat([fits, fits]))
    nbr, age = remove_edges(nbr, age, w32, s32, fits)
    nbr, age, d2_ = insert_edges(nbr, age, w32, s32, adapt)

    expired = (nbr >= 0) & (age > p.age_max)
    nbr = torch.where(expired, NO_NBR, nbr)
    age = torch.where(expired, 0.0, age)
    deg = (nbr >= 0).sum(1)
    tie |= bool(((firing - (1.0 - 1e-6)).abs()[active & (deg == 0)]
                 < FIRING_TIE).any())
    active = active & ~((deg == 0) & (firing < 1.0 - 1e-6))
    nbr = torch.where(active[:, None], nbr, NO_NBR)
    ok = (nbr >= 0) & active[nbr.clamp(0, C - 1).long()]
    nbr = torch.where(ok, nbr, NO_NBR)
    age = torch.where(ok, age, 0.0)

    out = Net(w=w2, active=active, nbr=nbr, age=age, error=error,
              firing=firing, threshold=threshold, topo_state=topo,
              inconsistent_for=incons, n_active=active.sum(),
              signal_count=net.signal_count + m,
              discarded=net.discarded + (m - n_sel),
              dropped_edges=net.dropped_edges + d1 + d2_,
              dropped_units=net.dropped_units + int((ins & ~fits).sum()))
    refreshes = (t % p.refresh_every == 0) + ((t + 1) % p.check_every == 0)
    if refreshes:
        touched = (firing != net.firing) & active
        tie |= bool(((firing - p.firing_threshold).abs()[touched]
                     < FIRING_TIE).any())
        for _ in range(refreshes):
            out = refresh(out, p)
    return out, tie
