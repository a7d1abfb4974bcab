"""The plain reference of the GNG cells: one multi-signal Growing Neural
Gas iteration of one network.

Fritzke 1995, "A Growing Neural Gas Network Learns Topologies" (NIPS 7),
run as the multi-signal iteration of arXiv:1503.08294 Sec. 2.2 on a
fixed pool of C unit slots of K neighbor slots each, for one network at
a time in plain PyTorch, float32. It imports nothing of the program
under test; it shares the pool's rules (Find Winners, the edge table)
with the SOAM reference, ``gson_step``.

Fritzke's steps, as one iteration (``step``) takes them, from the state
before it, its signal buffer and its lock priorities:

  1. m-schedule: the first m = next power of two above the active count
     (clipped to [min_m, the rows of the signal buffer]) signals are
     live;
  2. Find Winners (Fritzke 2): the nearest unit s1 and the second s2 of
     each signal, by the distance product of ``gson_step``;
  3. winner lock: of the signals sharing a winner, the lowest priority
     survives (departure 3 below);
  4. for each survivor (Fritzke 3-6): every edge at s1 ages by 1; s1's
     error grows by its squared distance; s1 moves by eps_b, then its
     neighbors by eps_n towards the signal, from s1's moved weights,
     their moves summed per unit; the edge (s1, s2) is refreshed to age
     0 or inserted;
  5. insertion (Fritzke 8): n = (survivors so far) // lambda minus the
     same before the iteration, at most ``K_CAP``; the n units of
     largest error q, each with its neighbor of largest error f, each
     give a new unit r halfway between q and f in the lowest free slot,
     edges (r, q), (r, f) in and (q, f) out; the errors of q and f are
     multiplied by alpha, and r's error is alpha times q's;
  6. edge expiry (Fritzke 7): edges older than ``age_max`` go;
  7. error decay (Fritzke 9): every error is multiplied by d = 1 - beta
     once per survivor, d ** survivors, after the insertions.

Departures from Fritzke 1995, which are the program's semantics (the
JAX package's, mirrored by the port) and are reproduced here:

  1. lambda counts effective signals, the lock's survivors, where
     Fritzke counts every input signal;
  2. at most ``K_CAP`` = 8 insertions per iteration; insertions due
     beyond it are not carried over;
  3. the winner lock keeps one signal per distinct winner; the others
     are discarded: they neither move a unit, nor add error, nor age an
     edge, nor count towards lambda;
  4. the new unit's error is alpha times q's error after q's own alpha
     cut, alpha ** 2 of q's old error, where Fritzke gives r q's new
     error (alpha of the old);

and, as the batched iteration has them:

  5. the q of an iteration's insertions are the units of the n largest
     errors at once, each f the worst neighbor then, before any cut of
     the iteration; a unit that is the q or f of several insertions is
     cut once for each;
  6. a q without a neighbor inserts nothing (it has no f);
  7. a unit that loses its last edge stays (Fritzke removes it): the
     pool prunes only units whose firing counter has moved below 1, and
     GNG never moves it;
  8. the decay comes once per iteration (step 7), where Fritzke decays
     after every signal.

Beside the new state, ``step`` says whether the iteration held a near
tie, a decision that float32 rounding can take either way: two
candidate winners or seconds whose squared distances lie within
``gson_step.D2_TIE``; two errors within ``ERR_TIE`` plus ``ERR_TIE_REL``
times the larger where the insertion reads their order: neighbors in
the sorted errors down to the first one not taken, and the largest two
neighbor errors of a taken q. The lambda boundary is whole-number
arithmetic on signal counts and needs no rule. The check leaves such an
iteration out.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from gpubench.reference import gson_step as ref

FIELDS = ref.FIELDS
Net = ref.Net
D2_TIE = ref.D2_TIE
# a fresh network (the seed points active, unconnected, no error) and
# the m-schedule are the pool's, as in the SOAM reference
init = ref.init
live_signals = ref.live_signals
K_CAP = 8
# the errors' near-tie margin, ERR_TIE + ERR_TIE_REL times the larger
# error: an error is a decayed sum of squared distances, each rounded
# within a few 1e-7 (``D2_TIE`` allows for them), and early in a job a
# sum of a hundred of them; far below the gaps a lower precision opens
# (TF32: ~1e-3 of each distance)
ERR_TIE = 2e-6
ERR_TIE_REL = 1e-5


@dataclass
class Params:
    """GNG's rule set and the loop's cadences, as the configuration
    states them."""

    eps_b: float
    eps_n: float
    age_max: float
    gng_lambda: int
    gng_alpha: float
    gng_beta: float
    insertion_threshold: float
    min_m: int
    check_every: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        model = cfg["model"]
        if model["model"] != "gng" or model["neighbor_collision"] != "sum":
            raise ValueError("the reference implements GNG with summed "
                             "neighbor pulls")
        vc = cfg["variant_config"]
        if vc.get("fixed_m") is not None:
            raise ValueError("the reference implements the m-schedule")
        return cls(
            **{k: model[k] for k in (
                "eps_b", "eps_n", "age_max", "gng_lambda", "gng_alpha",
                "gng_beta", "insertion_threshold")},
            min_m=vc["min_m"], check_every=cfg["check_every"])


def _near(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Errors a >= b that float32 rounding could put in either order."""
    return (a - b) <= ERR_TIE + ERR_TIE_REL * a.abs()


def step(net: Net, x: torch.Tensor, prio: torch.Tensor, t: int, p: Params,
         tf32: bool = False, fault: str | None = None):
    """Iteration t of one network: ``x`` (buffer rows, d) signals,
    ``prio`` (buffer rows,) lock priorities. Returns (state, near_tie).
    ``fault`` plants a known fault for the tests of the check:
    ``"second_worst"`` inserts at the unit of the second largest error
    in place of the largest."""
    C, K = net.nbr.shape
    dev = net.w.device
    m = live_signals(int(net.n_active), p, x.shape[0])
    x, prio = x[:m].to(torch.float32), prio[:m].long()

    # Find Winners and the lock
    d2 = ref.squared_distances(x, net.w, net.active, tf32)
    ids, dist = ref.top3(d2)
    wid, sid = ids[:, 0], ids[:, 1]
    d2b = dist[:, 0].clamp(min=0.0)
    if not torch.isfinite(dist[:, 1]).all():     # < 2 active: duplicate
        bad = ~torch.isfinite(dist[:, 1])
        sid = torch.where(bad, wid, sid)
    best = torch.full((C,), ref.INT32_MAX, dtype=torch.int64, device=dev)
    best = best.scatter_reduce(0, wid, prio, reduce="amin")
    sel = prio == best[wid]
    n_sel = int(sel.sum())
    tie = bool(((dist[:, 1] - dist[:, 0]) < D2_TIE).any())
    tie |= bool(((dist[:, 2] - dist[:, 1])[sel] < D2_TIE).any())

    # every survivor adapts: the winner's pull, then the neighbors' from
    # the pulled weights, summed per unit; the winner's error
    aw, xs = wid[sel], x[sel]
    w = net.w.clone()
    w[aw] = net.w[aw] + p.eps_b * (xs - net.w[aw])
    nb = net.nbr[aw]                                           # (s, K)
    nv = nb >= 0
    nbs = nb.clamp(0, C - 1).long()
    delta = p.eps_n * (xs[:, None, :] - w[nbs])
    w.index_put_((nbs[nv],), delta[nv], accumulate=True)
    error = net.error.clone()
    error[aw] = net.error[aw] + d2b[sel]

    no_protect = torch.zeros_like(net.active)
    age = ref.age_winner_edges(net.nbr, net.age, aw, no_protect)
    age = ref.reset_ages(net.nbr, age, wid, sid, sel)
    nbr, age, d1 = ref.insert_edges(net.nbr, age, wid.to(torch.int32),
                                    sid.to(torch.int32), sel)

    # insertion at the units of largest error
    eff_old = int(net.signal_count) - int(net.discarded)
    n_ins = min(max((eff_old + n_sel) // p.gng_lambda
                    - eff_old // p.gng_lambda, 0), K_CAP)
    active = net.active.clone()
    firing = net.firing.clone()
    err_sorted, order = torch.sort(
        torch.where(active, error, -torch.inf), descending=True,
        stable=True)
    q = order[:K_CAP]
    if fault == "second_worst":
        q = torch.cat([q[1:], q[:1]])
    q_nb = nbr[q]                                              # (k, K)
    q_nb_err = torch.where(q_nb >= 0, error[q_nb.clamp(0, C - 1).long()],
                           -torch.inf)
    f = torch.gather(q_nb, 1, q_nb_err.argmax(1)[:, None])[:, 0]
    take = (torch.arange(K_CAP, device=dev) < n_ins) & (f >= 0)
    if n_ins:
        top = err_sorted[:n_ins + 1]
        tie |= bool(_near(top[:-1], top[1:]).any())
        two = torch.topk(q_nb_err, 2, dim=1).values
        tie |= bool(_near(two[:, 0], two[:, 1])[take].any())
    rank = torch.cumsum(take.long(), 0) - 1
    n_free = C - int(net.n_active)
    fits = take & (rank < n_free)
    free_order = torch.argsort(active.to(torch.int32), stable=True)
    new_id = torch.where(fits, free_order[rank.clamp(0, C - 1)], -1)
    nid, qf, ff = new_id[fits], q[fits], f[fits].long()
    w[nid] = 0.5 * (w[qf] + w[ff])
    active[nid] = True
    firing[nid] = 1.0
    for unit in torch.cat([qf, ff]).tolist():
        error[unit] = error[unit] * p.gng_alpha
    error[nid] = p.gng_alpha * error[qf]
    nid32 = new_id.to(torch.int32)
    q32, f32 = q.to(torch.int32), f.to(torch.int32)
    nbr, age, d3 = ref.insert_edges(nbr, age, torch.cat([nid32, nid32]),
                                    torch.cat([q32, f32]),
                                    torch.cat([fits, fits]))
    nbr, age = ref.remove_edges(nbr, age, q32, f32, fits)
    decay = torch.tensor(1.0 - p.gng_beta, dtype=torch.float32, device=dev)
    error = error * torch.pow(decay, torch.tensor(
        float(n_sel), dtype=torch.float32, device=dev))

    # edge expiry; no unit is pruned (departure 7)
    expired = (nbr >= 0) & (age > p.age_max)
    nbr = torch.where(expired, ref.NO_NBR, nbr)
    age = torch.where(expired, 0.0, age)

    out = Net(w=w, active=active, nbr=nbr, age=age, error=error,
              firing=firing, threshold=net.threshold.clone(),
              topo_state=net.topo_state.clone(),
              inconsistent_for=net.inconsistent_for.clone(),
              n_active=active.sum(), signal_count=net.signal_count + m,
              discarded=net.discarded + (m - n_sel),
              dropped_edges=net.dropped_edges + d1 + d3,
              dropped_units=net.dropped_units + int((take & ~fits).sum()))
    return out, tie
