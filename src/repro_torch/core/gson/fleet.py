"""Fleet core: B independent networks stepped by one batched program.

The PyTorch counterpart of ``repro.core.gson.fleet``. Every leaf of the
fleet's ``NetworkState`` carries a leading ``(B,)`` axis, and one
iteration of the whole fleet is one call of the batched step
(``multi.multi_signal_step``): one launch of each kernel serves every
network. ``Session`` is a one-network fleet run through these same
functions (``repro_torch.gson.session``), so network i of a fleet
equals a ``Session(spec_i, seed=seed_i)`` by construction.

  * :func:`fleet_init` — per-network seed points and probe sets, drawn
    from each network's own ``Draws`` in the order a session draws them.
  * :func:`fleet_iterate` — ONE masked multi-signal iteration for every
    network in ``mask``; the SOAM refresh on each network's own cadence.
  * :func:`fleet_scan` — one chunk of a sequential variant (``single``,
    ``indexed``) for every network in ``mask``: the variant's scan of
    m = 1 steps, signal by signal.
  * :func:`fleet_check` — the convergence predicate for masked networks;
    the host reads the whole batch's flags and QEs in one sync.
  * :func:`run_fleet_superstep` — the fused loop over a batch: up to
    ``max_steps[i]`` iterations per network, each network freezing as
    soon as it converges or spends its budget while the rest run on.

Where the JAX package carries per-network PRNG keys in the state, the
port gives each network its own RNG seam (``repro_torch.rng``): one
``Draws`` per network, seeded as that network's session would seed it. A
frozen network's ``Draws`` is not called (its rows of the signal buffer
are zeros and masked out), so its stream stays where its session would
leave it, and a fleet of networks with different samplers needs no
special case.

A *stateful* Find Winners backend (``find_winners.stateful``, the
``repro_torch.ann`` hash grid) keeps a search structure, its aux: a
NamedTuple whose tensors carry the network axis. :func:`fleet_iterate`
builds a fresh one when it is given none (every iteration of ``multi``);
:func:`run_fleet_superstep` builds it once at entry and rebuilds it, after
the convergence check, for the running networks whose counter is due on
the refresh cadence, as the JAX fleet superstep does. The aux never
outlives one call, so a snapshot needs none.

The run carry (iteration counters, convergence flags, last QEs) lives on
the host: the host drives the loop and knows each network's cadence
without reading the device. A freeze is a ``torch.where`` select of the
state leaves, issued only when the batch is split between running and
frozen networks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.gson import metrics
from repro_torch.core.gson.batch import stack, take
from repro_torch.core.gson.multi import (FindWinnersFn, UpdatePhaseFn,
                                         multi_signal_step,
                                         refresh_topology, soam_converged)
from repro_torch.core.gson.state import (FIELDS, NO_NBR, GSONParams,
                                         NetworkState, init_fleet)
from repro_torch.core.gson.superstep import (SuperstepConfig,
                                             device_m_schedule)
from repro_torch.utils.timing import span


@dataclass
class FleetState:
    """B stacked networks plus the per-network run carry (host side)."""

    nets: NetworkState        # every leaf (B, ...), on the device
    iteration: np.ndarray     # (B,) int64 global iteration counters
    converged: np.ndarray     # (B,) bool, last evaluated predicate
    qe: np.ndarray            # (B,) float32 last checked QE (nan = never)

    @property
    def batch(self) -> int:
        return len(self.iteration)

    def network(self, i: int) -> NetworkState:
        """The i-th network as an unbatched ``NetworkState`` (views)."""
        return self.nets.network(i)

    def replace(self, **kw) -> "FleetState":
        return dataclasses.replace(self, **kw)


def _device_mask(mask: np.ndarray, device) -> torch.Tensor:
    """A host bool mask on ``device``, copied without a sync (pinned
    memory) so the host keeps queueing work."""
    t = torch.from_numpy(np.ascontiguousarray(mask))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _select_nets(mask: np.ndarray, new: NetworkState,
                 old: NetworkState) -> NetworkState:
    """``new`` where ``mask`` (B,) else ``old``, leaf-wise; no device op
    when the mask is all True or all False."""
    if mask.all():
        return new
    if not mask.any():
        return old
    m = _device_mask(mask, new.device)

    def pick(f):
        a = getattr(new, f)
        return torch.where(m.view(-1, *[1] * (a.dim() - 1)), a,
                           getattr(old, f))
    return NetworkState(**{f: pick(f) for f in FIELDS})


def _select_aux(mask: np.ndarray, new, old):
    """A stateful backend's aux: ``new`` where ``mask`` (B,) else
    ``old``, tensor by tensor; its static fields are ``new``'s."""
    if mask.all():
        return new
    if not mask.any():
        return old
    m = None
    out = []
    for a, b in zip(new, old):
        if isinstance(a, torch.Tensor):
            if m is None:
                m = _device_mask(mask, a.device)
            a = torch.where(m.view(-1, *[1] * (a.dim() - 1)), a, b)
        out.append(a)
    return type(new)(*out)


def select_fleet(mask: np.ndarray, new: FleetState,
                 old: FleetState) -> FleetState:
    """``new`` where ``mask`` else ``old`` — the freeze that keeps
    converged, out-of-budget or quarantined networks in place while the
    rest of the batch advances."""
    return FleetState(
        nets=_select_nets(mask, new.nets, old.nets),
        iteration=np.where(mask, new.iteration, old.iteration),
        converged=np.where(mask, new.converged, old.converged),
        qe=np.where(mask, new.qe, old.qe))


def pad_fleet(fstate: FleetState, pad: int) -> FleetState:
    """Append ``pad`` placeholder networks (copies of slot 0, marked
    converged), e.g. so a batch divides a device mesh. Every loop
    freezes them: a converged network is never stepped."""
    if pad <= 0:
        return fstate

    def padded(x):
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
        return torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
    out = FleetState(nets=fstate.nets.map(padded),
                     iteration=padded(fstate.iteration),
                     converged=padded(fstate.converged),
                     qe=padded(fstate.qe))
    out.converged[fstate.batch:] = True
    return out


# ---------------------------------------------------------------------------
# Device programs


def fleet_init(draws: list, *, capacity: int, dim: int, max_deg: int,
               n_probe: int, init_threshold: float, device,
               n_seed: int = 2):
    """Fresh ``(FleetState, probes (B, n_probe, dim))`` from one ``Draws``
    per network. Each network draws its seed points, then its probes —
    the order of ``Session._start`` — so a fleet network and a same-seed
    session start bit-identically."""
    device = torch.device(device)
    seed_points = stack([d.seed_points(n_seed).to(device) for d in draws])
    if seed_points.shape[-1] != dim:
        raise ValueError(f"sampler draws {seed_points.shape[-1]}-d points, "
                         f"RunSpec.dim is {dim}")
    nets = init_fleet(seed_points, capacity=capacity, max_deg=max_deg,
                      init_threshold=init_threshold)
    probes = stack([d.probes(n_probe).to(device) for d in draws])
    B = len(draws)
    return FleetState(nets=nets, iteration=np.zeros(B, np.int64),
                      converged=np.zeros(B, bool),
                      qe=np.full(B, np.nan, np.float32)), probes


def fleet_iterate(
    fstate: FleetState,
    mask: np.ndarray,
    draws: list,
    *,
    params: GSONParams,
    cfg: SuperstepConfig,
    find_winners: FindWinnersFn | None = None,
    update_phase: UpdatePhaseFn | None = None,
    fw_aux=None,
) -> FleetState:
    """One masked multi-signal iteration for every network in ``mask``.

    Each running network draws a static ``(max_parallel, dim)`` signal
    buffer and its lock priorities from its own ``Draws``; the batched
    step masks in its first ``m_t`` rows (the device m-schedule); SOAM
    refreshes the ladder of each network whose counter *before* the
    increment is a multiple of ``refresh_every`` (skipped when none is
    due). Networks outside ``mask`` draw nothing and are frozen (state
    and counter unchanged). ``fw_aux``: the batched aux of a stateful
    ``find_winners``; ``None`` builds a fresh one.
    """
    nets = fstate.nets
    dev = nets.device
    M = cfg.max_parallel
    with span("gson.draws"):
        sig, prio = [], []
        idle_sig = idle_prio = None
        for d, run in zip(draws, mask):
            if run:
                sig.append(d.signals(M).to(dev))
                prio.append(d.lock_priorities(M).to(dev))
                continue
            if idle_sig is None:
                idle_sig = torch.zeros((M, nets.dim), device=dev)
                idle_prio = torch.zeros((M,), dtype=torch.int32, device=dev)
            sig.append(idle_sig)
            prio.append(idle_prio)
        sig, prio = stack(sig), stack(prio)
    m_t = device_m_schedule(nets.n_active, cfg)
    smask = torch.arange(M, device=dev) < m_t[:, None]
    if not mask.all():
        smask = smask & _device_mask(mask, dev)[:, None]
    if getattr(find_winners, "stateful", False) and fw_aux is None:
        fw_aux = find_winners.build(nets.w, nets.active)
    nets = multi_signal_step(
        nets, sig, params, prio, refresh_states=False,
        find_winners=find_winners, signal_mask=smask,
        update_phase=update_phase, fw_aux=fw_aux)
    if params.model == "soam":
        due = mask & (fstate.iteration % cfg.refresh_every == 0)
        if due.any():
            nets = _select_nets(due, refresh_topology(nets, params), nets)
    new = fstate.replace(nets=nets, iteration=fstate.iteration + 1)
    return select_fleet(mask, new, fstate)


def fleet_scan(
    fstate: FleetState,
    mask: np.ndarray,
    draws: list,
    *,
    n: int,
    scan,
) -> FleetState:
    """One chunk of a sequential variant for every network in ``mask``.

    Each running network draws ``n`` signals (the chunk) from its own
    ``Draws``; ``scan(nets, signals (B, n, dim)) -> nets`` takes them one
    at a time (``single.single_signal_scan``, ``ann.indexed_scan``). The
    iteration counter counts chunks. Networks outside ``mask`` draw
    nothing and are frozen.
    """
    nets = fstate.nets
    dev = nets.device
    idle = torch.zeros((n, nets.dim), device=dev)
    sig = stack([d.signals(n).to(dev) if run else idle
                 for d, run in zip(draws, mask)])
    nets = scan(nets, sig)
    new = fstate.replace(nets=nets, iteration=fstate.iteration + 1)
    return select_fleet(mask, new, fstate)


def convergence_check(nets: NetworkState, probes: torch.Tensor, *,
                      params: GSONParams, mode: str, qe_threshold: float,
                      mask: np.ndarray | None = None):
    """The convergence predicate on the device: ``(nets, done, qe)``.

    "topology": recompute the state ladder (the networks in ``mask``, or
    all, keep the fresh ladder) and apply SOAM's all-disk/patch
    criterion, with QE against the probes beside it; "qe": quantization
    error against each network's probe set under ``qe_threshold``.
    """
    if mode == "topology":
        fresh = refresh_topology(nets, params)
        nets = fresh if mask is None else _select_nets(mask, fresh, nets)
        return (nets, soam_converged(nets),
                metrics.quantization_error(nets, probes))
    done, qe = metrics.qe_convergence(nets, probes, qe_threshold)
    return nets, done, qe


def fleet_check(fstate: FleetState, probes: torch.Tensor, mask: np.ndarray,
                *, params: GSONParams, cfg: SuperstepConfig) -> FleetState:
    """Evaluate the convergence predicate (``cfg.convergence``) for every
    network in ``mask``; the host reads the flags and QEs of the whole
    batch in one sync."""
    mode = cfg.convergence or ("topology" if params.model == "soam"
                               else "qe")
    with span("gson.check"):
        nets, done, qe = convergence_check(
            fstate.nets, probes, params=params, mode=mode,
            qe_threshold=cfg.qe_threshold, mask=mask)
        flags = torch.stack([done.to(torch.float64), qe.to(torch.float64)])
        with span("gson.wait"):
            host = flags.cpu().numpy()
    return fstate.replace(
        nets=nets,
        converged=np.where(mask, host[0] > 0, fstate.converged),
        qe=np.where(mask, host[1].astype(np.float32), fstate.qe))


def run_fleet_superstep(
    fstate: FleetState,
    probes: torch.Tensor,
    max_steps: np.ndarray,
    draws: list,
    *,
    params: GSONParams,
    cfg: SuperstepConfig,
    find_winners: FindWinnersFn | None = None,
    update_phase: UpdatePhaseFn | None = None,
):
    """Up to ``max_steps[i]`` fused iterations per network.

    Every loop turn advances all still-running networks by one masked
    iteration and evaluates the cadenced convergence check (on each
    network's counter *after* the increment); a network freezes as soon
    as it converges or spends its own budget, and the loop runs until the
    whole batch is frozen. Returns ``(fstate, steps)`` with ``steps[i]``
    the iterations network i executed in this call.

    A stateful ``find_winners`` gets its aux built once at entry and
    rebuilt, after the check, for the running networks whose counter
    (after the increment) is a multiple of ``cfg.refresh_every``.
    """
    steps = np.zeros(fstate.batch, np.int64)
    stateful = getattr(find_winners, "stateful", False)
    aux = (find_winners.build(fstate.nets.w, fstate.nets.active)
           if stateful else None)
    while True:
        running = ~fstate.converged & (steps < max_steps)
        if not running.any():
            return fstate, steps
        fstate = fleet_iterate(fstate, running, draws, params=params,
                               cfg=cfg, find_winners=find_winners,
                               update_phase=update_phase, fw_aux=aux)
        steps += running
        check = running & (fstate.iteration % cfg.check_every == 0)
        if check.any():
            fstate = fleet_check(fstate, probes, check, params=params,
                                 cfg=cfg)
        if stateful:
            due = running & (fstate.iteration % cfg.refresh_every == 0)
            if due.any():
                nets = fstate.nets
                aux = _select_aux(due, find_winners.build(nets.w,
                                                          nets.active), aux)


def fleet_health(nets: NetworkState) -> torch.Tensor:
    """(B,) bool on the device — True where a network passes the cheap
    health screen: finite weights, errors, firing counters, thresholds
    and ages of active units, and the topology invariants (neighbor ids
    in range and not self, edges only between active units, ``n_active``
    equal to the active count). Read-only: quarantine is the caller
    freezing the network, as it freezes a converged one."""
    act = nets.active
    col = act[..., None]

    def finite(x, m):
        return torch.isfinite(torch.where(m, x, 0.0)).flatten(1).all(-1)

    ok = (finite(nets.w, col) & finite(nets.error, act)
          & finite(nets.firing, act) & finite(nets.threshold, act)
          & finite(nets.age, col))
    C = nets.capacity
    nbr = nets.nbr
    ids = torch.arange(C, device=nbr.device, dtype=nbr.dtype)[:, None]
    has = nbr >= 0
    linked = take(act, nbr.clamp(0, C - 1).long()) & col
    ok = ok & ((nbr >= NO_NBR) & (nbr < C) & (nbr != ids)
               & torch.where(has, linked, True)).flatten(1).all(-1)
    return ok & (nets.n_active == act.sum(dim=-1, dtype=torch.int32))
