"""Fleet API: many independent reconstructions as one batched program.

The port's counterpart of ``repro.gson.fleet``. A :class:`FleetSpec`
declares B runs — one ``RunSpec`` + seed per network. :class:`FleetSession`
stacks them into batched :class:`~repro_torch.core.gson.fleet.FleetState`s
and drives all B networks through the fleet core
(``repro_torch.core.gson.fleet``), one launch of each kernel per
iteration for the whole batch:

  * **cohorts** — networks whose specs agree on everything that shapes
    the program (variant, model params, variant config, backend, pool
    geometry, check cadence, device) step together as one *cohort*;
    samplers, seeds and per-network iteration/signal budgets may differ
    within a cohort. A fleet of mixed shapes makes several cohorts.
  * **per-network convergence** — converged networks (and networks whose
    budgets are spent) freeze in place, so the batch shape stays static
    while stragglers keep running.
  * **fleet ≡ session** — ``Session`` is the one-network
    ``FleetSession`` (``repro_torch.gson.session``): the budget, cadence
    and row rules live in :meth:`Cohort.tick` alone, so network i of a
    fleet equals a ``Session(spec_i, seed=seed_i)`` run. Each network
    draws from its own ``TorchDraws``, seeded as that session's.
  * **health screen** — poisoned networks (non-finite state, broken
    topology invariants) are quarantined with a structured ``faults``
    record; their cohort-mates run on undisturbed. The screen runs
    before every ``health_every``-th superstep ("device" strategies) or
    on the check cadence ("host" and "scan" strategies);
    ``health_every=0`` turns it off.

``FleetSession`` carries the ``Session`` contract: streaming history
rows (tagged with their ``network`` index), budgeted ``run(budget)`` /
``resume()``, and atomic ``checkpoint()`` / ``FleetSession.restore`` of
the whole stacked fleet through ``repro_torch.checkpoint.manager``.

A ``FleetSpec`` may carry a :class:`~repro_torch.gson.spec.MeshSpec`
(``axis="network"``): every rank of its ``torch.distributed`` group runs
this same driver, and each holds a contiguous slice of every cohort's
networks, stepped by the fleet core with no collective per iteration
(``repro_torch.core.gson.distributed``). Cohorts whose batch the ranks do
not divide are padded with frozen placeholder networks. ``Cohort.tick``
gathers one small array per tick, so every rank's host mirrors (counters,
flags, QEs, counts) describe all B networks alike, and every decision of
the loop is taken the same way on every rank. A fault that one rank
raises on its own travels in that gather too: every rank raises the same
``RankFault``, and the networks, now out of step, are restored from a
checkpoint. Reads of a network's state
(``network``, ``result``, ``results``, ``network_snapshot``) and
``checkpoint`` are collective: all ranks make them, in the same order.
Checkpoints store only the real networks, logical and unsharded (rank 0
writes after a gather, the others wait at a barrier), so a snapshot
taken on 4 ranks restores onto 2, 3 or no mesh at all.

Not ported: the JAX package's reference fallback after a failed first
step — a kernel that cannot run raises.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.gson import distributed as dist_core
from repro_torch.core.gson import fleet as fleet_core
from repro_torch.core.gson import metrics
from repro_torch.gson.spec import MeshSpec, RunSpec, resolve
from repro_torch.gson.variants import convergence_mode
from repro_torch.rng import TorchDraws
from repro_torch.utils.timing import span

HistoryCallback = Callable[[dict], None]

_BIG = np.int64(1) << 60


@dataclass
class RunStats:
    """Aggregate run statistics (one row of the paper's tables)."""

    iterations: int = 0
    signals: int = 0
    discarded: int = 0
    units: int = 0
    connections: int = 0
    converged: bool = False
    quantization_error: float = float("nan")
    time_total: float = 0.0       # wall time inside stream()
    time_step: float = 0.0        # wall time inside the cohort's ticks
    history: list = field(default_factory=list)


def _device(spec: RunSpec) -> torch.device:
    """The run's device: ``"cuda"`` is ``cuda:{LOCAL_RANK}`` (0 without
    the variable), an indexed name is taken as it is; a card that is not
    there raises."""
    dev = torch.device(spec.device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"RunSpec.device={spec.device!r} but no CUDA device is "
            "available; pass device='cpu' to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"RunSpec.device={spec.device!r} is {dev}, but this host has "
            f"{torch.cuda.device_count()} CUDA devices; name one outright "
            "(device='cuda:0') to put several ranks on one card")
    return dev


@dataclass(frozen=True)
class FleetSpec:
    """B runs: one ``RunSpec`` + seed per network.

    ``mesh`` (optional, ``MeshSpec(axis="network")``) shards every
    cohort's leading B axis across the ranks of a ``torch.distributed``
    group: each rank owns its own subset of whole networks, no collective
    per iteration.
    """

    specs: tuple[RunSpec, ...]
    seeds: tuple[int, ...]
    mesh: MeshSpec | None = None

    def __post_init__(self):
        if not self.specs:
            raise ValueError("a fleet needs at least one RunSpec")
        if len(self.specs) != len(self.seeds):
            raise ValueError(
                f"{len(self.specs)} specs vs {len(self.seeds)} seeds — "
                "one seed per network")
        if self.mesh is not None:
            if self.mesh.axis != "network":
                raise ValueError(
                    "FleetSpec.mesh shards the fleet's network axis "
                    "(MeshSpec(axis='network')); to shard one network's "
                    "signal batch put the MeshSpec on its RunSpec instead")
            if any(s.mesh is not None for s in self.specs):
                raise ValueError(
                    "a network-sharded fleet cannot also shard member "
                    "signal axes; drop either FleetSpec.mesh or the member "
                    "RunSpec.mesh")

    @classmethod
    def broadcast(cls, spec: RunSpec, seeds: Sequence[int] | None = None,
                  *, samplers: Sequence | None = None,
                  count: int | None = None,
                  mesh: MeshSpec | None = None) -> "FleetSpec":
        """One spec over many seeds and/or samplers.

        ``samplers`` (names or objects) swap the sampler axis per network
        — same pool shape, so the whole fleet stays one cohort. With only
        ``count``, seeds default to ``range(count)``.
        """
        if seeds is None:
            n = (count if count is not None
                 else len(samplers) if samplers is not None else 1)
            seeds = range(n)
        seeds = tuple(int(s) for s in seeds)
        if samplers is None:
            specs = tuple(spec for _ in seeds)
        else:
            samplers = tuple(samplers)
            if len(samplers) != len(seeds):
                raise ValueError(
                    f"{len(samplers)} samplers vs {len(seeds)} seeds")
            specs = tuple(spec.replace(sampler=s) for s in samplers)
        return cls(specs, seeds, mesh)

    @property
    def batch(self) -> int:
        return len(self.specs)


def _cohort_key(spec: RunSpec, strategy, rt):
    """Everything that shapes the batched program. Samplers, seeds and
    run limits (max_iterations / max_signals) are per-network and not
    part of the key; ``spec.mesh`` (signal-axis sharding) is."""
    return (strategy.name, rt.params, rt.vcfg, rt.find_winners,
            rt.update_phase, spec.mesh, spec.capacity, spec.dim,
            spec.max_deg, spec.check_every, spec.qe_threshold, spec.n_probe,
            str(_device(spec)))


class Cohort:
    """The networks of one batched program (same static shape), and the
    one driver of the loop: every budget, cadence and row rule of a run
    is in :meth:`tick`.

    With ``mesh`` (a network-axis :class:`MeshSpec`) this rank holds only
    its slice of the networks (``shard``, padded with ``pad`` frozen
    placeholders so every rank holds as many), steps them with the fleet
    core's programs on that slice, and :meth:`_read_counts` gathers every
    rank's counters once per tick. The host mirrors (``iterations``,
    ``converged``, ``qe``, ``units``, ``signals``, ``quarantined``) always
    describe the ``batch`` real networks, on every rank.
    """

    def __init__(self, rows, draws=None, health_every: int = 1,
                 mesh: MeshSpec | None = None):
        # rows: [(global_index, spec, seed, strategy, rt), ...]
        self.members = [r[0] for r in rows]
        self.specs = [r[1] for r in rows]
        self.seeds = [r[2] for r in rows]
        self.strategy = rows[0][3]
        rts = [r[4] for r in rows]
        rt0 = rts[0]
        self.spec = self.specs[0]          # shape-defining spec
        self.device = _device(self.spec)
        self.rts = rts
        self.params = rt0.params
        self.find_winners = rt0.find_winners
        self.update_phase = rt0.update_phase
        self.cfg = dataclasses.replace(
            self.strategy.fleet_cfg(self.spec, rt0.params, rt0.vcfg),
            convergence=convergence_mode(rt0.params))
        self.scan = (self.strategy.scan(rt0.params, self.cfg, rt0.vcfg,
                                        rt0.find_winners)
                     if self.strategy.fleet_mode == "scan" else None)
        B = len(rows)
        self.mesh = mesh
        self.shard = (dist_core.FleetShard(mesh.build(), B)
                      if mesh is not None else None)
        if self.shard is None:
            self.pad = 0
            mine = range(B)
            self._iterate = fleet_core.fleet_iterate
            self._check = fleet_core.fleet_check
            self._superstep = fleet_core.run_fleet_superstep
            self._health = fleet_core.fleet_health
        elif self.shard.member:
            self.pad = self.shard.pad
            lo = self.shard.lo
            mine = range(lo, lo + self.shard.per_rank)
            (self._iterate, self._check,
             self._superstep) = dist_core.make_sharded_fleet_programs(
                self.shard)
            self._health = dist_core.make_sharded_fleet_health(self.shard)
        else:                       # outside the group: holds nothing
            self.pad, mine = 0, range(0)
        # one RNG seam per network this rank holds; a placeholder draws
        # (only its seed points and probes) as network 0 would
        self.draws = [
            (draws[i] if draws is not None
             else TorchDraws(self.seeds[i], self.device, rts[i].sampler))
            if i < B else TorchDraws(self.seeds[0], self.device,
                                     rts[0].sampler)
            for i in mine]
        self.max_iterations = np.asarray(
            [s.max_iterations for s in self.specs], np.int64)
        self.max_signals = np.asarray(
            [s.max_signals for s in self.specs], np.int64)
        self.fstate: fleet_core.FleetState | None = None
        self.probes = None
        # host mirrors of the per-network run status, all B networks
        self.iterations = np.zeros(B, np.int64)
        self.converged = np.zeros(B, bool)
        self.qe = np.full(B, np.nan, np.float32)
        self.signals = np.zeros(B, np.int64)
        self.units = np.zeros(B, np.int64)
        # quarantined networks freeze exactly like converged ones;
        # ``health_every`` = 0 disables the screen
        self.health_every = health_every
        self.quarantined = np.zeros(B, bool)
        self.faults: list[dict] = []
        self._ticks = 0

    @property
    def batch(self) -> int:
        return len(self.members)

    @property
    def member(self) -> bool:
        """Does this rank hold networks of the cohort? (Always without a
        mesh.)"""
        return self.shard is None or self.shard.member

    def _require_member(self) -> None:
        if not self.member:
            raise RuntimeError(
                f"rank {dist.get_rank()} is outside "
                f"{self.mesh}'s group of ranks and holds no networks")

    def start(self) -> None:
        if self.fstate is not None or not self.member:
            return
        error = None
        try:
            self.fstate, self.probes = fleet_core.fleet_init(
                self.draws, capacity=self.spec.capacity, dim=self.spec.dim,
                max_deg=self.spec.max_deg, n_probe=self.spec.n_probe,
                init_threshold=self.params.insertion_threshold,
                device=self.device)
            self._freeze_placeholders()
        except Exception as e:                  # noqa: BLE001
            if self.shard is None:
                raise
            error = e
        try:
            self._read_counts(error)
        except dist_core.RankFault:
            # no rank has started: a later start begins alike everywhere
            self.fstate = self.probes = None
            raise

    def _freeze_placeholders(self) -> None:
        if self.shard is not None:
            self.fstate.converged[self.shard.real:] = True

    def _read_counts(self, error: BaseException | None = None) -> None:
        """Refresh the host mirrors: units and signals in one device sync;
        under a mesh every rank's counters, flags and QEs in one gather
        (collective). The gather also carries a fault that this rank
        caught on its own (``error``): then every rank raises the same
        :class:`~repro_torch.core.gson.distributed.RankFault`."""
        fs = self.fstate
        if self.shard is None:
            counts = torch.stack([fs.nets.n_active, fs.nets.signal_count])
            with span("gson.wait"):
                counts = counts.cpu()
            self.units, self.signals = counts.numpy().astype(np.int64)
            self.iterations, self.converged, self.qe = (
                fs.iteration, fs.converged, fs.qe)
            return
        if error is None:
            counts = torch.stack([fs.nets.n_active, fs.nets.signal_count])
            with span("gson.wait"):
                counts = counts.cpu()
            local = np.stack([fs.iteration, fs.converged, fs.qe,
                              *counts.numpy()])
        else:
            local = np.zeros((5, self.shard.per_rank))
        full = self.shard.gather(local, error)
        self.iterations = full[0].astype(np.int64)
        self.converged = full[1] > 0
        self.qe = full[2].astype(np.float32)
        self.units, self.signals = full[3:].astype(np.int64)

    def active(self) -> np.ndarray:
        """(B,) which networks still have work (Session.active, batched);
        none on a rank outside the mesh."""
        return (~self.converged & ~self.quarantined
                & (self.iterations < self.max_iterations)
                & (self.signals < self.max_signals) & self.member)

    def _screen(self) -> None:
        """Health check on the device; quarantine poisoned networks.

        Non-finite state or broken topology invariants freeze the
        offending network through the same mask that freezes converged
        ones — the rest of the cohort runs on — and a structured fault
        record lands in ``self.faults``. Under a mesh each rank screens
        its own networks and the verdicts are gathered (collective).
        """
        with span("gson.screen"):
            ok = self._health(self.fstate.nets)
            with span("gson.wait"):
                healthy = ok.cpu().numpy()[:self.batch]
        bad = ~healthy & ~self.quarantined
        if not bad.any():
            return
        for local in np.nonzero(bad)[0]:
            self.faults.append({
                "network": self.members[local],
                "iteration": int(self.iterations[local]),
                "units": int(self.units[local]),
                "kind": "unhealthy_state",
                "detail": "non-finite weights/errors or topology "
                          "invariant violation",
            })
        self.quarantined |= bad

    def tick(self, budget: np.ndarray):
        """Advance each network by up to ``budget[i]`` iterations.

        "device" strategies run one fleet superstep (up to the variant's
        superstep length per network); "host" strategies run exactly one
        iteration, and "scan" strategies one chunk of single signals,
        plus the cadenced convergence check. Returns ``(steps,
        checked)`` — per-network iterations executed and which networks
        have a fresh history row. With tracing on, the tick is the span
        ``gson.tick`` (``repro_torch.utils.timing``), numbered by the
        cohort's ticks.
        """
        with span("gson.tick", tick=self._ticks):
            return self._tick(budget)

    def _tick(self, budget: np.ndarray):
        B = self.batch
        device_mode = self.strategy.fleet_mode == "device"
        act = self.active() & (budget > 0)
        idle = np.zeros(B, np.int64), np.zeros(B, bool)
        if not act.any():
            return idle
        # screen BEFORE stepping: the structural tail washes out dangling
        # edges and recounts n_active every iteration, so corruption is
        # only visible before the next step. Device ticks are whole
        # supersteps (screen every health_every-th); host and scan ticks
        # single iterations (screen on the check cadence)
        due = self.health_every and (
            self._ticks % self.health_every == 0 if device_mode else
            (act & (self.iterations % self.spec.check_every == 0)).any())
        if due:
            self._screen()
            act = self.active() & (budget > 0)
            if not act.any():
                return idle
        kw = dict(params=self.params, cfg=self.cfg,
                  find_winners=self.find_winners,
                  update_phase=self.update_phase)
        it0 = self.iterations
        steps = act.astype(np.int64)
        checked = act & ((it0 + steps) % self.spec.check_every == 0)
        error = None
        try:
            if device_mode:
                ss = self.cfg
                # bound by every budget: the superstep, the run's
                # iterations and signals (worst case max_parallel signals
                # per iteration) and this call's; an active network always
                # gets >= 1 step
                sig_left = self.max_signals - self.signals
                max_steps = np.minimum.reduce([
                    np.full(B, ss.length, np.int64),
                    self.max_iterations - it0,
                    -(-sig_left // ss.max_parallel),
                    budget])
                max_steps = np.where(act, np.maximum(max_steps, 1), 0)
                self.fstate, _ = self._superstep(
                    self.fstate, self.probes, max_steps, self.draws, **kw)
            elif self.scan is not None:
                # a sequential baseline (a Session, never sharded): one
                # chunk of m = 1 steps
                self.fstate = fleet_core.fleet_scan(
                    self.fstate, act, self.draws, n=self.cfg.max_parallel,
                    scan=self.scan)
            else:
                self.fstate = self._iterate(self.fstate, act, self.draws,
                                            **kw)
            if not device_mode and checked.any():
                self.fstate = self._check(
                    self.fstate, self.probes, checked, params=self.params,
                    cfg=self.cfg)
        except Exception as e:                  # noqa: BLE001
            # under a mesh a fault of this rank alone travels in the
            # gather, so every rank raises it; the ranks are then out of
            # step, and the caller restores from a checkpoint
            if self.shard is None:
                raise
            error = e
        self._read_counts(error)
        if device_mode:
            steps = self.iterations - it0
            checked = act & (steps > 0)   # one row per superstep
        self._ticks += 1
        return steps, checked

    # ------------------------------------------------------------------
    # reads of the networks' state (collective under a mesh)
    def tree(self, sl=slice(None)) -> dict:
        """This rank's networks ``sl`` as a checkpoint tree."""
        fs = self.fstate
        return {
            "nets": fs.nets.map(lambda x: x[sl]),
            "probes": self.probes[sl],
            "draws": [d.state_dict() for d in self.draws[sl]],
            "iteration": fs.iteration[sl],
            "converged": fs.converged[sl],
            "qe": fs.qe[sl],
        }

    def on_owner(self, local: int, fn, writer: bool = False):
        """``fn(slot)`` evaluated by the rank that holds network ``local``
        at ``slot`` of its slice, and returned on every rank; with
        ``writer`` on rank 0 of the group alone, the one that writes
        snapshots (``None`` on the others). Under a mesh collective: one
        broadcast, or one gather to rank 0 unless it holds the network."""
        self._require_member()
        if self.shard is None:
            return fn(local)
        rank, slot = self.shard.owner(local)
        out = fn(slot) if rank == self.shard.rank else None
        if not writer:
            return self.shard.broadcast(out, rank, self.device)
        if rank == 0:
            return out
        got = self.shard.gather_objects(out)
        return None if got is None else got[rank]

    def logical_tree(self) -> dict | None:
        """The checkpoint tree of the ``batch`` real networks, unsharded.
        Under a mesh it is gathered to rank 0 of the group, the one that
        writes snapshots (collective; ``None`` on the other ranks)."""
        self._require_member()
        if self.shard is None:
            return self.tree()
        trees = self.shard.gather_objects(
            self.tree(slice(0, self.shard.real)))
        return None if trees is None else dist_core.concat_trees(trees)

    def restore_target(self):
        """``(target, shardings)`` for restoring :meth:`logical_tree`'s
        layout onto this rank's slice: the logical shapes on the ``meta``
        device and host arrays, and the rank's rows of every batched leaf
        (the draws come back whole, one entry per network)."""
        B, local = self.batch, self.tree()

        def logical(x):
            if isinstance(x, np.ndarray):
                return np.empty((B, *x.shape[1:]), x.dtype)
            return torch.empty((B, *x.shape[1:]), dtype=x.dtype,
                               device="meta")
        target = {k: (v.map(logical) if k == "nets" else
                      [local["draws"][0]] * B if k == "draws" else
                      logical(v)) for k, v in local.items()}
        lo, L = self.shard.lo, self.shard.per_rank
        rows = ckpt.Rows(lo, lo + L, self.pad, self.device)
        return target, {k: None if k == "draws" else rows for k in target}

    def load(self, t: dict) -> None:
        """Continue from a restored checkpoint tree (this rank's rows of
        it under a mesh)."""
        self.fstate = fleet_core.FleetState(
            nets=t["nets"], iteration=t["iteration"],
            converged=t["converged"], qe=t["qe"])
        self.probes = t["probes"]
        states = t["draws"]
        if self.shard is not None:
            self._freeze_placeholders()
            states = states[self.shard.lo:self.shard.lo + self.shard.real]
        for d, sd in zip(self.draws, states):
            d.load_state_dict(sd)
        self._read_counts()


class FleetSession:
    """B experiments behind one ``Session``-shaped interface.

    Accepts a :class:`FleetSpec` (or a sequence of ``RunSpec``s plus
    ``seeds``); groups networks into cohorts; streams per-network history
    rows; checkpoints/restores the whole stacked fleet. ``draws``: one
    RNG seam per network, fleet order (``None``: ``TorchDraws`` seeded as
    each network's ``Session`` would be). ``health_every``: screen every
    that many supersteps (0: never; see :class:`Cohort`).

    Under a mesh every rank of its group runs the session, and every rank
    sees the same ``iterations``, ``converged``, ``quarantined``,
    ``faults``, ``stats`` and history rows (the tick's gather keeps the
    mirrors alike, so reading them is no collective). ``network``,
    ``result``, ``results``, ``network_snapshot`` and ``checkpoint`` are
    collective: every rank calls them, in the same order. A rank outside
    the mesh's group holds no networks: its ``stream`` yields nothing and
    those reads raise.
    """

    def __init__(self, fleet: FleetSpec | Sequence[RunSpec],
                 seeds: Sequence[int] | None = None, *, draws=None,
                 on_history: HistoryCallback | None = None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, keep: int = 3,
                 health_every: int = 1):
        if not isinstance(fleet, FleetSpec):
            specs = tuple(fleet)
            fleet = FleetSpec(
                specs,
                tuple(seeds) if seeds is not None
                else tuple(range(len(specs))))
        elif seeds is not None:
            raise ValueError("seeds are carried by the FleetSpec")
        if draws is not None and len(draws) != fleet.batch:
            raise ValueError(f"{len(draws)} draws for {fleet.batch} "
                             "networks — one per network")
        self.fspec = fleet
        groups: dict = {}
        for i, (spec, seed) in enumerate(zip(fleet.specs, fleet.seeds)):
            strategy, rt = resolve(spec)
            self._check_runnable(strategy)
            key = _cohort_key(spec, strategy, rt)
            groups.setdefault(key, []).append((i, spec, seed, strategy,
                                               rt))
        self.cohorts = [
            Cohort(rows,
                   None if draws is None else [draws[r[0]] for r in rows],
                   health_every, fleet.mesh)
            for rows in groups.values()]
        # the group whose rank 0 writes this session's snapshots: the
        # fleet's mesh, else a member's signal mesh (a replicated run)
        meshes = [fleet.mesh, *(s.mesh for s in fleet.specs)]
        self._group = next((m.build() for m in meshes if m is not None),
                           None)
        self._where: dict[int, tuple[Cohort, int]] = {}
        for c in self.cohorts:
            for local, i in enumerate(c.members):
                self._where[i] = (c, local)
        self._stats = [RunStats() for _ in range(fleet.batch)]
        self._callbacks: list[HistoryCallback] = []
        if on_history is not None:
            self._callbacks.append(on_history)
        self.checkpoint_every = checkpoint_every
        self._last_ckpt = -1
        self._mgr = (ckpt.CheckpointManager(checkpoint_dir, keep=keep)
                     if checkpoint_dir else None)

    @staticmethod
    def _check_runnable(strategy) -> None:
        if not getattr(strategy, "fleet_capable", False):
            raise ValueError(
                f"variant {strategy.name!r} is not fleet-capable (no "
                "batched step program); use a multi-signal variant or run "
                "it as individual Sessions")

    # ------------------------------------------------------------------
    @property
    def batch(self) -> int:
        return self.fspec.batch

    @property
    def stats(self) -> list[RunStats]:
        """Per-network statistics, fleet order."""
        return self._stats

    @property
    def started(self) -> bool:
        return self.cohorts[0].fstate is not None

    @property
    def active(self) -> bool:
        self._start()
        return any(c.active().any() for c in self.cohorts)

    def _gather(self, name: str, dtype) -> np.ndarray:
        self._start()
        out = np.zeros(self.batch, dtype)
        for c in self.cohorts:
            out[c.members] = getattr(c, name)
        return out

    @property
    def iterations(self) -> np.ndarray:
        """(B,) per-network iteration counters, fleet order (alike on
        every rank of a mesh; no collective: each tick gathers them)."""
        return self._gather("iterations", np.int64)

    @property
    def converged(self) -> np.ndarray:
        return self._gather("converged", bool)

    @property
    def quarantined(self) -> np.ndarray:
        """(B,) networks frozen by the health screen, fleet order."""
        return self._gather("quarantined", bool)

    @property
    def faults(self) -> list[dict]:
        """Structured fault records from every cohort, by network."""
        out = [f for c in self.cohorts for f in c.faults]
        out.sort(key=lambda f: f["network"])
        return out

    def active_network(self, i: int) -> bool:
        """More work to do for network i? (``Session.active``, indexed)"""
        self._start()
        c, local = self._where[i]
        return bool(c.active()[local])

    def add_callback(self, f: HistoryCallback) -> None:
        """Stream every later history row to ``f`` as well."""
        self._callbacks.append(f)

    def network(self, i: int):
        """The i-th network's current (unbatched) ``NetworkState``
        (collective under a mesh)."""
        self._start()
        c, local = self._where[i]
        return c.on_owner(local, c.fstate.network)

    # ------------------------------------------------------------------
    def _start(self) -> None:
        for c in self.cohorts:
            c.start()

    def _row(self, c: Cohort, local: int) -> dict:
        return {
            "network": c.members[local],
            "iteration": int(c.iterations[local]),
            "units": int(c.units[local]),
            "signals": int(c.signals[local]),
            "qe": float(c.qe[local]),
        }

    def _emit(self, c: Cohort, local: int) -> dict:
        row = self._row(c, local)
        st = self._stats[c.members[local]]
        st.history.append(row)
        if c.converged[local]:
            st.converged = True
            st.quantization_error = row["qe"]
        for f in self._callbacks:
            f(row)
        return row

    def stream(self, budget: int | None = None) -> Iterator[dict]:
        """Advance the fleet, yielding history rows as checks complete.

        ``budget`` bounds the iterations executed per network by THIS
        call; the session stays live afterwards and can be resumed.
        """
        self._start()
        spent = np.zeros(self.batch, np.int64)
        t_wall = time.perf_counter()
        try:
            while True:
                progressed = False
                for c in self.cohorts:
                    left = ((budget - spent[c.members])
                            if budget is not None
                            else np.full(c.batch, _BIG))
                    t0 = time.perf_counter()
                    steps, checked = c.tick(np.maximum(left, 0))
                    dt = time.perf_counter() - t0
                    if not steps.any():
                        continue
                    progressed = True
                    spent[c.members] += steps
                    # the shared program's time, attributed by work done
                    share = dt / int(steps.sum())
                    for local, m in enumerate(c.members):
                        self._stats[m].time_step += share * int(
                            steps[local])
                    for local in np.nonzero(checked)[0]:
                        yield self._emit(c, local)
                if not progressed:
                    break
                progress = int(self.iterations.max())
                if (self._mgr is not None and self.checkpoint_every > 0
                        and progress - self._last_ckpt
                        >= self.checkpoint_every):
                    self.checkpoint()
        finally:
            # one wall clock for the fleet: attributed by work done
            # (equal split when nothing ran)
            dt = time.perf_counter() - t_wall
            total = int(spent.sum())
            iters = self.iterations
            for i, st in enumerate(self._stats):
                st.time_total += (dt * int(spent[i]) / total
                                  if total else dt / self.batch)
                st.iterations = int(iters[i])

    def run(self, budget: int | None = None):
        """Advance until every network converged / exhausted its limits
        (or its per-network ``budget`` for this call)."""
        for _ in self.stream(budget):
            pass
        return self.stats

    def resume(self, budget: int | None = None):
        """Continue a paused run."""
        return self.run(budget)

    # ------------------------------------------------------------------
    def result(self, i: int):
        """Finalize network i: ``(NetworkState, RunStats)``. The QE is
        the converging check's, else that of the final state. Collective
        under a mesh."""
        self._start()
        c, local = self._where[i]
        state, probes = c.on_owner(
            local, lambda s: (c.fstate.network(s), c.probes[s]))
        st = self._stats[i]
        st.iterations = int(c.iterations[local])
        st.signals = int(state.signal_count)
        st.discarded = int(state.discarded)
        st.units = int(state.n_active)
        st.connections = metrics.edge_count(state)
        st.converged = bool(c.converged[local])
        st.quantization_error = float(
            c.qe[local] if st.converged
            else metrics.quantization_error(state, probes))
        return state, st

    def results(self) -> list:
        """All networks, fleet order: ``[(state, stats), ...]``
        (collective under a mesh)."""
        return [FleetSession.result(self, i) for i in range(self.batch)]

    # ------------------------------------------------------------------
    # checkpointing: the whole stacked fleet, one atomic snapshot. Only
    # the real networks are stored, logical and unsharded, so a snapshot
    # restores onto any mesh (the restore pads again for it)
    def _savable_tree(self) -> dict:
        return {f"cohort{ci}": c.logical_tree()
                for ci, c in enumerate(self.cohorts)}

    def network_snapshot(self, i: int) -> tuple[dict, dict]:
        """Network i as a B = 1 fleet checkpoint payload ``(tree, extra)``:
        the layout ``FleetSession(FleetSpec((spec_i,), (seed_i,)))``
        saves, so ``FleetSession.restore`` on that one-network spec
        resumes network i alone. Collective under a mesh, where the tree
        goes to rank 0 of the group alone, the one that writes snapshots
        (the other ranks get ``None`` in its place)."""
        self._start()
        c, local = self._where[i]
        tree = {"cohort0": c.on_owner(
            local, lambda s: c.tree(slice(s, s + 1)), writer=True)}
        extra = {
            "iterations": [int(c.iterations[local])],
            "converged": [bool(c.converged[local])],
            "histories": [list(self._stats[i].history)],
            "checkpoint_every": self.checkpoint_every,
        }
        return tree, extra

    def checkpoint(self, step: int | None = None) -> None:
        """Atomic snapshot via ``repro_torch.checkpoint.manager``.

        Under a mesh (the fleet's, or a member's signal mesh) it is
        collective: the networks are gathered, rank 0 of the group writes
        and the other ranks wait at a barrier, so the snapshot is
        published on every rank's return."""
        if self._mgr is None:
            raise RuntimeError(
                f"{type(self).__name__} was created without checkpoint_dir")
        self._start()
        iters = self.iterations
        step = int(iters.max()) if step is None else step
        extra = {
            "iterations": [int(x) for x in iters],
            "converged": [bool(x) for x in self._gather("converged", bool)],
            "histories": [st.history for st in self._stats],
            "checkpoint_every": self.checkpoint_every,
        }
        tree = self._savable_tree()
        try:
            if self._group is None or dist.get_rank(self._group) == 0:
                self._mgr.save(tree, step, extra)
        finally:
            if self._group is not None:
                dist_core.barrier(self._group)
        self._last_ckpt = int(iters.max())

    @classmethod
    def restore(cls, fleet: FleetSpec | Sequence[RunSpec],
                checkpoint_dir: str, step: int | None = None,
                **kw) -> "FleetSession":
        """Rebuild a live fleet from a snapshot directory.

        The snapshot holds each network's state, probe set and RNG seam
        position, so the restored fleet continues the exact rows of the
        original run and keeps snapshotting (an explicit
        ``checkpoint_every=`` overrides the saved cadence). ``draws``: one
        seam per network of the original run's kind (``None``:
        ``TorchDraws``), whose positions are overwritten. Under a mesh
        each rank restores its own slice of the logical snapshot, whatever
        mesh (or none) wrote it.
        """
        sess = cls(fleet, checkpoint_dir=checkpoint_dir, **kw)
        sess._load(step, "checkpoint_every" in kw)
        return sess

    def _load(self, step: int | None, keep_cadence: bool) -> None:
        self._start()
        if self.fspec.mesh is None:
            tree, _, extra = self._mgr.restore(self._savable_tree(), step)
        else:
            for c in self.cohorts:
                c._require_member()
            targets = [c.restore_target() for c in self.cohorts]
            tree, _, extra = self._mgr.restore(
                {f"cohort{ci}": t for ci, (t, _) in enumerate(targets)},
                step, shardings={f"cohort{ci}": sh
                                 for ci, (_, sh) in enumerate(targets)})
        for ci, c in enumerate(self.cohorts):
            c.load(tree[f"cohort{ci}"])
            for local, m in enumerate(c.members):
                st = self._stats[m]
                st.iterations = int(c.iterations[local])
                if c.converged[local]:
                    st.converged = True
                    st.quantization_error = float(c.qe[local])
        for st, hist in zip(self._stats, extra.get("histories", [])):
            st.history = list(hist)
        if not keep_cadence:
            self.checkpoint_every = int(extra.get("checkpoint_every", 0))
        self._last_ckpt = int(self.iterations.max())


def run_fleet(fleet: FleetSpec | Sequence[RunSpec],
              seeds: Sequence[int] | None = None, *,
              on_history: HistoryCallback | None = None) -> list:
    """One-shot: run every network to termination; returns
    ``[(state, stats), ...]`` in fleet order."""
    sess = FleetSession(fleet, seeds, on_history=on_history)
    sess.run()
    return sess.results()
