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

Not ported: the JAX package's network-axis device mesh (``FleetSpec``'s
``mesh``; ROADMAP A14) and its reference fallback after a failed first
step — a kernel that cannot run raises.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.gson import fleet as fleet_core
from repro_torch.core.gson import metrics
from repro_torch.gson.spec import RunSpec, resolve
from repro_torch.gson.variants import convergence_mode
from repro_torch.rng import TorchDraws

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
    dev = torch.device(spec.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"RunSpec.device={spec.device!r} but no CUDA device is "
            "available; pass device='cpu' to run on the host")
    return dev


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a network-axis device mesh is not ported yet (ROADMAP A14); "
            "run the fleet on one device")


@dataclass(frozen=True)
class FleetSpec:
    """B runs: one ``RunSpec`` + seed per network."""

    specs: tuple[RunSpec, ...]
    seeds: tuple[int, ...]
    mesh: None = None

    def __post_init__(self):
        _no_mesh(self.mesh)
        if not self.specs:
            raise ValueError("a fleet needs at least one RunSpec")
        if len(self.specs) != len(self.seeds):
            raise ValueError(
                f"{len(self.specs)} specs vs {len(self.seeds)} seeds — "
                "one seed per network")

    @classmethod
    def broadcast(cls, spec: RunSpec, seeds: Sequence[int] | None = None,
                  *, samplers: Sequence | None = None,
                  count: int | None = None, mesh=None) -> "FleetSpec":
        """One spec over many seeds and/or samplers.

        ``samplers`` (names or objects) swap the sampler axis per network
        — same pool shape, so the whole fleet stays one cohort. With only
        ``count``, seeds default to ``range(count)``.
        """
        _no_mesh(mesh)
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
        return cls(specs, seeds)

    @property
    def batch(self) -> int:
        return len(self.specs)


def _cohort_key(spec: RunSpec, strategy, rt):
    """Everything that shapes the batched program. Samplers, seeds and
    run limits (max_iterations / max_signals) are per-network and not
    part of the key."""
    return (strategy.name, rt.params, rt.vcfg, rt.find_winners,
            rt.update_phase, spec.capacity, spec.dim, spec.max_deg,
            spec.check_every, spec.qe_threshold, spec.n_probe,
            str(_device(spec)))


class Cohort:
    """The networks of one batched program (same static shape), and the
    one driver of the loop: every budget, cadence and row rule of a run
    is in :meth:`tick`."""

    def __init__(self, rows, draws=None, health_every: int = 1):
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
        self.draws = (list(draws) if draws is not None else [
            TorchDraws(seed, self.device, rt.sampler)
            for seed, rt in zip(self.seeds, rts)])
        B = len(rows)
        self.max_iterations = np.asarray(
            [s.max_iterations for s in self.specs], np.int64)
        self.max_signals = np.asarray(
            [s.max_signals for s in self.specs], np.int64)
        self.fstate: fleet_core.FleetState | None = None
        self.probes = None
        # host mirrors of the per-network run status
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
    def iterations(self) -> np.ndarray:
        return self.fstate.iteration

    @property
    def converged(self) -> np.ndarray:
        return self.fstate.converged

    def start(self) -> None:
        if self.fstate is not None:
            return
        self.fstate, self.probes = fleet_core.fleet_init(
            self.draws, capacity=self.spec.capacity, dim=self.spec.dim,
            max_deg=self.spec.max_deg, n_probe=self.spec.n_probe,
            init_threshold=self.params.insertion_threshold,
            device=self.device)
        self._read_counts()

    def _read_counts(self) -> None:
        """Units and signals of every network, in one sync."""
        nets = self.fstate.nets
        host = torch.stack([nets.n_active, nets.signal_count]).cpu()
        self.units, self.signals = host.numpy().astype(np.int64)

    def active(self) -> np.ndarray:
        """(B,) which networks still have work (Session.active, batched)."""
        return (~self.fstate.converged & ~self.quarantined
                & (self.fstate.iteration < self.max_iterations)
                & (self.signals < self.max_signals))

    def _screen(self) -> None:
        """Health check on the device; quarantine poisoned networks.

        Non-finite state or broken topology invariants freeze the
        offending network through the same mask that freezes converged
        ones — the rest of the cohort runs on — and a structured fault
        record lands in ``self.faults``.
        """
        healthy = fleet_core.fleet_health(self.fstate.nets).cpu().numpy()
        bad = ~healthy & ~self.quarantined
        if not bad.any():
            return
        for local in np.nonzero(bad)[0]:
            self.faults.append({
                "network": self.members[local],
                "iteration": int(self.fstate.iteration[local]),
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
        have a fresh history row.
        """
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
            (act & (self.fstate.iteration
                    % self.spec.check_every == 0)).any())
        if due:
            self._screen()
            act = self.active() & (budget > 0)
            if not act.any():
                return idle
        kw = dict(params=self.params, cfg=self.cfg,
                  find_winners=self.find_winners,
                  update_phase=self.update_phase)
        if device_mode:
            ss = self.cfg
            # bound by every budget: the superstep, the run's iterations
            # and signals (worst case max_parallel signals per iteration)
            # and this call's; an active network always gets >= 1 step
            sig_left = self.max_signals - self.signals
            max_steps = np.minimum.reduce([
                np.full(B, ss.length, np.int64),
                self.max_iterations - self.fstate.iteration,
                -(-sig_left // ss.max_parallel),
                budget])
            max_steps = np.where(act, np.maximum(max_steps, 1), 0)
            self.fstate, steps = fleet_core.run_fleet_superstep(
                self.fstate, self.probes, max_steps, self.draws, **kw)
            checked = act & (steps > 0)   # one row per superstep
        else:
            if self.scan is not None:
                # a sequential baseline: one chunk of m = 1 steps
                self.fstate = fleet_core.fleet_scan(
                    self.fstate, act, self.draws, n=self.cfg.max_parallel,
                    scan=self.scan)
            else:
                self.fstate = fleet_core.fleet_iterate(self.fstate, act,
                                                       self.draws, **kw)
            steps = act.astype(np.int64)
            checked = act & (self.fstate.iteration
                             % self.spec.check_every == 0)
            if checked.any():
                self.fstate = fleet_core.fleet_check(
                    self.fstate, self.probes, checked, params=self.params,
                    cfg=self.cfg)
        self._read_counts()
        self._ticks += 1
        return steps, checked


class FleetSession:
    """B experiments behind one ``Session``-shaped interface.

    Accepts a :class:`FleetSpec` (or a sequence of ``RunSpec``s plus
    ``seeds``); groups networks into cohorts; streams per-network history
    rows; checkpoints/restores the whole stacked fleet. ``draws``: one
    RNG seam per network, fleet order (``None``: ``TorchDraws`` seeded as
    each network's ``Session`` would be). ``health_every``: screen every
    that many supersteps (0: never; see :class:`Cohort`).
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
                   health_every)
            for rows in groups.values()]
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
        """(B,) per-network iteration counters, fleet order."""
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
        """The i-th network's current (unbatched) ``NetworkState``."""
        self._start()
        c, local = self._where[i]
        return c.fstate.network(local)

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
            "qe": float(c.fstate.qe[local]),
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
        the converging check's, else that of the final state."""
        self._start()
        c, local = self._where[i]
        state = c.fstate.network(local)
        st = self._stats[i]
        st.iterations = int(c.iterations[local])
        st.signals = int(state.signal_count)
        st.discarded = int(state.discarded)
        st.units = int(state.n_active)
        st.connections = metrics.edge_count(state)
        st.converged = bool(c.converged[local])
        st.quantization_error = float(
            c.fstate.qe[local] if st.converged
            else metrics.quantization_error(state, c.probes[local]))
        return state, st

    def results(self) -> list:
        """All networks, fleet order: ``[(state, stats), ...]``."""
        return [FleetSession.result(self, i) for i in range(self.batch)]

    # ------------------------------------------------------------------
    # checkpointing: the whole stacked fleet, one atomic snapshot
    @staticmethod
    def _cohort_tree(c: Cohort, sl=slice(None)) -> dict:
        fs = c.fstate
        return {
            "nets": fs.nets.map(lambda x: x[sl]),
            "probes": c.probes[sl],
            "draws": [d.state_dict() for d in c.draws[sl]],
            "iteration": fs.iteration[sl],
            "converged": fs.converged[sl],
            "qe": fs.qe[sl],
        }

    def _savable_tree(self) -> dict:
        return {f"cohort{ci}": self._cohort_tree(c)
                for ci, c in enumerate(self.cohorts)}

    def network_snapshot(self, i: int) -> tuple[dict, dict]:
        """Network i as a B = 1 fleet checkpoint payload ``(tree, extra)``:
        the layout ``FleetSession(FleetSpec((spec_i,), (seed_i,)))``
        saves, so ``FleetSession.restore`` on that one-network spec
        resumes network i alone."""
        self._start()
        c, local = self._where[i]
        tree = {"cohort0": self._cohort_tree(c, slice(local, local + 1))}
        extra = {
            "iterations": [int(c.iterations[local])],
            "converged": [bool(c.converged[local])],
            "histories": [list(self._stats[i].history)],
            "checkpoint_every": self.checkpoint_every,
        }
        return tree, extra

    def checkpoint(self, step: int | None = None) -> None:
        """Atomic snapshot via ``repro_torch.checkpoint.manager``."""
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
        self._mgr.save(self._savable_tree(), step, extra)
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
        ``TorchDraws``), whose positions are overwritten.
        """
        sess = cls(fleet, checkpoint_dir=checkpoint_dir, **kw)
        sess._load(step, "checkpoint_every" in kw)
        return sess

    def _load(self, step: int | None, keep_cadence: bool) -> None:
        self._start()
        tree, _, extra = self._mgr.restore(self._savable_tree(), step)
        for ci, c in enumerate(self.cohorts):
            t = tree[f"cohort{ci}"]
            c.fstate = fleet_core.FleetState(
                nets=t["nets"], iteration=t["iteration"],
                converged=t["converged"], qe=t["qe"])
            c.probes = t["probes"]
            for d, sd in zip(c.draws, t["draws"]):
                d.load_state_dict(sd)
            c._read_counts()
            for local, m in enumerate(c.members):
                st = self._stats[m]
                st.iterations = int(c.iterations[local])
                if c.converged[local]:
                    st.converged = True
                    st.quantization_error = float(c.fstate.qe[local])
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
