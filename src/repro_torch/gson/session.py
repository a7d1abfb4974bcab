"""Streaming, resumable run sessions.

The paper runs fixed experiments to convergence (Sec. 3); a Session is
that loop made observable and budgetable without changing a single
emitted signal:

  * **streaming** — every convergence check produces a history row that
    is appended to ``stats.history`` and yielded from :meth:`stream`,
    while the run is in flight;
  * **budgeted** — ``session.run(budget=N)`` advances at most N
    iterations and returns; ``session.resume()`` (or another ``run``
    call) continues exactly where it stopped. Every draw comes from the
    session's RNG seam (``repro_torch.rng``), which keeps its place, so
    a paused-and-resumed run produces the same network as an
    uninterrupted one.

``run(spec)`` is the one-shot convenience wrapper. Checkpointing waits
for the port of ``repro.checkpoint``.

A run stays on ``spec.device``: a CUDA run on a host without a card
raises instead of moving to the CPU, and a kernel that cannot be built
or launched raises instead of handing over to the reference.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

from repro_torch.core.gson import metrics
from repro_torch.core.gson.state import init_state
from repro_torch.gson.spec import RunSpec, resolve
from repro_torch.rng import TorchDraws


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
    time_step: float = 0.0        # wall time inside the strategy's steps
    history: list = field(default_factory=list)


def _device(spec: RunSpec) -> torch.device:
    dev = torch.device(spec.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"RunSpec.device={spec.device!r} but no CUDA device is "
            "available; pass device='cpu' to run on the host")
    return dev


class Session:
    """One (spec, seed) experiment with pause / stream.

    ``draws``: the run's RNG seam; ``None`` draws from
    ``TorchDraws(seed, spec.device, sampler)``.
    """

    def __init__(self, spec: RunSpec, draws=None, *, seed: int = 0):
        self.spec = spec
        self.device = _device(spec)
        self.strategy, self.rt = resolve(spec)
        self.rt.draws = (draws if draws is not None
                         else TorchDraws(seed, self.device, self.rt.sampler))
        self.stats = RunStats()
        self.state = None
        self.iteration = 0
        self.converged = False

    # ------------------------------------------------------------------
    @property
    def started(self) -> bool:
        return self.state is not None

    @property
    def active(self) -> bool:
        """More work to do? (not converged, limits not exhausted)"""
        if self.converged:
            return False
        if self.iteration >= self.spec.max_iterations:
            return False
        if (self.started
                and int(self.state.signal_count) >= self.spec.max_signals):
            return False
        return True

    # ------------------------------------------------------------------
    def _start(self) -> None:
        if self.started:
            return
        spec, p, draws = self.spec, self.rt.params, self.rt.draws
        seed_points = draws.seed_points(2).to(self.device)
        self.state = init_state(seed_points, capacity=spec.capacity,
                                max_deg=spec.max_deg,
                                init_threshold=p.insertion_threshold)
        if self.state.dim != spec.dim:
            raise ValueError(f"sampler draws {self.state.dim}-d points, "
                             f"RunSpec.dim is {spec.dim}")
        self.rt.probes = draws.probes(spec.n_probe).to(self.device)
        self.strategy.prepare(self.rt)

    # ------------------------------------------------------------------
    def stream(self, budget: int | None = None) -> Iterator[dict]:
        """Advance the run, yielding history rows as checks complete.

        ``budget`` bounds the iterations executed by THIS call; the
        session stays live afterwards and can be resumed.
        """
        self._start()
        spec = self.spec
        spent = 0
        t_wall = time.perf_counter()
        try:
            while self.active and (budget is None or spent < budget):
                max_iters = spec.max_iterations - self.iteration
                if budget is not None:
                    max_iters = min(max_iters, budget - spent)
                res = self.strategy.step(self.rt, self.state,
                                         self.iteration, max_iters)
                self.state = res.state
                self.iteration += res.iterations
                spent += res.iterations
                self.stats.time_step += res.seconds
                if res.done:
                    self.converged = True
                    self.stats.converged = True
                    self.stats.quantization_error = res.qe
                if res.checked:
                    row = {
                        "iteration": self.iteration,
                        "units": int(self.state.n_active),
                        "signals": int(self.state.signal_count),
                        "qe": res.qe,
                    }
                    self.stats.history.append(row)
                    yield row
        finally:
            self.stats.time_total += time.perf_counter() - t_wall
            self.stats.iterations = self.iteration

    def run(self, budget: int | None = None) -> RunStats:
        """Advance until convergence / limits, or ``budget`` iterations."""
        for _ in self.stream(budget):
            pass
        return self.stats

    def resume(self, budget: int | None = None) -> RunStats:
        """Continue a paused session."""
        return self.run(budget)

    def result(self):
        """Finalize and return ``(state, stats)``."""
        self._start()
        st = self.state
        self.stats.iterations = self.iteration
        self.stats.signals = int(st.signal_count)
        self.stats.discarded = int(st.discarded)
        self.stats.units = int(st.n_active)
        self.stats.connections = metrics.edge_count(st)
        if math.isnan(self.stats.quantization_error):
            self.stats.quantization_error = float(
                metrics.quantization_error(st, self.rt.probes))
        return st, self.stats


def run(spec: RunSpec, draws=None, *, seed: int = 0):
    """One-shot: assemble from the registries, run to termination.

    Returns ``(state, stats)``.
    """
    sess = Session(spec, draws, seed=seed)
    sess.run()
    return sess.result()
