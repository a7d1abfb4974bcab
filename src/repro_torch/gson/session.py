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
    uninterrupted one;
  * **restartable** — :meth:`checkpoint` snapshots the state, the probe
    set, the RNG seam's position (``Draws.state_dict``) and the progress
    counters through ``repro_torch.checkpoint.manager``'s atomic format,
    and :meth:`Session.restore` rebuilds a live session from the newest
    (or any) snapshot, which continues the exact same rows.

A Session is the one-network :class:`~repro_torch.gson.fleet.FleetSession`:
one driver (``Cohort.tick``) runs sessions and fleets alike, which is
what makes network i of a fleet equal ``Session(spec_i, seed=seed_i)``.
Its snapshot is a one-network fleet snapshot, so a network taken out of a
fleet with ``FleetSession.network_snapshot`` restores as a Session.

``run(spec)`` is the one-shot convenience wrapper.

A run stays on ``spec.device``: a CUDA run on a host without a card
raises instead of moving to the CPU, and a kernel that cannot be built
or launched raises instead of handing over to the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.gson.fleet import (FleetSession, FleetSpec,
                                   HistoryCallback, RunStats)
from repro_torch.gson.spec import RunSpec

__all__ = ["RunStats", "Session", "run"]


class Session(FleetSession):
    """One (spec, seed) experiment with pause / stream / checkpoint.

    ``draws``: the run's RNG seam; ``None`` draws from
    ``TorchDraws(seed, spec.device, sampler)``. ``on_history``: called
    with every history row as it is emitted (``add_callback`` adds
    more). ``checkpoint_dir``: where
    :meth:`checkpoint` writes (every ``checkpoint_every`` iterations of
    :meth:`stream` when that is > 0), keeping the newest ``keep``.
    """

    def __init__(self, spec: RunSpec, draws=None, *, seed: int = 0,
                 on_history: HistoryCallback | None = None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, keep: int = 3):
        super().__init__(FleetSpec((spec,), (seed,)),
                         draws=None if draws is None else [draws],
                         on_history=on_history,
                         checkpoint_dir=checkpoint_dir,
                         checkpoint_every=checkpoint_every, keep=keep)
        self.spec = spec

    @staticmethod
    def _check_runnable(strategy) -> None:
        # one network needs no batched program, only a tick mode of
        # Cohort.tick: the sequential baseline runs here
        if getattr(strategy, "fleet_mode", None) is None:
            raise ValueError(
                f"variant {strategy.name!r} is not fleet-capable and has no "
                "tick mode (fleet_mode, fleet_cfg) for a Session")

    @property
    def stats(self) -> RunStats:
        return self._stats[0]

    @property
    def rt(self):
        """The run's resolved ``Runtime``, with its probe set."""
        self._start()
        c = self.cohorts[0]
        return dataclasses.replace(c.rts[0], probes=c.probes[0])

    @property
    def state(self):
        """The current ``NetworkState`` (``None`` before the start)."""
        return self.network(0) if self.started else None

    @property
    def probes(self) -> torch.Tensor:
        """The probe set the convergence check measures QE against."""
        self._start()
        return self.cohorts[0].probes[0]

    @property
    def iteration(self) -> int:
        return int(self.iterations[0])

    @property
    def converged(self) -> bool:
        return bool(self._gather("converged", bool)[0])

    def _row(self, c, local: int) -> dict:
        row = super()._row(c, local)
        del row["network"]
        return row

    def result(self):
        """Finalize and return ``(state, stats)``."""
        return super().result(0)

    @classmethod
    def restore(cls, spec: RunSpec, checkpoint_dir: str,
                step: int | None = None, draws=None, **kw) -> "Session":
        """Rebuild a live session from a snapshot directory.

        The snapshot carries the state, the probe set, the RNG seam's
        position and the checkpoint cadence, so the restored session
        continues the exact rows of the original run and keeps
        snapshotting (an explicit ``checkpoint_every=`` overrides the
        saved cadence). ``draws``: a seam of the original run's kind
        (``None``: ``TorchDraws``), whose position is overwritten.
        ``on_history`` (through ``kw``) receives the rows the restored
        session emits from here on.
        """
        sess = cls(spec, draws, checkpoint_dir=checkpoint_dir, **kw)
        sess._load(step, "checkpoint_every" in kw)
        return sess


def run(spec: RunSpec, draws=None, *, seed: int = 0):
    """One-shot: assemble from the registries, run to termination.

    Returns ``(state, stats)``.
    """
    sess = Session(spec, draws, seed=seed)
    sess.run()
    return sess.result()
