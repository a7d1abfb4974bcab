"""Deterministic fault injection for the port's GSON stack.

The port's counterpart of ``repro.gson.faults``. Failures are simulated,
but each injector fires inside the real code path the corresponding
production failure would hit, and every recovery mechanism under test is
the one a deployment runs:

* **crash mid-checkpoint** — :func:`checkpoint_crash` arms the checkpoint
  manager's pre-publish hook (``repro_torch.checkpoint.manager.
  _PRE_PUBLISH_HOOK``): the writer dies after the fsynced ``.tmp``
  payload but before the atomic rename, leaving the exact orphan a real
  crash leaves. Recovery: ``latest(gc_orphans=True)`` and the validated
  ``restore`` fallback.
* **poisoned network state** — :func:`poison_network` writes NaNs (or a
  topology-invariant violation) into one network of a live fleet, in the
  cohort's tensors on their own device. Recovery: the health screen
  quarantines it (``repro_torch.gson.fleet.Cohort._screen``) while its
  wave-mates keep running.
* **sampler failures** — :class:`FaultySampler` raises or stalls for its
  first N uses, before any generator state is consumed. Recovery: the
  serving layer's retry with backoff from the job's last checkpoint.
* **backend failure** — :func:`lowering_failure_backend` raises at its
  first call, like a kernel that cannot be built or launched. The port
  has no reference fallback: the run raises, and a served job goes
  ``failed`` with ``advance_error`` once its retries are spent.
* **device loss** — a ``device_loss`` schedule entry retires every live
  fleet wave of a :class:`~repro_torch.serving.engine.ReconstructionServer`,
  whose jobs retry from checkpoint free of charge, on the server's mesh
  shrunk to the event's ``survivors``; ``pod<k>_down`` events of a
  ``repro_torch.ft.elastic.FailureInjector`` shrink the mesh of an
  :class:`~repro_torch.gson.elastic.ElasticFleetRunner`.

Schedules are plain dicts, so every test run is reproducible.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch.checkpoint import manager as ckpt_manager


class SimulatedCrash(RuntimeError):
    """The checkpoint writer 'died' between the fsynced ``.tmp`` write
    and the atomic rename — the only window a crash can orphan."""


class DeviceLossError(RuntimeError):
    """Simulated loss of devices mid-run."""


# ---------------------------------------------------------------------------
# crash mid-checkpoint

def arm_checkpoint_crash(times: int = 1) -> None:
    """The next ``times`` checkpoint publishes raise
    :class:`SimulatedCrash` after their payload is written (leaving the
    ``step_*.tmp`` orphan behind); later publishes succeed."""
    left = {"n": times}

    def hook(tmp_dir: str, step: int):
        if left["n"] > 0:
            left["n"] -= 1
            raise SimulatedCrash(
                f"injected crash publishing step {step} ({tmp_dir})")

    ckpt_manager._PRE_PUBLISH_HOOK = hook


def disarm_checkpoint_crash() -> None:
    ckpt_manager._PRE_PUBLISH_HOOK = None


@contextlib.contextmanager
def checkpoint_crash(times: int = 1):
    """``with checkpoint_crash(): ...`` — armed inside, disarmed after."""
    arm_checkpoint_crash(times)
    try:
        yield
    finally:
        disarm_checkpoint_crash()


# ---------------------------------------------------------------------------
# poisoned network state

def poison_network(session, i: int, kind: str = "nan") -> None:
    """Corrupt network ``i`` of a live ``FleetSession`` (started).

    ``kind="nan"`` sets unit 0's weights to NaN (a diverged update);
    ``kind="topology"`` hangs an edge off the last pool slot, which is
    inactive (an invariant no rule set can produce, and one the
    structural tail never repairs, since edge ops only rewrite rows of
    active winners, so it survives until a screen runs). Both are caught
    by the health screen. The cohort's tensors are copied on their own
    device, so no other holder of them sees the poison. Under a mesh only
    the rank that holds network ``i`` writes it (every rank may call).
    """
    if kind not in ("nan", "topology"):
        raise ValueError(f"unknown poison kind {kind!r} "
                         "(expected 'nan' or 'topology')")
    c, local = session._where[i]
    if c.shard is not None:
        rank, local = c.shard.owner(local)
        if rank != c.shard.rank:
            return
    nets = c.fstate.nets
    if kind == "nan":
        w = nets.w.clone()
        w[local, 0, :] = float("nan")
        nets = nets.replace(w=w)
    else:
        nbr = nets.nbr.clone()
        nbr[local, -1, 0] = 0            # inactive last slot grows an edge
        nets = nets.replace(nbr=nbr)
    c.fstate = c.fstate.replace(nets=nets)


# ---------------------------------------------------------------------------
# sampler failures

class FaultySampler:
    """Sampler wrapper that fails or stalls its first uses.

    The wrapped callable keeps the port's sampler contract ``f(gen, n) ->
    (n, dim)``. A use is one call: the port draws eagerly, so a run calls
    its sampler for the seed points, the probe set and every iteration's
    signals (the JAX package's sampler runs once per compiled program,
    so there a use is a trace). A failure raises before ``inner`` runs,
    so it consumes no generator state, and a retried run replays the
    signal stream of an uninjected one. ``hang_s`` sleeps on every call,
    to exercise stall detectors: keep the slice a few calls long.
    """

    def __init__(self, inner, *, fail_times: int = 0, hang_s: float = 0.0,
                 exc: type = RuntimeError):
        self.inner = inner
        self.fail_times = fail_times
        self.hang_s = hang_s
        self.exc = exc
        self.calls = 0

    def __call__(self, gen: torch.Generator, n: int) -> torch.Tensor:
        self.calls += 1
        if self.hang_s:
            time.sleep(self.hang_s)
        if self.calls <= self.fail_times:
            raise self.exc(
                f"injected sampler failure (use {self.calls} of "
                f"{self.fail_times})")
        return self.inner(gen, n)


# ---------------------------------------------------------------------------
# backend failure

def failing_find_winners(*args, **kw):
    """Raises at its first call, like a kernel that fails to build."""
    raise RuntimeError("injected kernel lowering failure")


def lowering_failure_backend():
    """A ``Backend`` whose Find Winners raises at its first call.

    Feed it to ``RunSpec(backend=...)``: the port has no reference
    fallback, so the run raises (and a served job goes ``failed``).
    """
    from repro_torch.gson.registry import Backend
    return Backend(
        "injected-broken", failing_find_winners, None,
        "injected: raises at its first call like a failed kernel build")


# ---------------------------------------------------------------------------
# schedule-driven injection for the serving engine

@dataclasses.dataclass
class GsonFaultInjector:
    """tick -> fault events for :class:`~repro_torch.serving.engine.\
ReconstructionServer`.

    ``schedule`` maps a server tick to one event dict (or a list):

    * ``{"kind": "poison", "job": jid, "poison": "nan"|"topology"}`` —
      corrupt that job's network in its live fleet wave.
    * ``{"kind": "crash_checkpoint"}`` — the next checkpoint publish
      dies mid-write (arms :func:`arm_checkpoint_crash`).
    * ``{"kind": "fail_job", "job": jid}`` — raise inside that job's
      advance (a sampler or run-loop exception surfacing to the server).
    * ``{"kind": "device_loss", "survivors": n}`` — every live fleet wave
      dies with its devices; its jobs retry from checkpoint, free of
      charge, on the server's mesh shrunk to its first ``n`` ranks (no
      mesh: the count is not used).

    Events fire once (the server pops them), so post-recovery replay of
    the same tick numbers does not re-inject.
    """

    schedule: dict = dataclasses.field(default_factory=dict)

    def events_at(self, tick: int) -> list[dict]:
        ev = self.schedule.get(tick, [])
        return [ev] if isinstance(ev, dict) else list(ev)

    def pop(self, tick: int) -> None:
        self.schedule.pop(tick, None)
