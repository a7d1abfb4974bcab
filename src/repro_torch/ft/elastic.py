"""Fault tolerance: heartbeats, straggler weights, elastic restart.

The port's copy of ``repro.ft.elastic`` (plain Python and numpy; it
imports nothing of the JAX package). Failures are simulated, but every
recovery mechanism is the code path a multi-device deployment runs:

* **PodHealth** — heartbeat ledger. Pods report each step; a pod that
  misses ``dead_after`` consecutive beats is declared dead, one that is
  more than ``straggle_factor`` times slower than the median gets a
  reduced weight (the straggler masking of a data-parallel trainer: a
  slow pod's contribution shrinks instead of stalling the step).

* **ElasticRunner** — supervises a step loop: on a detected failure it
  (1) waits for the asynchronous checkpoint to land
  (``repro_torch.checkpoint.CheckpointManager.wait``), (2) rebuilds
  without the dead pod (the caller's ``build(n_pods, ckpt)``), (3)
  restores the checkpoint there (the manager stores logical, unsharded
  trees, so any target layout works: ``restore(..., shardings=)``), and
  (4) resumes from the exact step.

* **FailureInjector** — deterministic fault schedule for tests and
  examples: ``{step: "pod1_down"}`` etc.

``repro_torch.gson.elastic.ElasticFleetRunner`` is the GSON instance of
this loop over a network-sharded fleet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PodHealth:
    n_pods: int
    dead_after: int = 3          # missed beats before declared dead
    straggle_factor: float = 2.0

    _last_beat: dict = field(default_factory=dict)
    _durations: dict = field(default_factory=dict)
    _missed: dict = field(default_factory=dict)

    def beat(self, pod: int, step: int, duration: float):
        self._last_beat[pod] = step
        self._missed[pod] = 0
        self._durations.setdefault(pod, []).append(duration)
        if len(self._durations[pod]) > 16:
            self._durations[pod] = self._durations[pod][-16:]

    def miss(self, pod: int):
        self._missed[pod] = self._missed.get(pod, 0) + 1

    def dead(self) -> list[int]:
        return [p for p in range(self.n_pods)
                if self._missed.get(p, 0) >= self.dead_after]

    def weights(self) -> np.ndarray:
        """Per-pod psum weights in [0, 1]: dead=0, stragglers damped.

        The reference duration pools ALL pods' recent beats (a per-pod
        median-of-medians lets a straggler drag the reference up when
        the pod count is small)."""
        w = np.ones((self.n_pods,), np.float32)
        pooled = [x for d in self._durations.values() for x in d]
        med = float(np.median(pooled)) if pooled else 0.0
        for p in range(self.n_pods):
            if self._missed.get(p, 0) >= self.dead_after:
                w[p] = 0.0
                continue
            d = self._durations.get(p)
            if d and med > 0 and np.median(d) > self.straggle_factor * med:
                w[p] = med / float(np.median(d))   # proportional damping
        return w


@dataclass
class FailureInjector:
    """step -> event. Events: 'pod<k>_down', 'pod<k>_slow', 'crash'."""
    schedule: dict = field(default_factory=dict)

    def events_at(self, step: int) -> list[str]:
        ev = self.schedule.get(step, [])
        return [ev] if isinstance(ev, str) else list(ev)


def downed_pods(events: list[str]) -> list[int]:
    """Pod indices named by ``pod<k>_down`` events (any digit count)."""
    return [int(e[len("pod"):-len("_down")]) for e in events
            if e.startswith("pod") and e.endswith("_down")]


class ElasticRunner:
    """Checkpoint-restart supervision loop around a step function.

    The runner owns: health ledger, failure injection, checkpoint
    cadence, and the restart decision. The caller provides
    ``build(n_pods) -> (state, step_fn)`` and the runner re-builds on
    pod loss with the surviving pod count — mesh construction and
    resharding live inside ``build`` (see examples/fault_tolerance.py).
    """

    def __init__(self, build, ckpt_manager, n_pods: int,
                 ckpt_every: int = 10,
                 injector: FailureInjector | None = None):
        self.build = build
        self.ckpt = ckpt_manager
        self.n_pods = n_pods
        self.ckpt_every = ckpt_every
        self.injector = injector or FailureInjector()
        self.restarts = 0
        self.log: list[dict] = []

    def run(self, n_steps: int):
        health = PodHealth(self.n_pods)
        state, step_fn = self.build(self.n_pods, None)
        step = 0
        while step < n_steps:
            events = self.injector.events_at(step)
            dead = downed_pods(events)
            if dead:
                # a fault fires once: the replayed steps after restart
                # must not re-kill the same pod
                self.injector.schedule.pop(step, None)
                # pod failure: drop it, rebuild smaller, restore, resume
                for p in dead:
                    for _ in range(health.dead_after):
                        health.miss(p)
                self.n_pods -= len(dead)
                self.restarts += 1
                self.ckpt.wait()
                state, step_fn = self.build(self.n_pods, self.ckpt)
                restored = self.ckpt.latest()
                step = 0 if restored is None else restored
                self.log.append({"event": "restart", "step": step,
                                 "pods": self.n_pods})
                health = PodHealth(self.n_pods)
                continue
            t0 = time.perf_counter()
            state = step_fn(state, step, health.weights())
            dt = time.perf_counter() - t0
            for p in range(self.n_pods):
                slow = f"pod{p}_slow" in events
                health.beat(p, step, dt * (3.0 if slow else 1.0))
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(state, step)
                self.log.append({"event": "ckpt", "step": step})
        self.ckpt.wait()
        return state
