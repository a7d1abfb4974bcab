"""Elastic fleet recovery: device loss -> reshard-restore -> resume.

The port's counterpart of ``repro.gson.elastic``.
:class:`ElasticFleetRunner` is the GSON instance of
``repro_torch.ft.elastic.ElasticRunner``: it supervises a network-sharded
:class:`~repro_torch.gson.fleet.FleetSession`, heartbeats one "pod" per
rank of the mesh through :class:`~repro_torch.ft.elastic.PodHealth`, and
on a ``pod<k>_down`` event:

1. rebuilds the :class:`~repro_torch.gson.fleet.FleetSpec` on a mesh
   shrunk to the first ``ndev - len(dead)`` ranks (the JAX package keeps
   ``devices[:n]`` too: the loss is simulated, so which pod died does not
   pick the survivors). Building the survivors' group is collective, so
   every rank builds it, the leaving ones included, before those leave
   the loop;
2. reshard-restores the last checkpoint onto it — fleet checkpoints store
   only the logical, unsharded real networks, so a 4-rank snapshot loads
   onto 2 ranks (or 1) unchanged, and
3. resumes. Surviving networks finish bitwise equal to a run with no
   failure: signals are drawn from each network's RNG seam, whose
   position the snapshot carries, and the fixed ``tick_iters`` slicing
   keeps superstep boundaries aligned across the restart.

Every rank of the world runs the runner (SPMD); ``run`` is collective.
"""
from __future__ import annotations

import dataclasses
import time

import torch.distributed as dist

from repro_torch.ft.elastic import FailureInjector, PodHealth, downed_pods
from repro_torch.gson.faults import DeviceLossError
from repro_torch.gson.fleet import FleetSession, FleetSpec


class ElasticFleetRunner:
    """Checkpoint-restart supervision for a mesh-sharded fleet."""

    def __init__(self, fleet: FleetSpec, checkpoint_dir: str, *,
                 tick_iters: int = 25, checkpoint_every_ticks: int = 1,
                 injector: FailureInjector | None = None, keep: int = 5):
        if fleet.mesh is None:
            raise ValueError(
                "ElasticFleetRunner supervises a network-sharded fleet; "
                "give the FleetSpec a MeshSpec(axis='network')")
        self.fspec = fleet
        self.dir = checkpoint_dir
        self.tick_iters = tick_iters
        self.ckpt_every = checkpoint_every_ticks
        self.keep = keep
        self.injector = injector or FailureInjector()
        self.restarts = 0
        self.log: list[dict] = []
        self.session = FleetSession(fleet, checkpoint_dir=checkpoint_dir,
                                    keep=keep)

    @property
    def member(self) -> bool:
        """Does this rank still hold networks (is it in the mesh)?"""
        return dist.get_rank(self.fspec.mesh.build()) >= 0

    def _rebuild(self, ndev: int) -> None:
        """Survivor mesh + reshard-restore of the newest checkpoint (on
        the survivors; the group is built on every rank)."""
        mesh = dataclasses.replace(self.fspec.mesh, devices=ndev)
        self.fspec = dataclasses.replace(self.fspec, mesh=mesh)
        if not self.member:
            self.session = None
            return
        self.session = FleetSession.restore(self.fspec, self.dir,
                                            keep=self.keep)

    def run(self) -> FleetSession | None:
        """Drive the fleet to completion through any scheduled faults.

        Returns the session, or None on a rank that is (or was shrunk)
        outside the mesh and so left the loop."""
        if not self.member:
            self.session = None
            return None
        ndev = self.fspec.mesh.ndev()
        health = PodHealth(ndev)
        tick = 0
        # a fault at tick 0 needs something to restore
        self.session.checkpoint()
        while self.session.active:
            dead = downed_pods(self.injector.events_at(tick))
            if dead:
                # one-shot: replayed ticks must not re-kill the pod
                self.injector.schedule.pop(tick, None)
                for p in dead:
                    for _ in range(health.dead_after):
                        health.miss(p)
                ndev -= len(dead)
                if ndev < 1:
                    raise DeviceLossError(
                        "every device lost; nothing to restore onto")
                self.restarts += 1
                t0 = time.perf_counter()
                self._rebuild(ndev)
                dt = time.perf_counter() - t0
                self.log.append({"event": "restart", "tick": tick,
                                 "devices": ndev, "restore_s": dt})
                if self.session is None:
                    return None
                health = PodHealth(ndev)
            t0 = time.perf_counter()
            self.session.run(budget=self.tick_iters)
            dt = time.perf_counter() - t0
            for p in range(ndev):
                health.beat(p, tick, dt)
            tick += 1
            if self.ckpt_every and tick % self.ckpt_every == 0:
                self.session.checkpoint()
        self.session.checkpoint()
        return self.session
