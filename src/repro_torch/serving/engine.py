"""Serving of the port (``repro.serving.engine``'s counterpart): the LM
engine and reconstruction serving.

``ServeEngine`` is wave-based continuous batching of LM requests: a fixed
pool of ``batch`` sequence slots shares one KV cache; queued requests are
admitted in waves, prefilled together as one batched prompt pass, and
one decode step advances every live slot per tick. Its rules are the JAX
engine's, kept on purpose: a wave's prompts are left-padded with token 0
and the pads are attended (there is no pad mask), and every slot writes
the cache at one shared position (the lockstep invariant). It runs on
its parameters' device and holds one copy of them in the compute dtype,
made once; the values are those JAX casts inside every call. Each tick
reads its sampled tokens from the device once.

With ``mesh`` (an ``LMMesh``; the parameters this rank's
``placement.Sharded`` blocks) every rank runs the engine on the same
requests (SPMD). A rank holds its rows of the wave's cache and computes
its rows of the logits; after each prefill and decode step its sampled
tokens are gathered over the cache's batch axes in one small collective,
so every rank keeps the same slots, outputs and finished list. Sampling
at a temperature draws the noise of the whole batch from ``rng`` on every
rank and takes the rank's rows of it, so the draws are the unsharded
engine's.

``ReconstructionJob`` and ``ReconstructionServer`` serve
surface-reconstruction jobs in fleet slots, one batched program per wave,
with the JAX server's scheduling and supervision rules. Every fleet wave
and solo job runs on its spec's device through the port's fleets and
sessions, so a wave on ``cuda-full`` launches the four Hopper kernels.

A fault in a wave's advance becomes a job fault, retried from the job's
last checkpoint on the same backend and device: nothing here swaps in
the reference or moves a job to the CPU, so a kernel that cannot run
fails its jobs (``failed`` with ``advance_error`` once their retries are
spent) instead of completing them another way.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt_mgr
from repro_torch.core.gson import distributed as dist_core
from repro_torch.gson import faults as gf
from repro_torch.gson.fleet import FleetSession, FleetSpec
from repro_torch.gson.session import Session
from repro_torch.gson.spec import resolve_variant
from repro_torch.models import placement
from repro_torch.models.common import cast_params
from repro_torch.models.registry import ModelBundle


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_tokens: int = 32
    out: list = field(default_factory=list)
    done: bool = False


@dataclass
class ServeConfig:
    batch: int = 8                # slot count
    max_len: int = 512
    eos_id: int = 1
    temperature: float = 0.0      # 0 = greedy


class ServeEngine:
    """``rng``: the ``torch.Generator`` that sampling at ``temperature >
    0`` draws from (by default one on the parameters' device, seeded 0).
    Its draws are not ``jax.random.categorical``'s: sampling is
    Gumbel-max over ``logits / temperature`` in f32."""

    def __init__(self, bundle: ModelBundle, params, cfg: ServeConfig,
                 mesh=None, rng: torch.Generator | None = None):
        self.mesh = placement.check_mesh(mesh)
        if mesh is not None and not isinstance(params, placement.Sharded):
            raise TypeError("on a mesh the parameters are this rank's "
                            "shards: placement.shard_params(...)")
        self.bundle = bundle
        self.params = params
        # the compute-dtype copy every call reads (the same tensors when
        # the master is already in that dtype)
        self.compute_params = cast_params(params, bundle.cfg.compute_dtype)
        self.device = params["embed"].device
        self.cfg = cfg
        self.rng = rng if rng is not None else torch.Generator(
            device=self.device).manual_seed(0)
        self.queue: list[Request] = []
        self.slots: list[Request | None] = [None] * cfg.batch
        self.finished: list[Request] = []
        self.cache = None
        self.tokens = torch.zeros((cfg.batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.decode_steps = 0
        self.prefills = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, rid: int | None = None,
               max_tokens: int = 32) -> Request:
        rid = rid if rid is not None else (
            len(self.queue) + len(self.finished)
            + sum(r is not None for r in self.slots))
        req = Request(rid, np.asarray(prompt, np.int32), max_tokens)
        self.queue.append(req)
        return req

    def _admit_wave(self):
        """Fill free slots from the queue, one batched prefill.

        Prompts are right-aligned to the wave's longest prompt by
        left-padding with token 0, so the shared cache position is the
        same for every slot (the lockstep invariant).
        """
        wave = []
        for i in range(self.cfg.batch):
            if not self.queue:
                break
            req = self.queue.pop(0)
            self.slots[i] = req
            wave.append((i, req))
        plen = max(len(r.prompt) for _, r in wave)
        b = self.cfg.batch
        toks = np.zeros((b, plen), np.int32)
        for slot, req in wave:
            toks[slot, plen - len(req.prompt):] = req.prompt
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        batch.update(self._modality_stub(b))
        self.cache, logits = self.bundle.prefill(
            self.compute_params, batch, max_len=self.cfg.max_len,
            mesh=self.mesh)
        self.prefills += 1
        nxt = self._sample(logits)
        self.tokens = nxt[:, None]
        vals = nxt.tolist()
        for slot, req in wave:
            req.out.append(vals[slot])

    def _modality_stub(self, b: int) -> dict:
        cfg = self.bundle.cfg
        if cfg.family == "encdec":
            return {"frames": torch.zeros(
                (b, cfg.encoder_ctx, cfg.d_model), dtype=torch.float32,
                device=self.device)}
        if cfg.family == "vlm":
            return {"img_embeds": torch.zeros(
                (b, cfg.n_img_tokens, cfg.d_model), dtype=torch.float32,
                device=self.device)}
        return {}

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy: ``argmax`` in the logits' own dtype (the first index
        on a tie, as ``jnp.argmax``). Else Gumbel-max from ``rng``. On a
        mesh: the whole batch's tokens, from this rank's rows (collective
        over the cache's batch axes)."""
        bat = (placement.axes_of(self.cache.spec("length")[0])
               if self.mesh is not None else ())
        if self.cfg.temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            z = logits.float() / self.cfg.temperature
            n = z.shape[0]
            e = torch.empty((n * self.mesh.size(bat) if bat else n,
                             z.shape[-1]), dtype=z.dtype, device=z.device
                            ).exponential_(generator=self.rng)
            e = e.narrow(0, self.mesh.index(bat) * n, n) if bat else e
            nxt = torch.argmax(z - torch.log(e), dim=-1).to(torch.int32)
        if bat:
            with torch.no_grad():
                nxt = placement.gather(nxt, self.mesh, bat, 0)
        return nxt

    # ------------------------------------------------------------------
    def step(self):
        """One engine tick: admit a wave when idle, else decode."""
        live = [r for r in self.slots if r is not None and not r.done]
        if not live:
            self._drain()
            if self.queue:
                self._admit_wave()
            return
        self.cache, logits = self.bundle.decode_step(
            self.compute_params, self.cache, self.tokens, mesh=self.mesh)
        nxt = self._sample(logits)
        self.tokens = nxt[:, None]
        self.decode_steps += 1
        vals = nxt.tolist()
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            tok = vals[i]
            req.out.append(tok)
            if tok == self.cfg.eos_id or len(req.out) >= req.max_tokens:
                req.done = True

    def _drain(self):
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                self.finished.append(req)
                self.slots[i] = None

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        while (self.queue or any(
                r is not None for r in self.slots)) and max_ticks > 0:
            self.step()
            max_ticks -= 1
        self._drain()
        return self.finished


# ---------------------------------------------------------------------------
# GSON reconstruction serving: many concurrent surface-reconstruction
# jobs admitted into fleet slots — one batched device program per wave.


@dataclass
class ReconstructionJob:
    """One queued/running reconstruction request.

    ``status`` walks ``queued -> running -> done``, with the supervised
    detours ``retrying`` (faulted, waiting out its backoff) and the
    terminal ``failed`` (retry budget exhausted; ``error`` holds the
    structured record) / ``budget_exhausted`` (the server's
    ``run(max_ticks)`` ran out first). ``done`` stays the plain "terminal"
    boolean.
    """

    jid: int
    spec: object                  # repro_torch.gson.RunSpec
    seed: int = 0
    history: list = field(default_factory=list)   # streamed rows
    session: object | None = None  # the FleetSession (or Session) serving it
    stats: object | None = None
    done: bool = False
    status: str = "queued"
    retries: int = 0
    not_before_tick: int = 0      # backoff gate for the next retry
    error: dict | None = None     # structured record of the last fault


class ReconstructionServer:
    """Fleet-slot serving of growing-network reconstructions.

    Queued fleet-capable jobs are admitted together as one
    ``repro_torch.gson.FleetSession`` stepping every job's network at
    once (same-shaped specs share a cohort; mixed shapes make one cohort
    each). Each tick advances every live wave by ``slice_iters``
    iterations per network.

    Admission is **incremental**: a slot frees the moment its job
    finishes, and the next tick admits queued jobs into the freed
    capacity as a *new* wave beside the old one — running jobs are never
    re-stacked, and one long job cannot starve the queue behind a
    drained wave. Within a wave, finished networks freeze in place.

    Variants without a batched step program (``single``, ``indexed``)
    are served as one budgeted ``Session`` per slot, time-sliced beside
    the fleet waves.

    ``mesh`` (a ``repro_torch.gson.MeshSpec(axis="network")``) places every
    admitted wave on the ranks of a ``torch.distributed`` group: the
    wave's B axis is sharded so each rank owns whole networks (cohorts pad
    themselves when the wave does not divide the mesh), with no collective
    per iteration and no change to any job's results. Every rank of the
    world runs the same server loop (SPMD): job states are alike on every
    rank, sessions of the solo path run replicated, and rank 0 alone
    writes the snapshots (the others wait at a barrier). A stall verdict
    is rank 0's. A fault raised on one rank alone (a sampler of a network
    that rank holds, a kernel launch, its card's memory) travels in the
    tick's gather: every rank raises the same ``RankFault``, so every
    rank faults the same wave's jobs and retries them alike.

    **Supervision.** With ``checkpoint_dir`` set, every live job is
    snapshotted on the slice cadence (``checkpoint_every_ticks``) into its
    own ``job_<jid>/`` directory — a B = 1 fleet snapshot through
    ``FleetSession.network_snapshot``, so one job restores without its
    wave-mates. A job that faults — its wave's advance raises, the health
    screen quarantines its network, a slice stalls past
    ``tick_timeout_s``, or an injected failure fires — leaves its wave
    and is *retried from its last valid checkpoint* (from its seed when
    it has none) with backoff ``backoff_ticks * 2**(retries - 1)`` ticks,
    each retry admitted as its own single-job wave so a poison job cannot
    fault healthy neighbours again. After ``max_retries`` retries the job
    goes terminal ``failed`` with a structured ``error`` record and the
    server keeps serving everyone else. ``run`` cannot wedge: every loop
    turn either advances a live wave or fast-forwards the tick clock to
    the next backoff deadline, and ``max_ticks`` bounds the total.

    ``injector`` (a ``repro_torch.gson.faults.GsonFaultInjector``) drives
    deterministic faults for tests: poisoned state, crash mid-checkpoint,
    injected job failures, and device loss, which retires every live
    fleet wave; its jobs retry from checkpoint free of charge, on a mesh
    shrunk to the event's ``survivors`` (the first ranks of the group,
    as the JAX server keeps the first devices; the ranks left over stop
    serving, ``left`` is True there and ``run`` returns the jobs that
    rank had finished).

    ``draws``: ``(jid, seed) -> Draws``, the RNG seam of each job's
    session (``None``: ``TorchDraws`` seeded as a dedicated
    ``Session(spec, seed=seed)`` is); a retry restored from a checkpoint
    loads the seam's position from it.
    """

    def __init__(self, slots: int = 4, slice_iters: int = 50,
                 mesh=None, *, checkpoint_dir: str | None = None,
                 checkpoint_every_ticks: int = 1, max_retries: int = 2,
                 backoff_ticks: int = 1, tick_timeout_s: float | None = None,
                 injector=None, health_every: int = 1, draws=None):
        self.slots = slots
        self.slice_iters = slice_iters
        self.mesh = mesh
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_ticks = checkpoint_every_ticks
        self.max_retries = max_retries
        self.backoff_ticks = backoff_ticks
        self.tick_timeout_s = tick_timeout_s
        self.injector = injector
        self.health_every = health_every
        self.draws = draws
        self.queue: list[ReconstructionJob] = []
        self.finished: list[ReconstructionJob] = []
        self.jobs: list[ReconstructionJob] = []     # every submit, ever
        self.ticks = 0
        self._next_jid = 0
        # live waves: (FleetSession, its jobs in network order)
        self._fleets: list[tuple[FleetSession, list[ReconstructionJob]]] = []
        self._solo: list[ReconstructionJob] = []      # Session jobs
        self._retry: list[ReconstructionJob] = []     # faulted, in backoff
        self._mgrs: dict[int, ckpt_mgr.CheckpointManager] = {}
        self.left = False       # shrunk out of the mesh by a device loss

    def submit(self, spec, seed: int = 0) -> ReconstructionJob:
        job = ReconstructionJob(self._next_jid, spec, seed)
        self._next_jid += 1
        self.queue.append(job)
        self.jobs.append(job)
        return job

    # -- supervision helpers -------------------------------------------
    def _mgr(self, jid: int) -> ckpt_mgr.CheckpointManager | None:
        if self.checkpoint_dir is None:
            return None
        if jid not in self._mgrs:
            self._mgrs[jid] = ckpt_mgr.CheckpointManager(
                os.path.join(self.checkpoint_dir, f"job_{jid}"), keep=3)
        return self._mgrs[jid]

    def _draws(self, jobs: list[ReconstructionJob]):
        """One RNG seam per job for a session over ``jobs`` (None: the
        sessions' own ``TorchDraws``)."""
        if self.draws is None:
            return None
        return [self.draws(j.jid, j.seed) for j in jobs]

    def _fault_job(self, job: ReconstructionJob, kind: str, detail,
                   *, count: bool = True) -> None:
        """Record a fault; requeue for retry or go terminal ``failed``.

        ``count=False`` marks an infrastructure fault (device loss): it
        neither spends the job's retry budget nor backs off.
        """
        job.error = {"job": job.jid, "kind": kind, "detail": str(detail),
                     "tick": self.ticks, "retries": job.retries}
        job.session = None
        if count:
            job.retries += 1
        if job.retries > self.max_retries:
            job.status = "failed"
            job.done = True
            self.finished.append(job)
            return
        job.status = "retrying"
        back = (self.backoff_ticks * (2 ** max(job.retries - 1, 0))
                if count else 0)
        job.not_before_tick = self.ticks + back
        self._retry.append(job)

    def _save_warned(self, job: ReconstructionJob, save) -> None:
        """``save()``; a failed snapshot (e.g. a crash mid-publish) leaves
        the previous valid one in place, and serving goes on."""
        try:
            save()
        except Exception as e:                  # noqa: BLE001
            warnings.warn(
                f"job {job.jid}: checkpoint failed "
                f"({type(e).__name__}: {e}); previous snapshot remains "
                "the restore point", RuntimeWarning, stacklevel=3)

    def _checkpoint_jobs(self) -> None:
        """Per-job snapshots on the slice cadence (quarantined networks
        are never snapshotted — their last checkpoint predates the
        poison, which is exactly what the retry restores). Under a mesh
        each snapshot goes from the rank that holds its network to rank 0
        alone, rank 0 writes them and the ranks meet at one barrier."""
        if self.checkpoint_dir is None or not self.checkpoint_every_ticks:
            return
        if self.ticks % self.checkpoint_every_ticks:
            return
        group = None if self.mesh is None else self.mesh.build()
        writer = group is None or dist.get_rank(group) == 0
        try:
            for fleet, jobs in self._fleets:
                q = fleet.quarantined
                for i, job in enumerate(jobs):
                    if (job.status != "running" or job.session is not fleet
                            or q[i]):
                        continue
                    tree, extra = fleet.network_snapshot(i)  # collective
                    if writer:
                        self._save_warned(job, lambda job=job, t=tree, e=extra:
                                          self._mgr(job.jid).save(
                                              t, int(e["iterations"][0]), e))
            for job in self._solo:
                if (writer and job.status == "running"
                        and job.session._mgr is not None):
                    self._save_warned(job, job.session.checkpoint)
        finally:
            if group is not None:
                dist_core.barrier(group)

    def _inject(self) -> None:
        """Fire this tick's scheduled faults (each fires once)."""
        if self.injector is None:
            return
        events = self.injector.events_at(self.ticks)
        if not events:
            return
        self.injector.pop(self.ticks)
        for ev in events:
            kind = ev.get("kind")
            if kind == "crash_checkpoint":
                gf.arm_checkpoint_crash(ev.get("times", 1))
            elif kind == "poison":
                for fleet, jobs in self._fleets:
                    for i, job in enumerate(jobs):
                        if (job.jid == ev["job"]
                                and job.status == "running"
                                and job.session is fleet):
                            gf.poison_network(fleet, i,
                                              ev.get("poison", "nan"))
            elif kind == "fail_job":
                for job in self._live_jobs():
                    if job.jid == ev["job"]:
                        self._fault_job(job, "injected_failure",
                                        ev.get("detail", "injected"))
            elif kind == "device_loss":
                n = int(ev.get("survivors", 1))
                if self.mesh is not None:
                    # the survivors are the first n ranks; the group is
                    # built on every rank (collective), leaving ones too
                    self.mesh = dataclasses.replace(self.mesh, devices=n)
                    self.left = dist.get_rank(self.mesh.build()) < 0
                # every wave dies with its devices; its jobs retry from
                # checkpoint on the survivor mesh, free
                for fleet, jobs in self._fleets:
                    for job in jobs:
                        if job.status == "running" and job.session is fleet:
                            self._fault_job(
                                job, "device_loss",
                                f"mesh shrunk to {n} devices",
                                count=False)
                self._fleets = []
            else:
                warnings.warn(f"unknown injected fault {ev!r} ignored",
                              RuntimeWarning, stacklevel=2)

    @staticmethod
    def _fleet_capable(spec) -> bool:
        return getattr(resolve_variant(spec.variant), "fleet_capable",
                       False)

    def _live_jobs(self) -> list[ReconstructionJob]:
        # a faulted job stays in its old wave's list until that wave
        # drains; ``session`` identity says which wave owns it NOW
        return ([j for f, jobs in self._fleets for j in jobs
                 if j.status == "running" and j.session is f]
                + [j for j in self._solo if j.status == "running"])

    def _admit(self, free: int):
        """Fill freed capacity: eligible *retries* first (each its own
        single-job wave, isolating a possibly-poison job), then queued
        fresh jobs as one shared wave."""
        for job in list(self._retry):
            if free <= 0:
                return
            if self.ticks < job.not_before_tick:
                continue
            self._retry.remove(job)
            try:
                self._admit_retry(job)
            except Exception as e:              # noqa: BLE001
                self._fault_job(job, "admission_error", repr(e))
                continue
            free -= 1
        self._admit_fresh(free)

    def _admit_retry(self, job: ReconstructionJob) -> None:
        """Resume one faulted job from its last valid checkpoint (fresh
        from its seed when it never reached one — deterministic either
        way), on its spec's backend and device."""
        mgr = self._mgr(job.jid)
        have_ckpt = mgr is not None and mgr.latest() is not None
        draws = self._draws([job])
        if self._fleet_capable(job.spec):
            fspec = FleetSpec((job.spec,), (job.seed,), self.mesh)

            def route(row, job=job):
                job.history.append(row)

            if have_ckpt:
                sess = FleetSession.restore(
                    fspec, mgr.path, on_history=route,
                    health_every=self.health_every, draws=draws)
                job.history[:] = list(sess.stats[0].history)
            else:
                sess = FleetSession(fspec, on_history=route,
                                    health_every=self.health_every,
                                    draws=draws)
                job.history.clear()
            job.session = sess
            job.status = "running"
            self._fleets.append((sess, [job]))
        else:
            draws = None if draws is None else draws[0]
            if have_ckpt:
                sess = Session.restore(job.spec, mgr.path, draws=draws,
                                       on_history=job.history.append)
                job.history[:] = list(sess.stats.history)
            else:
                sess = Session(job.spec, draws, seed=job.seed,
                               on_history=job.history.append,
                               checkpoint_dir=(mgr.path if mgr else None))
                job.history.clear()
            job.session = sess
            job.status = "running"
            self._solo.append(job)

    def _admit_fresh(self, free: int):
        """Admit up to ``free`` queued jobs: fleet-capable ones become ONE
        new FleetSession, the rest Sessions.

        Construction can raise (a job spec the FleetSpec rejects), so jobs
        leave the queue only once their wave is fully constructed; on
        failure the whole wave returns to the queue front and the error
        propagates (no job is silently dropped). Sessions start lazily,
        so a failure of a job's first draws surfaces in its advance.
        """
        wave: list[ReconstructionJob] = []
        while self.queue and len(wave) < free:
            wave.append(self.queue.pop(0))
        if not wave:
            return
        try:
            fleet_jobs = [j for j in wave if self._fleet_capable(j.spec)]
            solo_jobs = [j for j in wave if j not in fleet_jobs]
            fleet = None
            if fleet_jobs:
                fspec = FleetSpec(tuple(j.spec for j in fleet_jobs),
                                  tuple(j.seed for j in fleet_jobs),
                                  self.mesh)

                def route(row, jobs=fleet_jobs):
                    jobs[row["network"]].history.append(row)

                fleet = FleetSession(fspec, on_history=route,
                                     health_every=self.health_every,
                                     draws=self._draws(fleet_jobs))
            solo_sessions = [
                Session(j.spec, d, seed=j.seed,
                        on_history=j.history.append,
                        checkpoint_dir=(self._mgr(j.jid).path
                                        if self.checkpoint_dir else None))
                for j, d in zip(solo_jobs, self._draws(solo_jobs)
                                or [None] * len(solo_jobs))]
        except Exception:
            self.queue[:0] = wave
            raise
        if fleet is not None:
            for j in fleet_jobs:
                j.session = fleet
                j.status = "running"
            self._fleets.append((fleet, fleet_jobs))
        for j, sess in zip(solo_jobs, solo_sessions):
            j.session = sess
            j.status = "running"
            self._solo.append(j)

    def _stalled(self, t0: float) -> str | None:
        """The stall verdict of a slice that started at ``t0``; under a
        mesh rank 0's, so that every rank takes the same decision
        (collective)."""
        dt = time.perf_counter() - t0
        out = None
        if self.tick_timeout_s is not None and dt > self.tick_timeout_s:
            out = f"slice took {dt:.2f}s > {self.tick_timeout_s:.2f}s"
        if self.mesh is None or self.tick_timeout_s is None:
            return out
        return dist_core.broadcast_object(self.mesh.build(), out, 0)

    def _finish(self, job: ReconstructionJob, stats) -> None:
        job.stats = stats
        job.done = True
        job.status = "done"
        self.finished.append(job)

    def step(self):
        """One tick: fire scheduled faults, refill freed slots, advance
        every live wave under supervision, snapshot the survivors."""
        self._inject()
        if self.left:
            return
        # drop waves with no running jobs left (drained or all faulted)
        self._fleets = [(f, jobs) for f, jobs in self._fleets
                        if any(j.status == "running" and j.session is f
                               for j in jobs)]
        self._solo = [j for j in self._solo if j.status == "running"]
        free = self.slots - len(self._live_jobs())
        if free > 0 and (self.queue or self._retry):
            self._admit(free)
        if not self._live_jobs():
            waiting = [j.not_before_tick for j in self._retry]
            if waiting:
                # everyone is in backoff: fast-forward the clock so the
                # run loop spends one turn, not one per idle tick
                self.ticks = max(self.ticks + 1, min(waiting))
            return
        self.ticks += 1
        for fleet, jobs in list(self._fleets):
            mine = [job.status == "running" and job.session is fleet
                    for job in jobs]
            t0 = time.perf_counter()
            try:
                # the tick's count read syncs the device before the clock
                fleet.run(budget=self.slice_iters)
                fault = ("stall", self._stalled(t0))
            except Exception as e:              # noqa: BLE001
                fault = ("advance_error", repr(e))
            if fault[1] is not None:
                self._fleets.remove((fleet, jobs))
                for job, m in zip(jobs, mine):
                    if m:
                        self._fault_job(job, *fault)
                continue
            quarantined = fleet.quarantined
            recs = {f["network"]: f for f in fleet.faults}
            for i, (job, m) in enumerate(zip(jobs, mine)):
                if not m:
                    continue
                if quarantined[i]:
                    # the network froze in place; the job retries from
                    # its last pre-poison checkpoint in its own wave
                    self._fault_job(
                        job, "unhealthy_state",
                        recs.get(i, {}).get("detail", "quarantined"))
                elif not fleet.active_network(i):
                    self._finish(job, fleet.result(i)[1])
        for job in list(self._solo):
            if job.status != "running":
                continue
            t0 = time.perf_counter()
            try:
                job.session.run(budget=self.slice_iters)
                fault = ("stall", self._stalled(t0))
            except Exception as e:              # noqa: BLE001
                fault = ("advance_error", repr(e))
            if fault[1] is not None:
                self._solo.remove(job)
                self._fault_job(job, *fault)
                continue
            if not job.session.active:
                self._finish(job, job.session.result()[1])
        self._checkpoint_jobs()

    def run(self, max_ticks: int = 10_000) -> list[ReconstructionJob]:
        """Serve until every job is terminal, or ``max_ticks`` elapse.

        Returns EVERY submitted-but-unreturned job with a terminal status:
        ``done``, ``failed`` (retry budget spent — see ``job.error``), or
        ``budget_exhausted`` for jobs still queued / retrying / running
        when the tick budget ran out — nothing is silently dropped. A
        later ``run`` call picks the ``budget_exhausted`` ones back up
        where they stopped.
        """
        for job in self.jobs:
            if job.status == "budget_exhausted":    # resuming
                job.status = ("queued" if job in self.queue
                              else "retrying" if job in self._retry
                              else "running")
        while (self.queue or self._retry
               or self._live_jobs()) and max_ticks > 0 and not self.left:
            self.step()
            max_ticks -= 1
        out = list(self.finished)
        if self.left:
            return out
        for job in self.queue + self._retry + self._live_jobs():
            if not job.done:
                job.status = "budget_exhausted"
                out.append(job)
        return out
