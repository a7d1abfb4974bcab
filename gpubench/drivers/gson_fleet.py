"""Driver of the GSON cells: jobs of B fresh networks through
``repro_torch.gson.FleetSession``.

A job is a fleet of ``networks`` fresh networks of the configuration,
each run for ``iterations`` iterations by ``FleetSession.run(budget=)``,
its inputs drawn by ``gpubench.traffic.draws.JobInputs`` from (seed,
job). Jobs run back to back, closed loop: a caller waits for its
reconstruction before it sends the next.

While a job runs, the check copies the program's states of a few of its
networks, drawn from the seed, with the inputs of the iterations it
judges: of ``check.trajectory_networks`` of them before every iteration
up to ``check.trajectory_iterations``, and of ``check.networks`` of them
(those included) before iteration 0 and around ``check.steps`` sampled
later iterations. Once the window has closed, ``check()`` judges them
against the plain reference (``gpubench.reference.compare``).

With ``--trace 1``, the window's first job is run twice more through
its last ``trace.iterations`` iterations: once timed on the host clock,
each iteration's work counted on the device as it runs (the inputs of
``gpubench.work``, read back after), once under ``torch.profiler``. The
program is deterministic, so both see the same iterations. Their inputs
are drawn before they start, so that they hold the program's work
alone.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gpubench import trace, work
from gpubench.reference import compare
from gpubench.reference import gson_step as ref
from gpubench.traffic.draws import JobInputs

STATE_FIELDS = ref.FIELDS


@dataclasses.dataclass
class TraceContext:
    """What the per-layer metric readers read (``gpubench/metrics``)."""

    device: list          # device operations (name, start us, end us)
    host: list            # top-level host operations, likewise
    window_s: float       # host wall of the profiled iterations
    busy_s: float         # time in which a device operation ran
    iterations: int       # fleet iterations profiled
    unprofiled_s: float   # host wall of the same iterations, unprofiled
    work: dict            # phase -> [(flops, bytes) per fleet iteration]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch import gson
        from repro_torch.core.gson.state import GSONParams
        self.gson = gson
        self.cfg, self.traffic = cfg, traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        vcls = gson.VARIANTS.get(cfg["variant"]).config_cls
        self.spec = gson.RunSpec(
            variant=cfg["variant"], model=GSONParams(**cfg["model"]),
            sampler=traffic["surface"], backend=cfg["backend"],
            variant_config=vcls(**cfg["variant_config"]),
            capacity=cfg["capacity"], dim=cfg["dim"],
            max_deg=cfg["max_deg"], max_iterations=cfg["max_iterations"],
            check_every=cfg["check_every"],
            qe_threshold=cfg["qe_threshold"], n_probe=cfg["n_probe"],
            device=str(self.device))
        self.params = ref.Params.from_config(cfg)
        self.B = int(traffic["networks"])
        self.N = int(traffic["iterations"])
        self.captures: list = []
        self.jobs = 0
        self.net_iterations = 0
        self.failed = 0

    # ------------------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _session(self, job: int):
        inputs = JobInputs(seed=self.seed, job=job, batch=self.B,
                           surface=self.traffic["surface"],
                           device=self.device)
        seeds = [self.seed * 1_000_003 + job * 4099 + i
                 for i in range(self.B)]
        sess = self.gson.FleetSession(
            self.gson.FleetSpec.broadcast(self.spec, seeds=seeds),
            draws=inputs.draws())
        return sess, inputs

    def setup(self) -> None:
        """One short job at the cell's shapes: builds and loads the
        kernels, fills the allocator, passes a refresh and a check."""
        sess, _ = self._session(-1)
        sess.run(budget=int(self.traffic["warmup_iterations"]))
        self.sync()
        del sess

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Jobs back to back until ``seconds`` have passed; the job that
        crosses the mark runs to its end and counts. Returns the
        end-to-end metrics."""
        t0 = time.perf_counter()
        while True:
            self._job_with_capture(self.jobs)
            self.jobs += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"network_it_per_s": self.net_iterations / elapsed}

    def _job_with_capture(self, job: int) -> None:
        chk = self.traffic["check"]
        rng = np.random.default_rng([self.seed & (2 ** 63 - 1), job, 7])
        nets = [int(i) for i in rng.choice(
            self.B, size=min(int(chk["networks"]), self.B), replace=False)]
        own = sorted(nets[:int(chk["trajectory_networks"])])
        nets = sorted(nets)
        T = int(chk["trajectory_iterations"])
        steps = sorted(int(t) for t in rng.choice(
            np.arange(T, self.N - 1), size=int(chk["steps"]),
            replace=False))
        points = {0} | set(steps) | {t + 1 for t in steps}
        at = points | set(range(T + 1))
        states: dict = {}
        sess, inputs = self._session(job)
        rows = {}

        def grab(k):
            if k in at and k not in states:
                who = nets if k in points else own
                states[k] = _states(sess, who, rows)

        inputs.on_iteration = grab
        inputs.keep = set(range(T)) | set(steps)
        inputs.keep_rows = torch.tensor(nets, device=self.device)
        sess.run(budget=self.N)
        for k in sorted(at - set(states)):    # every network stopped early
            grab(k)
        self.sync()
        self.net_iterations += int(sess.iterations.sum())
        done = sess.iterations >= self.N
        self.failed += int((sess.quarantined | ~(done | sess.converged))
                           .sum())
        self.captures.append([{
            "seed_points": inputs.seed_points[i].clone(),
            "states": {k: states[k][i] for k in states if i in states[k]},
            "inputs": {k: (s[r].clone(), p[r].clone())
                       for k, (s, p) in inputs.kept.items()
                       if k in steps or i in own},
            "drawn": list(inputs.drawn[i]),
            "trajectory": T if i in own else 0,
            "steps": steps} for r, i in enumerate(nets)])

    @property
    def attempted(self) -> int:
        return self.jobs * self.B

    # ------------------------------------------------------------------
    def traced(self) -> TraceContext:
        """The last ``trace.iterations`` iterations of job 0, timed (their
        work counted on the device as they run, read back after), then
        profiled."""
        P = int(self.traffic["trace"]["iterations"])
        lead = self.N - P

        def led():
            sess, inputs = self._session(0)
            sess.run(budget=lead)
            inputs.prefetch(range(lead, self.N))
            self.sync()
            return sess, inputs

        sess, inputs = led()
        counted = {}
        inputs.on_iteration = lambda k: counted.setdefault(k, _counts(sess))
        t0 = time.perf_counter()
        sess.run(budget=P)
        self.sync()
        unprofiled = time.perf_counter() - t0
        counted[self.N] = _counts(sess)
        rows = {k: v.cpu().numpy() for k, v in counted.items()}
        del sess, inputs

        sess, _ = led()
        wall, device, host = trace.profile(lambda: sess.run(budget=P),
                                           self.sync)
        del sess
        return TraceContext(
            device=device, host=host, window_s=wall,
            busy_s=trace.busy_seconds(device), iterations=P,
            unprofiled_s=unprofiled,
            work=self._work(rows, lead))

    def _work(self, rows: dict, lead: int) -> dict:
        """Per fleet iteration, the counted work of each phase, summed
        over the networks."""
        C, d, K = self.cfg["capacity"], self.cfg["dim"], self.cfg["max_deg"]
        p = self.params
        out = {"find_winners": [], "update_phase": [], "iteration": []}
        for k in range(lead, self.N):
            if k not in rows or k + 1 not in rows:
                continue
            a0, sc0, dc0, e0 = rows[k]
            _, sc1, dc1, _ = rows[k + 1]
            r = int(k % p.refresh_every == 0) + int(
                (k + 1) % p.check_every == 0)
            tot = {name: [0.0, 0.0] for name in out}
            for b in range(self.B):
                m = int(sc1[b] - sc0[b])
                if m == 0:
                    continue
                s = int((sc1[b] - dc1[b]) - (sc0[b] - dc0[b]))
                a, e = int(a0[b]), int(e0[b])
                for name, (f, by) in (
                        ("find_winners", work.find_winners(m, a, C, d)),
                        ("update_phase", work.update_phase(m, s, a, e, d,
                                                           K)),
                        ("iteration", work.iteration(m, s, a, e, C, d, K,
                                                     r))):
                    tot[name][0] += f
                    tot[name][1] += by
            for name in out:
                out[name].append(tuple(tot[name]))
        return out

    # ------------------------------------------------------------------
    def free(self) -> None:
        """Drop the program's allocations, keeping the copied states."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> compare.Tally:
        """Judge every captured network of every job of the window;
        ``control``: see ``compare.judge_network``."""
        tally = compare.Tally()
        for job in self.captures:
            for cap in job:
                compare.judge_network(tally, self.params, cap,
                                      program=control)
        return tally


def _states(sess, nets: list, rows: dict) -> dict:
    """{network: its state} of ``nets``, copied: one gather of each
    field. A job is one cohort (one broadcast spec), in fleet order.
    ``rows`` keeps the index tensors, made once a job (a fresh one copies
    from the host)."""
    (c,) = sess.cohorts
    key = tuple(nets)
    if key not in rows:
        rows[key] = torch.tensor(nets, device=c.fstate.nets.w.device)
    got = c.fstate.nets.map(lambda x: x.index_select(0, rows[key]))
    return {i: {f: getattr(got, f)[n] for f in STATE_FIELDS}
            for n, i in enumerate(nets)}


def _counts(sess) -> torch.Tensor:
    """(4, B) on the device, fleet order: each network's active units,
    signals, discarded signals and edges. No sync."""
    (c,) = sess.cohorts
    n = c.fstate.nets
    return torch.stack([n.n_active.long(), n.signal_count.long(),
                        n.discarded.long(), (n.nbr >= 0).sum((1, 2)) // 2])
