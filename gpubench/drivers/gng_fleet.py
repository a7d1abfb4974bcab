"""Driver of the GNG cells: the jobs of ``gson_fleet`` (B fresh networks
through ``repro_torch.gson.FleetSession``, back to back, closed loop,
their states captured for the check), judged against the plain GNG
reference (``gpubench.reference.gng_step`` through ``gng_compare``).

The check's sampled later iterations come from the traffic's
``check.steps_from`` on (``gson_fleet`` draws them from the end of the
own trajectories): a GNG network grows from 2 units about 0.7% an
iteration, so most of a job holds a few dozen units, and only its last
part, where it inserts every iteration, tells a fault of the insertion
or a lower precision apart from float32 rounding.

The counted work of an iteration (``gpubench.work``) holds no SOAM
refresh: GNG has none, and its convergence check reads the probes'
distances, not the units' neighborhoods.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench import work
from gpubench.drivers import gson_fleet
from gpubench.reference import gng_compare
from gpubench.reference import gng_step as ref


class Driver(gson_fleet.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        # gson_fleet's own set-up takes the SOAM reference's parameters
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

    def _job_with_capture(self, job: int) -> None:
        """``gson_fleet``'s, with the sampled iterations drawn from
        ``check.steps_from`` on."""
        chk = self.traffic["check"]
        rng = np.random.default_rng([self.seed & (2 ** 63 - 1), job, 7])
        nets = [int(i) for i in rng.choice(
            self.B, size=min(int(chk["networks"]), self.B), replace=False)]
        own = sorted(nets[:int(chk["trajectory_networks"])])
        nets = sorted(nets)
        T = int(chk["trajectory_iterations"])
        steps = sorted(int(t) for t in rng.choice(
            np.arange(max(T, int(chk["steps_from"])), self.N - 1),
            size=int(chk["steps"]), replace=False))
        points = {0} | set(steps) | {t + 1 for t in steps}
        at = points | set(range(T + 1))
        states: dict = {}
        sess, inputs = self._session(job)
        rows = {}

        def grab(k):
            if k in at and k not in states:
                who = nets if k in points else own
                states[k] = gson_fleet._states(sess, who, rows)

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

    def _work(self, rows: dict, lead: int) -> dict:
        """Per fleet iteration, the counted work of each phase, summed
        over the networks; no refresh (r = 0)."""
        C, d, K = self.cfg["capacity"], self.cfg["dim"], self.cfg["max_deg"]
        out = {"find_winners": [], "update_phase": [], "iteration": []}
        for k in range(lead, self.N):
            if k not in rows or k + 1 not in rows:
                continue
            a0, sc0, dc0, e0 = rows[k]
            _, sc1, dc1, _ = rows[k + 1]
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
                                                     0))):
                    tot[name][0] += f
                    tot[name][1] += by
            for name in out:
                out[name].append(tuple(tot[name]))
        return out

    def check(self, control=None) -> gng_compare.Tally:
        """Judge every captured network of every job of the window;
        ``control``: see ``gng_compare.judge_network``."""
        tally = gng_compare.Tally()
        for job in self.captures:
            for cap in job:
                gng_compare.judge_network(tally, self.params, cap,
                                          program=control)
        return tally
