"""The plain GNG reference (``gpubench/reference/gng_step.py``) against
the port, and the port's ``gson.gng_insert`` span.

* The port: a B = 3 ``FleetSession`` of GNG networks (C = 64, K = 16,
  d = 3) on the CPU, at the benchmark configuration's settings
  (Fritzke 1995: eps_b 0.2, eps_n 0.006, alpha 0.5, a_max 50, beta
  0.005) with lambda 100, and with lambda 1, where an iteration inserts
  ``K_CAP`` units and the pool fills. From the port's state before each
  iteration and that iteration's draws, the reference must reach the
  port's state after it: discrete fields bitwise, floats within
  rtol=1e-6, atol=1e-7. An iteration that held a near tie is left out.
* The JAX package: the reference's own trajectory under the JAX draws
  against ``repro.core.gson.multi``'s GNG step, after every step.
* The span: ``gson.gng_insert`` opens once per GNG fleet iteration,
  inside ``gson.tail``, and never for SOAM or GWR.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import gson
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams
from repro_torch.rng import TorchDraws
from repro_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from gpubench.reference import gng_step as ref  # noqa: E402

torch.set_num_threads(1)

C, K, B = 64, 16, 3
PUBLISHED = dict(eps_b=0.2, eps_n=0.006, age_max=50.0, gng_lambda=100,
                 gng_alpha=0.5, gng_beta=0.005)
TOL = dict(rtol=1e-6, atol=1e-7)
DISCRETE = ("active", "nbr", "age", "topo_state", "inconsistent_for",
            "n_active", "signal_count", "discarded", "dropped_edges",
            "dropped_units")
FLOATS = ("w", "error", "firing", "threshold")


def ref_params(**kw) -> ref.Params:
    return ref.Params(**dict(PUBLISHED, **kw), insertion_threshold=0.2,
                      min_m=4, check_every=10)


class Recording:
    """A network's ``TorchDraws``, keeping each iteration's signals and
    lock priorities."""

    def __init__(self, seed: int):
        self.d = TorchDraws(seed, "cpu", make_sampler("sphere"))
        self.signals_of, self.prio_of = [], []

    def seed_points(self, n):
        return self.d.seed_points(n)

    def probes(self, n):
        return self.d.probes(n)

    def signals(self, n):
        self.signals_of.append(self.d.signals(n))
        return self.signals_of[-1]

    def lock_priorities(self, m):
        self.prio_of.append(self.d.lock_priorities(m))
        return self.prio_of[-1]

    def state_dict(self):
        return self.d.state_dict()

    def load_state_dict(self, d):
        self.d.load_state_dict(d)


def fleet(backend: str, model: str = "gng", seeds=(11, 12, 13), **kw):
    spec = gson.RunSpec(variant="multi",
                        model=GSONParams(model=model, **kw),
                        backend=backend, capacity=C, max_deg=K, n_probe=128,
                        device="cpu")
    draws = [Recording(s) for s in seeds]
    sess = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=seeds),
                             draws=draws)
    sess.active                    # starts it
    return sess, draws


def net_of(sess, i: int) -> ref.Net:
    (c,) = sess.cohorts
    n = c.fstate.nets
    return ref.Net.of({f: getattr(n, f)[i] for f in ref.FIELDS})


def assert_equal(got: ref.Net, want: ref.Net, tag: str) -> None:
    for f in DISCRETE:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), f"{tag} {f}")
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(),
                                   err_msg=f"{tag} {f}", **TOL)


# (model settings beyond the published ones, iterations)
CASES = {
    # lambda 100: the first insertions come after ~50 iterations
    "published": ({}, 96),
    # lambda 1: K_CAP insertions an iteration from ~8 units on, and the
    # pool of 64 full within ~10 iterations
    "lambda1": ({"gng_lambda": 1}, 48),
}


@pytest.mark.parametrize("backend", ["reference", "cuda-full"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_port_step_by_step(case, backend):
    extra, iters = CASES[case]
    p = ref_params(**extra)
    sess, draws = fleet(backend, **dict(PUBLISHED, **extra))
    before = [net_of(sess, i) for i in range(B)]
    ties = judged = cap_hits = 0
    for k in range(iters):
        sess.run(budget=1)
        after = [net_of(sess, i) for i in range(B)]
        for i in range(B):
            want, tie = ref.step(before[i], draws[i].signals_of[k],
                                 draws[i].prio_of[k], k, p)
            grown = int(after[i].n_active) - int(before[i].n_active)
            cap_hits += grown == ref.K_CAP
            if tie:
                ties += 1
                continue
            assert_equal(after[i], want, f"{case} network {i} it {k}")
            judged += 1
        before = after
    # two insertions of one iteration between the same q and f put two
    # units at one point, a near tie for the signals around it
    assert judged >= iters * B // 2, (judged, ties)
    last = [int(n.n_active) for n in before]
    if case == "published":
        assert max(last) > 2, last
    else:
        assert cap_hits > 0
        assert min(int(n.dropped_units) for n in before) > 0, last


def test_reference_follows_the_jax_package():
    """The reference's own trajectory from the JAX package's fresh state,
    under the JAX draws (signals from JAX's sampler, priorities from the
    state's key chain), against JAX's GNG step: lambda 8, so that it
    inserts within the 40 steps."""
    pytest.importorskip("jax")
    import jax
    from _torch_parity import RUN_TOL, lock_priorities, t
    from repro.core.gson.multi import multi_signal_step_impl
    from repro.core.gson.sampling import make_sampler as jax_sampler
    from repro.core.gson.state import GSONParams as JaxParams
    from repro.core.gson.state import init_state as jax_init

    jp = JaxParams(model="gng", **dict(PUBLISHED, gng_lambda=8))
    p = ref_params(gng_lambda=8)
    jstep = jax.jit(multi_signal_step_impl,
                    static_argnames=("params", "refresh_states"))
    sampler = jax_sampler("sphere")
    seeds = sampler(jax.random.key(1), 2)
    jst = jax_init(jax.random.key(0), capacity=C, dim=3, max_deg=K,
                   seed_points=seeds, init_threshold=0.2)
    net = ref.init(t(seeds), C, K, 0.2)
    rng = jax.random.key(7)
    judged = 0
    for k in range(40):
        m = ref.live_signals(int(net.n_active), p, 1 << 20)
        rng, key = jax.random.split(rng)
        sig = sampler(key, m)
        prio = lock_priorities(jax.random.split(jst.rng)[1], m)
        jst = jstep(jst, sig, jp, refresh_states=False)
        net, tie = ref.step(net, t(sig), prio, k, p)
        got = ref.Net.of({f: t(getattr(jst, f)) for f in ref.FIELDS})
        if tie:             # go on from JAX's side, as the check does
            net = got
            continue
        judged += 1
        for f in DISCRETE:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(net, f).numpy(),
                                          f"step {k} {f}")
        for f in FLOATS:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(net, f).numpy(),
                                       err_msg=f"step {k} {f}", **RUN_TOL)
    assert judged >= 30 and int(net.n_active) > 4


@pytest.mark.parametrize("model,per_iteration",
                         [("gng", 1), ("soam", 0), ("gwr", 0)])
def test_gng_insert_span_once_per_gng_iteration(model, per_iteration):
    sess, _ = fleet("reference", model=model, seeds=(3, 4),
                    **(dict(PUBLISHED, gng_lambda=1) if model == "gng"
                       else {}))
    timing.clear()
    with timing.tracing(True):
        sess.run(budget=12)
    log = timing.spans()
    timing.clear()
    inserts = [(s, e) for name, s, e, _, _ in log
               if name == "gson.gng_insert"]
    tails = [(s, e) for name, s, e, _, _ in log if name == "gson.tail"]
    assert len(tails) == 12
    assert len(inserts) == 12 * per_iteration
    assert all(any(a <= s and e <= b for a, b in tails)
               for s, e in inserts)
