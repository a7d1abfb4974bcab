"""The port's multi-signal step against ``repro.core.gson.multi``.

* One step for gng, gwr and soam from the same state, signals and lock
  priorities, with both of the port's update paths (the plain reference
  and the kernel op's plain versions): discrete fields bitwise, floats
  within rtol=1e-6, atol=1e-7.
* A 24-step trajectory at capacity 200 under the JAX draws, compared
  after every step: discrete fields bitwise, floats within rtol=1e-5,
  atol=1e-6. The per-step ulp drift of the float fields could in
  principle flip a near-tie winner; 24 steps is the horizon pinned here
  for these seeds.
* The structural invariants after every step.
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (RUN_TOL, STEP_TOL, assert_invariants,  # noqa: E402
                           assert_states_match, lock_priorities, t,
                           to_jax_state, torch_params)
from repro.core.gson.multi import multi_signal_step_impl  # noqa: E402
from repro.core.gson.sampling import make_sampler as jax_sampler  # noqa: E402
from repro.core.gson.state import GSONParams as JaxParams  # noqa: E402
from repro.core.gson.state import init_state as jax_init  # noqa: E402
from repro_torch.core.gson.multi import multi_signal_step  # noqa: E402
from repro_torch.core.gson.sampling import make_sampler  # noqa: E402
from repro_torch.core.gson.state import init_state  # noqa: E402
from repro_torch.kernels.find_winners import cuda_find_winners  # noqa: E402
from repro_torch.kernels.update_phase import update_phase_op  # noqa: E402

torch.set_num_threads(1)

jax_step = jax.jit(multi_signal_step_impl,
                   static_argnames=("params", "refresh_states"))

PORT_PATHS = {
    "reference": dict(),
    "kernels": dict(find_winners=cuda_find_winners,
                    update_phase=update_phase_op),
}


def params(model):
    """One parameter set per model for every test here (the jitted JAX
    step compiles once per set and shape); a short GNG insertion period
    makes GNG grow within a few steps."""
    return JaxParams(model=model, insertion_threshold=0.3, gng_lambda=8)


def grown(model, capacity=200, max_deg=12, iters=25, m=64):
    """A pool grown by the port; returns (jax params, port params, state)."""
    p = params(model)
    tp = torch_params(p)
    sampler = make_sampler("torus")
    g = torch.Generator().manual_seed(1)
    st = init_state(sampler(g, 2), capacity=capacity, max_deg=max_deg,
                    init_threshold=0.3)
    for i in range(iters):
        prio = torch.randperm(m, generator=g, dtype=torch.int32)
        st = multi_signal_step(st, sampler(g, m), tp, prio,
                               refresh_states=(i % 5 == 0))
    return p, tp, st


@pytest.mark.parametrize("path", sorted(PORT_PATHS))
@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_one_step_matches_jax(model, path):
    p, tp, st = grown(model)
    sig = make_sampler("torus")(torch.Generator().manual_seed(9), 64)
    key = jax.random.key(11)
    out_j = jax_step(to_jax_state(st, key), jnp.asarray(sig.numpy()), p,
                     refresh_states=True)
    prio = lock_priorities(jax.random.split(key)[1], 64)
    out_t = multi_signal_step(st, sig, tp, prio, refresh_states=True,
                              **PORT_PATHS[path])
    assert_states_match(out_j, out_t, STEP_TOL, tag=f"{model} {path}")
    assert_invariants(out_t.nbr, out_t.age, out_t.active)


@pytest.mark.parametrize("model", ["soam", "gng"])
def test_trajectory_matches_jax(model):
    """24 steps from a fresh pool under the JAX draws (signals from the
    JAX sampler, priorities from the state's key chain)."""
    p = params(model)
    tp = torch_params(p)
    sampler = jax_sampler("torus")
    seeds = sampler(jax.random.key(1), 2)
    jst = jax_init(jax.random.key(0), capacity=200, dim=3, max_deg=12,
                   seed_points=seeds, init_threshold=0.3)
    tst = init_state(t(seeds), capacity=200, max_deg=12,
                     init_threshold=tp.insertion_threshold)
    rng = jax.random.key(7)
    for i in range(24):
        rng, k = jax.random.split(rng)
        sig = sampler(k, 64)
        prio = lock_priorities(jax.random.split(jst.rng)[1], 64)
        refresh = i % 5 == 0
        jst = jax_step(jst, sig, p, refresh_states=refresh)
        tst = multi_signal_step(tst, t(sig), tp, prio,
                                refresh_states=refresh,
                                **PORT_PATHS["kernels"])
        assert_states_match(jst, tst, RUN_TOL, tag=f"{model} step {i}")
        assert_invariants(tst.nbr, tst.age, tst.active)
    assert int(tst.n_active) > 2


def test_masked_rows_are_inert():
    """A masked step equals the unmasked step on the valid rows alone
    when the priorities of those rows keep their order."""
    p, tp, st = grown("soam")
    g = torch.Generator().manual_seed(4)
    sig = make_sampler("torus")(g, 64)
    prio = torch.randperm(64, generator=g, dtype=torch.int32)
    mask = torch.arange(64) < 23
    masked = multi_signal_step(st, sig, tp, prio, signal_mask=mask,
                               **PORT_PATHS["kernels"])
    order = torch.argsort(prio[:23]).argsort().to(torch.int32)
    alone = multi_signal_step(st, sig[:23], tp, order,
                              **PORT_PATHS["kernels"])
    for name in ("nbr", "active", "age", "n_active", "signal_count",
                 "discarded"):
        np.testing.assert_array_equal(getattr(masked, name).numpy(),
                                      getattr(alone, name).numpy(), name)
    np.testing.assert_allclose(masked.w.numpy(), alone.w.numpy(),
                               **STEP_TOL)
