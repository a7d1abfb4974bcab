"""The port's Update phase against the JAX package's.

A pool grown by the port (a short plain run on the torus) is carried to
both packages; the same signals, winners and lock priorities (the JAX
``permutation(k_lock, m)``) go through:

* the port's ``update_phase_op`` (on the CPU: the plain versions of the
  three kernels) against the JAX ``update_phase_op(interpret=True)``
  (the Pallas kernels), ``update_phase_dense`` (the one-hot oracle) and
  ``update_phase_reference`` (the scatter reference);
* the port's own ``update_phase_reference`` and ``update_phase_dense``
  against their JAX twins.

``selected``/``adapt``/``ins`` and ages bitwise; weights, firing and
error within rtol=1e-6, atol=1e-7 (``W_TOL`` of
``tests/test_kernels_update_phase.py``: neighbor sums add colliding
pulls in another order). The CUDA kernels are held against their plain
versions in ``tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (assert_update_out_match,  # noqa: E402
                           lock_priorities, t, to_jax_state, torch_params)
from repro.core.gson.multi import find_winners_reference  # noqa: E402
from repro.core.gson.multi import \
    update_phase_reference as jax_reference  # noqa: E402
from repro.core.gson.state import GSONParams as JaxParams  # noqa: E402
from repro.kernels.update_phase.ops import \
    update_phase_op as jax_op  # noqa: E402
from repro.kernels.update_phase.ref import \
    update_phase_dense as jax_dense  # noqa: E402
from repro_torch.core.gson.multi import (multi_signal_step,  # noqa: E402
                                         update_phase_reference)
from repro_torch.core.gson.multi import \
    find_winners_reference as find_winners_reference_t  # noqa: E402
from repro_torch.core.gson.sampling import make_sampler  # noqa: E402
from repro_torch.core.gson.state import init_state  # noqa: E402
from repro_torch.kernels.update_phase import (  # noqa: E402
    edge_age, update_accum, update_phase_dense, update_phase_op,
    winner_lock_min)

torch.set_num_threads(1)


def grown_state(model: str, capacity=200, max_deg=12, iters=25, m=64,
                seed=0, device="cpu"):
    """A non-trivial network: ``iters`` plain port steps on the torus."""
    p = JaxParams(model=model, insertion_threshold=0.3)
    tp = torch_params(p)
    sampler = make_sampler("torus")
    g = torch.Generator(device=device).manual_seed(seed)
    st = init_state(sampler(g, 2), capacity=capacity, max_deg=max_deg,
                    init_threshold=tp.insertion_threshold)
    for i in range(iters):
        prio = torch.randperm(m, generator=g, device=device,
                              dtype=torch.int32)
        st = multi_signal_step(st, sampler(g, m), tp, prio,
                               refresh_states=(i % 5 == 0))
    return p, tp, st


def phase_inputs(st, m=64, masked=None, seed=0):
    """numpy signals, JAX winners, the lock key and its priorities."""
    sig = make_sampler("torus")(
        torch.Generator().manual_seed(100 + seed), m).numpy()
    wid, sid, d2b, _ = find_winners_reference(
        jnp.asarray(sig), jnp.asarray(st.w.numpy()),
        jnp.asarray(st.active.numpy()))
    k_lock = jax.random.key(7 + seed)
    mask = None if masked is None else np.arange(m) < masked
    return sig, wid, sid, d2b, k_lock, mask


def run_both(p, tp, st, sig, wid, sid, d2b, k_lock, mask, fn_j, fn_t, **kw):
    jst = to_jax_state(st)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else t(mask)
    out_j = fn_j(jst, jnp.asarray(sig), wid, sid, d2b, k_lock, p, jmask,
                 **kw)
    prio = lock_priorities(k_lock, sig.shape[0])
    out_t = fn_t(st, t(sig), t(wid), t(sid), t(d2b), prio, tp, tmask)
    return out_j, out_t


@pytest.mark.parametrize("masked", [None, 23])
@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_update_phase_op_matches_jax(model, masked):
    p, tp, st = grown_state(model)
    sig, wid, sid, d2b, k_lock, mask = phase_inputs(st, masked=masked)
    jst = to_jax_state(st)
    jmask = None if mask is None else jnp.asarray(mask)
    jargs = (jst, jnp.asarray(sig), wid, sid, d2b, k_lock, p, jmask)
    got = update_phase_op(st, t(sig), t(wid), t(sid), t(d2b),
                          lock_priorities(k_lock, sig.shape[0]), tp,
                          None if mask is None else t(mask))
    if masked is not None:
        assert not got.selected[masked:].any()
    for name, ref in (("pallas", jax_op(*jargs, interpret=True)),
                      ("dense", jax_dense(*jargs)),
                      ("reference", jax_reference(*jargs))):
        assert_update_out_match(ref, got, tag=f"{model} vs {name}")
        if model == "gng":   # one contributor per unit: exact
            np.testing.assert_array_equal(np.asarray(ref.error),
                                          got.error.numpy())


@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_reference_and_oracle_match_jax(model):
    p, tp, st = grown_state(model)
    inputs = phase_inputs(st, seed=1)
    for fn_j, fn_t in ((jax_reference, update_phase_reference),
                       (jax_dense, update_phase_dense)):
        out_j, out_t = run_both(p, tp, st, *inputs, fn_j, fn_t)
        assert_update_out_match(out_j, out_t, tag=f"{model} {fn_t.__name__}")


def test_last_collision_mode_matches_jax_reference():
    p, tp, st = grown_state("gwr", iters=10)
    p = JaxParams(model="gwr", insertion_threshold=0.3,
                  neighbor_collision="last")
    out_j, out_t = run_both(p, torch_params(p), st, *phase_inputs(st),
                            jax_reference, update_phase_reference)
    assert_update_out_match(out_j, out_t, tag="last")


def test_last_collision_mode_raises():
    _, _, st = grown_state("gwr", iters=5)
    tp = torch_params(JaxParams(model="gwr", neighbor_collision="last"))
    sig, wid, sid, d2b, k_lock, _ = phase_inputs(st)
    with pytest.raises(NotImplementedError, match="last"):
        update_phase_op(st, t(sig), t(wid), t(sid), t(d2b),
                        lock_priorities(k_lock, 64), tp)


def test_winner_lock_survivors_are_distinct():
    _, tp, st = grown_state("gwr", capacity=64, iters=10)
    # many signals, few units -> heavy winner collisions
    g = torch.Generator().manual_seed(5)
    sig = make_sampler("torus")(g, 256)
    wid, sid, d2b, _ = find_winners_reference_t(sig, st.w, st.active)
    prio = torch.randperm(256, generator=g, dtype=torch.int32)
    got = update_phase_op(st, sig, wid, sid, d2b, prio, tp)
    ref = update_phase_reference(st, sig, wid, sid, d2b, prio, tp)
    winners = wid[got.selected].tolist()
    assert 0 < len(winners) == len(set(winners))
    assert torch.equal(got.selected, ref.selected)


def test_cpu_tensors_take_the_plain_versions():
    _, tp, st = grown_state("soam", iters=8)
    sig, wid, sid, d2b, k_lock, _ = phase_inputs(st)
    counts = (winner_lock_min.launches, update_accum.launches,
              edge_age.launches)
    update_phase_op(st, t(sig), t(wid), t(sid), t(d2b),
                    lock_priorities(k_lock, 64), tp)
    assert (winner_lock_min.launches, update_accum.launches,
            edge_age.launches) == counts
