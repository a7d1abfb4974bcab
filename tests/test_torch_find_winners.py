"""The port's Find Winners against the JAX package's.

On the CPU the port's ``find_winners_op`` runs the kernel's plain
version; it is held against the Pallas kernel in interpret mode
(``repro.kernels.find_winners.ops.find_winners_op(interpret=True)``),
the JAX direct-difference oracle and the engine reference. Ids must
match bitwise wherever the three nearest distances are more than 1e-4
apart (near-ties may flip under float32 rounding of the two distance
formulas); distances within rtol=2e-4, atol=1e-5, the tolerance of
``tests/test_kernels_find_winners.py``. The CUDA kernel itself is held
against the plain version in ``tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import near_tie_free, t  # noqa: E402
from repro.core.gson.multi import \
    find_winners_reference as jax_reference  # noqa: E402
from repro.kernels.find_winners.ops import \
    find_winners_op as jax_op  # noqa: E402
from repro.kernels.find_winners.ref import \
    find_winners_ref as jax_ref  # noqa: E402
from repro_torch.core.gson.multi import find_winners_reference  # noqa: E402
from repro_torch.kernels.find_winners import (  # noqa: E402
    cuda_find_winners, find_winners_op, find_winners_ref, find_winners_top2,
    find_winners_top2_plain)

torch.set_num_threads(1)
D_TOL = dict(rtol=2e-4, atol=1e-5)


def _inputs(m, c, d, seed=0, frac_active=0.7):
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(c, d)).astype(np.float32)
    act = rng.random(c) < frac_active
    act[rng.integers(0, c)] = True
    return sig, w, act


@pytest.mark.parametrize("m,c,d", [(1, 2, 3), (7, 33, 3), (64, 512, 3),
                                   (513, 100, 4), (40, 300, 8)])
def test_matches_pallas_kernel_and_oracles(m, c, d):
    sig, w, act = _inputs(m, c, d)
    d2t, idt = find_winners_op(t(sig), t(w), t(act))
    d2k, idk = jax_op(jnp.asarray(sig), jnp.asarray(w), jnp.asarray(act),
                      interpret=True)
    d2r, idr = jax_ref(jnp.asarray(sig), jnp.asarray(w), jnp.asarray(act))
    d2o, ido = find_winners_ref(t(sig), t(w), t(act))
    ok = near_tie_free(sig, w, act)
    assert ok.mean() > 0.9
    for ids in (idk, idr, ido):
        np.testing.assert_array_equal(np.asarray(ids)[ok], idt.numpy()[ok])
    for d2 in (d2k, d2r, d2o):
        np.testing.assert_allclose(np.asarray(d2), d2t.numpy(), **D_TOL)


def test_ties_break_to_lowest_id():
    sig = torch.zeros((1, 3))
    w = torch.zeros((8, 3))                    # all equidistant
    _d2, ids = find_winners_op(sig, w, torch.ones(8, dtype=torch.bool))
    assert ids[0].tolist() == [0, 1]
    _d2, ids = find_winners_ref(sig, w, torch.ones(8, dtype=torch.bool))
    assert ids[0].tolist() == [0, 1]


@pytest.mark.parametrize("c", [1, 16])
def test_single_active_unit_wins_both_slots(c):
    sig = torch.zeros((4, 3))
    w = torch.ones((c, 3))
    act = torch.zeros((c,), dtype=torch.bool)
    act[c // 2] = True
    d2, ids = find_winners_op(sig, w, act)
    assert (ids == c // 2).all()
    np.testing.assert_array_equal(d2[:, 0].numpy(), d2[:, 1].numpy())


def test_adapter_matches_engine_reference():
    sig, w, act = _inputs(32, 128, 3, seed=3, frac_active=0.8)
    got = cuda_find_winners(t(sig), t(w), t(act))
    ref = find_winners_reference(t(sig), t(w), t(act))
    jref = jax_reference(jnp.asarray(sig), jnp.asarray(w), jnp.asarray(act))
    ok = near_tie_free(sig, w, act)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy()[ok],
                                      ref[i].numpy()[ok])
        np.testing.assert_array_equal(np.asarray(jref[i]), ref[i].numpy())
    for i in range(2, 4):
        np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(), **D_TOL)
        np.testing.assert_allclose(np.asarray(jref[i]), ref[i].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    sig, w, act = _inputs(9, 40, 3)
    before = find_winners_top2.launches
    out = find_winners_top2(t(sig)[None], t(w)[None], t(act)[None])
    plain = find_winners_top2_plain(t(sig)[None], t(w)[None], t(act)[None])
    assert find_winners_top2.launches == before
    for x, y in zip(out, plain):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_plain_version_is_batched():
    """B networks in one call give each network's own answer."""
    parts = [_inputs(20, 50, 3, seed=s) for s in range(3)]
    sig, w, act = (torch.stack([t(p[i]) for p in parts]) for i in range(3))
    d2, ids = find_winners_top2_plain(sig, w, act)
    for b in range(3):
        d2b, idb = find_winners_top2_plain(sig[b:b + 1], w[b:b + 1],
                                           act[b:b + 1])
        np.testing.assert_array_equal(ids[b].numpy(), idb[0].numpy())
        np.testing.assert_array_equal(d2[b].numpy(), d2b[0].numpy())
