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
The kernel's first launch, the packing of the active units, is held
here in plain PyTorch against a numpy reckoning, and a scan of the
packed rows alone against the Pallas kernel.
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
    compact_active, compact_active_plain, cuda_find_winners, find_winners_op,
    find_winners_ref, find_winners_top2, find_winners_top2_plain, regime)
from repro_torch.kernels.find_winners.kernel import (  # noqa: E402
    FEW_MAX_SIGNALS, padded_dim, workspace_words)

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


# ---------------------------------------------------------------------------
# The kernel's first step, the packing of the active units, in plain
# PyTorch (the CUDA launch is held against it bitwise on the card), and
# the choice between the scan's two regimes.

def _numpy_packing(w, act):
    """ids, |w|^2 (float32, summed in k order) and count, per network."""
    out = []
    for wb, ab in zip(w, act):
        ids = np.flatnonzero(ab)
        sq = np.zeros(len(ids), np.float32)
        for k in range(wb.shape[1]):
            sq = (sq + wb[ids, k] * wb[ids, k]).astype(np.float32)
        out.append((ids, sq))
    return out


@pytest.mark.parametrize("B,c,d,frac", [(1, 64, 3, 0.3), (3, 100, 5, 0.7),
                                        (2, 33, 8, 0.5), (1, 40, 1, 1.0),
                                        (2, 9, 4, 0.0)])
def test_compact_active_plain_matches_numpy(B, c, d, frac):
    rng = np.random.default_rng(B * 100 + c)
    w = rng.normal(size=(B, c, d)).astype(np.float32)
    act = rng.random((B, c)) < frac
    packed, ids, count = compact_active_plain(t(w), t(act))
    dp = padded_dim(d)
    assert packed.shape == (B, c, dp) and packed.dtype == torch.float32
    assert ids.shape == (B, c) and ids.dtype == torch.int32
    assert count.dtype == torch.int32
    for b, (want_ids, want_sq) in enumerate(_numpy_packing(w, act)):
        n = len(want_ids)
        assert int(count[b]) == n
        np.testing.assert_array_equal(ids[b, :n].numpy(), want_ids)
        np.testing.assert_array_equal(packed[b, :n, :d].numpy(),
                                      w[b, want_ids])
        np.testing.assert_array_equal(packed[b, :n, d].numpy(), want_sq)
        assert not packed[b, :n, d + 1:].any()
        assert not packed[b, n:].any() and (ids[b, n:] == -1).all()


@pytest.mark.parametrize("n_active", [0, 1])
def test_compact_active_plain_on_degenerate_pools(n_active):
    """Pools of 0 and 1 active units: the count the kernel's scan reads
    to fall back to every unit, and at most one packed row."""
    w = torch.arange(24, dtype=torch.float32).reshape(1, 8, 3)
    act = torch.zeros((1, 8), dtype=torch.bool)
    act[0, 5:5 + n_active] = True
    packed, ids, count = compact_active_plain(w, act)
    assert count.tolist() == [n_active]
    assert ids[0].tolist() == [5] * n_active + [-1] * (8 - n_active)
    if n_active:
        assert packed[0, 0].tolist() == [15.0, 16.0, 17.0,
                                         15.0 * 15 + 16 * 16 + 17 * 17]
    assert not packed[0, n_active:].any()


@pytest.mark.parametrize("m,c,d,frac,seed", [(64, 512, 3, 0.1, 0),
                                             (33, 300, 4, 0.7, 1),
                                             (7, 1000, 8, 0.02, 2),
                                             (1, 4096, 3, 0.07, 3)])
def test_scan_of_packed_rows_matches_pallas_kernel(m, c, d, frac, seed):
    """The kernel's design in plain PyTorch: the distances of the packed
    rows alone (|w|^2 from the pad lane), the top-2 by (distance, row),
    rows mapped to ids at the end; the JAX package's Pallas kernel
    (interpret mode) gives the same winners and distances."""
    sig, w, act = _inputs(m, c, d, seed=seed, frac_active=frac)
    packed, ids, count = compact_active_plain(t(w)[None], t(act)[None])
    n = int(count[0])
    rows = packed[0, :n]
    x = t(sig)
    d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * x @ rows[:, :d].T
          + rows[:, d]).clamp(min=0.0)
    top = torch.sort(d2, dim=1, stable=True)
    got_ids = ids[0][top.indices[:, :2]]
    d2k, idk = jax_op(jnp.asarray(sig), jnp.asarray(w), jnp.asarray(act),
                      interpret=True)
    ok = near_tie_free(sig, w, act)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(idk)[ok], got_ids.numpy()[ok])
    np.testing.assert_allclose(np.asarray(d2k), top.values[:, :2].numpy(),
                               **D_TOL)


@pytest.mark.parametrize("B,M,want", [
    (1, 1, "few"),               # the single path, one signal per step
    (4, 1, "few"),
    (1, 33, "few"),
    (1, FEW_MAX_SIGNALS, "few"),
    (1, FEW_MAX_SIGNALS + 1, "many"),
    (8, FEW_MAX_SIGNALS // 8, "few"),
    (8, FEW_MAX_SIGNALS // 8 + 1, "many"),
    (1, 8192, "many"),           # the main path's buffer, at any capacity
    (8, 8192, "many"),           # a fleet
])
def test_regime_choice(B, M, want):
    assert regime(B, M) == want


def test_packed_row_width():
    assert [padded_dim(d) for d in range(1, 9)] == [4, 4, 4, 8, 8, 8, 8, 12]
    assert workspace_words(2, 10, 3) == 2 * (10 * 4 + 12 + 1)
    assert workspace_words(1, 4096, 3) == 4096 * 5 + 1


def test_compact_active_has_no_cpu_version():
    """The packing launch takes CUDA tensors only; nothing hands a CPU
    tensor to a plain version behind the caller's back."""
    w = torch.zeros((1, 8, 3))
    act = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="expected a tensor on"):
        compact_active(w, act)
