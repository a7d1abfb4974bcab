"""The port's topology ops against ``repro.core.gson.topology``, bitwise.

Random symmetric pools made with numpy from a seed go through each JAX
function and its PyTorch counterpart; every output must match exactly.
Also mirrors ``tests/test_topology.py`` (the SOAM state ladder on
hand-built graphs) and the structural invariants of
``tests/test_gson_invariants.py`` (symmetry, dedup, degree overflow).
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_invariants, t  # noqa: E402
from repro.core.gson import topology as jtopo  # noqa: E402
from repro_torch.core.gson import topology as topo  # noqa: E402
from repro_torch.core.gson.state import (CONNECTED, HABITUATED,  # noqa: E402
                                         HALF_DISK, PATCH, SINGULAR)

torch.set_num_threads(1)


def random_pool(seed: int, C: int = 64, K: int = 8, n_edges: int = 150):
    """Symmetric (nbr, age, active, firing): edges at random free slots
    with whole-number ages, about a tenth of the units inactive."""
    rng = np.random.default_rng(seed)
    nbr = np.full((C, K), -1, np.int32)
    age = np.zeros((C, K), np.float32)
    active = rng.random(C) > 0.1
    ids = np.nonzero(active)[0]
    for _ in range(n_edges):
        a, b = rng.choice(ids, 2, replace=False)
        if b in nbr[a]:
            continue
        fa, fb = np.nonzero(nbr[a] < 0)[0], np.nonzero(nbr[b] < 0)[0]
        if fa.size == 0 or fb.size == 0:
            continue
        sa, sb = rng.choice(fa), rng.choice(fb)
        nbr[a, sa], nbr[b, sb] = b, a
        age[a, sa] = age[b, sb] = float(rng.integers(0, 40))
    firing = np.where(rng.random(C) < 0.8, 0.05, 1.0).astype(np.float32)
    return nbr, age, active, firing


def random_batch(seed: int, C: int, m: int, nbr=None):
    """(a, b, mask) with duplicates, self pairs, existing edges, and
    out-of-range rows."""
    rng = np.random.default_rng(seed + 1000)
    a = rng.integers(0, C, m).astype(np.int32)
    b = rng.integers(0, C, m).astype(np.int32)
    b[: m // 8] = a[: m // 8]                          # self pairs
    a[m // 8: m // 4] = a[m // 4: m // 4 + m // 8]     # duplicates
    b[m // 8: m // 4] = b[m // 4: m // 4 + m // 8]
    if nbr is not None:                                # existing edges
        for i in range(m // 4 + m // 8, m // 2):
            row = nbr[a[i]]
            if np.any(row >= 0):
                b[i] = row[row >= 0][0]
    mask = rng.random(m) < 0.85
    return a, b, mask


def both(fn_j, fn_t, *arrays):
    """Run the JAX and the port function on the same numpy inputs."""
    out_j = jax.jit(fn_j)(*[jnp.asarray(x) for x in arrays])
    out_t = fn_t(*[t(x) for x in arrays])
    return out_j, out_t


def assert_same(out_j, out_t):
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    assert len(out_j) == len(out_t)
    for x, y in zip(out_j, out_t):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_find_slots_and_rank_bitwise(seed):
    nbr, _, _, _ = random_pool(seed)
    C = nbr.shape[0]
    a, b, _ = random_batch(seed, C, 48, nbr)
    rows = np.where(np.arange(48) % 7 == 0, -1, a).astype(np.int32)
    rows[3] = C + 2
    assert_same(*both(jtopo.find_slots, topo.find_slots, nbr, rows, b))
    rr = np.random.default_rng(seed).integers(0, 9, 40).astype(np.int32)
    rr[::5] = 2 ** 30
    assert_same(*both(jtopo._rank_within_rows, topo._rank_within_rows, rr))


@pytest.mark.parametrize("seed,K", [(0, 8), (1, 8), (2, 16), (3, 16)])
def test_insert_edges_bitwise(seed, K):
    # dense pools so that some inserts overflow a row and are dropped
    nbr, age, _, _ = random_pool(seed, K=K, n_edges=40 * K)
    a, b, mask = random_batch(seed, nbr.shape[0], 48, nbr)
    out_j, out_t = both(jtopo.insert_edges, topo.insert_edges, nbr, age,
                        a, b, mask)
    assert_same(out_j, out_t)
    assert_invariants(out_t[0].numpy(), out_t[1].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_remove_and_reset_bitwise(seed):
    nbr, age, _, _ = random_pool(seed)
    a, b, mask = random_batch(seed, nbr.shape[0], 48, nbr)
    out_j, out_t = both(jtopo.remove_edge_pairs, topo.remove_edge_pairs,
                        nbr, age, a, b, mask)
    assert_same(out_j, out_t)
    assert_invariants(out_t[0].numpy(), out_t[1].numpy())
    assert_same(*both(jtopo.reset_edge_ages, topo.reset_edge_ages, nbr,
                      age, a, b, mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_age_incident_edges_bitwise(seed):
    nbr, age, active, _ = random_pool(seed)
    C = nbr.shape[0]
    rng = np.random.default_rng(seed)
    winners = rng.choice(C, 24, replace=False).astype(np.int32)
    mask = rng.random(24) < 0.8
    protect = rng.random(C) < 0.3
    out_j, out_t = both(
        lambda n, a, w, m, p: jtopo.age_incident_edges(n, a, w, m,
                                                       protect=p),
        lambda n, a, w, m, p: topo.age_incident_edges(n, a, w, m,
                                                      protect=p),
        nbr, age, winners, mask, protect)
    assert_same(out_j, out_t)
    assert_invariants(nbr, out_t.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_expire_prune_drop_bitwise(seed):
    nbr, age, active, firing = random_pool(seed)
    assert_same(*both(lambda n, a: jtopo.expire_edges(n, a, 30.0),
                      lambda n, a: topo.expire_edges(n, a, 30.0), nbr, age))
    assert_same(*both(jtopo.prune_isolated, topo.prune_isolated, active,
                      nbr, firing))
    assert_same(*both(jtopo.drop_edges_to_inactive,
                      topo.drop_edges_to_inactive, nbr, age, active))
    assert_same(*both(jtopo.degrees, topo.degrees, nbr))


@pytest.mark.parametrize("seed,K,n_edges", [(0, 8, 150), (1, 8, 260),
                                            (2, 16, 640), (3, 16, 500)])
def test_compute_topo_states_bitwise(seed, K, n_edges):
    nbr, _, active, firing = random_pool(seed, K=K, n_edges=n_edges)
    assert_same(*both(lambda n, a, f: jtopo.compute_topo_states(n, a, f, 0.3),
                      lambda n, a, f: topo.compute_topo_states(n, a, f, 0.3),
                      nbr, active, firing))


# ---------------------------------------------------------------------------
# the SOAM ladder on hand-built graphs (mirrors tests/test_topology.py)

def _build(n, edges, cap=64, K=8):
    nbr = np.full((cap, K), -1, np.int32)
    for a, b in edges:
        for x, y in ((a, b), (b, a)):
            nbr[x, np.nonzero(nbr[x] < 0)[0][0]] = y
    active = np.zeros((cap,), bool)
    active[:n] = True
    firing = np.where(active, 0.05, 1.0).astype(np.float32)
    return nbr, active, firing


_OPP = {0: 1, 1: 0, 2: 3, 3: 2, 4: 5, 5: 4}
LADDER = {
    "isolated": (1, [], 0, HABITUATED),
    "half_disk": (4, [(0, 1), (0, 2), (0, 3), (1, 2), (2, 3)], 0,
                  HALF_DISK),
    "tetrahedron_patch": (4, [(a, b) for a in range(4)
                              for b in range(a + 1, 4)], 0, PATCH),
    "octahedron_patch": (6, [(a, b) for a in range(6)
                             for b in range(a + 1, 6) if _OPP[a] != b], 0,
                         PATCH),
    "disconnected": (5, [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (3, 4)], 0,
                     CONNECTED),
    "overlinked": (5, [(0, i) for i in (1, 2, 3, 4)]
                   + [(1, 2), (1, 3), (1, 4), (2, 3), (3, 4), (2, 4)], 0,
                   SINGULAR),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_ladder_on_hand_built_graphs(case):
    n, edges, unit, expected = LADDER[case]
    nbr, active, firing = _build(n, edges)
    st_j, st_t = both(lambda a, b, c: jtopo.compute_topo_states(a, b, c, 0.3),
                      lambda a, b, c: topo.compute_topo_states(a, b, c, 0.3),
                      nbr, active, firing)
    assert_same(st_j, st_t)
    assert int(st_t[unit]) == expected


# ---------------------------------------------------------------------------
# invariants (mirrors tests/test_gson_invariants.py)

@pytest.mark.parametrize("seed", range(3))
def test_insert_remove_expire_preserve_symmetry(seed):
    C, K = 64, 8
    nbr = torch.full((C, K), -1, dtype=torch.int32)
    age = torch.zeros((C, K))
    for step in range(4):
        a, b, mask = random_batch(seed * 10 + step, C, 24)
        nbr, age, _ = topo.insert_edges(nbr, age, t(a), t(b), t(mask))
        assert_invariants(nbr.numpy(), age.numpy())
        nbr, age = topo.remove_edge_pairs(nbr, age, t(a[:6]), t(b[:6]),
                                          t(mask[:6]))
        assert_invariants(nbr.numpy(), age.numpy())
        age = age + 7.0 * float(step)
        nbr, age, _ = topo.expire_edges(nbr, age, 30.0)
        assert_invariants(nbr.numpy(), age.numpy())


def test_insert_duplicate_edges_idempotent():
    nbr = torch.full((8, 4), -1, dtype=torch.int32)
    age = torch.zeros((8, 4))
    a = torch.tensor([1, 1, 2, 1], dtype=torch.int32)
    b = torch.tensor([2, 2, 1, 2], dtype=torch.int32)
    nbr, age, dropped = topo.insert_edges(nbr, age, a, b,
                                          torch.ones(4, dtype=torch.bool))
    assert int(dropped) == 0
    assert (nbr[1] == 2).sum() == 1 and (nbr[2] == 1).sum() == 1
    assert_invariants(nbr.numpy(), age.numpy())


def test_degree_overflow_drops_and_counts():
    K = 3
    nbr = torch.full((8, K), -1, dtype=torch.int32)
    age = torch.zeros((8, K))
    a = torch.zeros((5,), dtype=torch.int32)
    b = torch.arange(1, 6, dtype=torch.int32)
    nbr, age, dropped = topo.insert_edges(nbr, age, a, b,
                                          torch.ones(5, dtype=torch.bool))
    assert int(dropped) == 2
    assert int((nbr[0] >= 0).sum()) == K
    assert_invariants(nbr.numpy(), age.numpy())
