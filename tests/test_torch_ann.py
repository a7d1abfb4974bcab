"""``repro_torch.ann`` against ``repro.ann`` (the JAX package).

Mirrors ``tests/test_ann.py`` on the port, with the JAX functions run on
the same seeded numpy inputs:

* the exact rerank's tie contract, bitwise against the JAX rerank;
* the recall model, value for value;
* windowed: the winner always exact, the refined top-2 exact, bitwise
  the reference at ``n_windows >= capacity``, degenerate pools;
* grid: ``build_grid``'s buckets bitwise against JAX's, the search on a
  JAX-built aux, ``aux=None`` equal to a fresh aux, fixed against derived
  frames, an empty pool, the exact fallback when the stencil starves, the
  guard's ids on a dense surface;
* the stateful protocol through the step, ``indexed_scan`` and the fleet
  superstep at B = 3;
* runs: every ANN backend through ``multi`` and ``multi-fused``, and the
  ``Session`` rows of ``ann-windowed`` and ``ann-grid`` equal to the JAX
  ``Session``'s under the JAX draws.

Not mirrored: ``test_grid_guard_matches_reference_on_sparse_pools``,
which fails in the reference itself, and the ``slow`` acceptance gate,
which ``chip_smoke.py`` runs on the card.
"""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (JaxReplayDraws, assert_invariants,  # noqa: E402
                           jax_state_arrays, t, to_jax_state,
                           torch_params)
from repro import ann as jann  # noqa: E402
from repro import gson as jgson  # noqa: E402
from repro.core.gson.multi import \
    find_winners_reference as jax_reference  # noqa: E402
from repro.core.gson.state import GSONParams as JParams  # noqa: E402
from repro_torch import ann, convert, gson  # noqa: E402
from repro_torch.ann.grid import guarded_search  # noqa: E402
from repro_torch.core.gson import fleet as fleet_core  # noqa: E402
from repro_torch.core.gson.multi import (find_winners_reference,  # noqa: E402
                                         multi_signal_step)
from repro_torch.core.gson.sampling import make_sampler  # noqa: E402
from repro_torch.core.gson.state import init_state  # noqa: E402
from repro_torch.core.gson.superstep import SuperstepConfig  # noqa: E402

torch.set_num_threads(1)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _quantized(m, c, d, seed, frac_active, levels=4):
    """Coordinates on a tiny lattice (ties are common) and a duplicate
    unit, as numpy (signals, w, active)."""
    rng = np.random.default_rng(seed)
    sig = (rng.integers(0, levels, size=(m, d)) / 2.0).astype(np.float32)
    w = (rng.integers(0, levels, size=(c, d)) / 2.0).astype(np.float32)
    if c >= 2:
        w[c - 1] = w[0]
    act = rng.random(c) < frac_active
    if not act.any():
        act[0] = True
    return sig, w, act


def _random_pool(c, m, seed=0, frac_active=0.8, d=3):
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(c, d)).astype(np.float32)
    act = rng.random(c) < frac_active
    return sig, w, act


def _torch(*arrays):
    return tuple(t(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _surface(n_units, capacity, m, seed=0):
    """Units and signals on the sphere (the port's sampler), numpy."""
    sampler = make_sampler("sphere")
    g = torch.Generator().manual_seed(seed)
    w = np.zeros((capacity, 3), np.float32)
    w[:n_units] = sampler(g, n_units).numpy()
    act = np.arange(capacity) < n_units
    return sampler(g, m).numpy(), w, act


# ---------------------------------------------------------------------------
# recall model


def test_shortlist_size_inverts_birthday_model():
    assert ann.shortlist_size(0.95) == 20
    assert ann.expected_recall(20) >= 0.95
    assert ann.expected_recall(19) < 0.95


@pytest.mark.parametrize("r", [0.5, 0.8, 0.9, 0.95, 0.99, 0.999])
def test_recall_model_equals_jax(r):
    assert ann.shortlist_size(r) == jann.shortlist_size(r)
    assert ann.expected_recall(ann.shortlist_size(r)) >= r
    for k in (1, 2, 3):
        assert ann.shortlist_size(r, k) == jann.shortlist_size(r, k)
        assert ann.expected_recall(7, k) == jann.expected_recall(7, k)


def test_recall_model_validation():
    for bad in (lambda: ann.shortlist_size(1.0),
                lambda: ann.shortlist_size(0.0),
                lambda: ann.expected_recall(0),
                lambda: ann.WindowedFindWinners(n_windows=1),
                lambda: ann.GridFindWinners(fallback="nope"),
                lambda: ann.GridFindWinners(per_cell_cap=0)):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# exact rerank: the shared tie-break contract, bitwise against JAX


@pytest.mark.parametrize("d2,ids,want", [
    ([[1.0, 1.0, 2.0, 3.0]], [[7, 7, 3, 9]], (7, 3, 1.0, 2.0)),  # dup ids
    ([[5.0, 5.0, 5.0]], [[9, 2, 4]], (2, 4, 5.0, 5.0)),       # lowest id
    ([[3.0, np.inf, np.inf]], [[5, 1, 2]], (5, 5, 3.0, 3.0)),  # degenerate
    ([[-1e-7, 0.5, np.inf]], [[4, 2, 2 ** 30]], (4, 2, 0.0, 0.5)),  # clamp
])
def test_exact_top2_tie_trio_bitwise(d2, ids, want):
    d2 = np.asarray(d2, np.float32)
    ids = np.asarray(ids, np.int32)
    got = ann.exact_top2(t(d2), t(ids))
    ref = jann.exact_top2(jnp.asarray(d2), jnp.asarray(ids))
    for a, b in zip(got, ref):
        _eq(a.numpy(), b)
        assert a.dtype in (torch.int32, torch.float32)
    assert (int(got[0][0]), int(got[1][0]), float(got[2][0]),
            float(got[3][0])) == want


@pytest.mark.parametrize("m,s", [(1, 2), (7, 33), (64, 130), (37, 515)])
def test_exact_top2_bitwise_on_tied_candidate_sets(m, s):
    rng = np.random.default_rng(m * 100 + s)
    d2 = (rng.integers(0, 5, size=(m, s)) / 4.0).astype(np.float32)
    d2[rng.random((m, s)) < 0.3] = np.inf
    ids = rng.integers(0, s // 2 + 1, size=(m, s)).astype(np.int32)
    ids[rng.random((m, s)) < 0.1] = ann.rerank.BIG_ID
    got = ann.exact_top2(t(d2)[None], t(ids)[None])     # a batch of one
    for a, b in zip(got, jann.exact_top2(jnp.asarray(d2), jnp.asarray(ids))):
        _eq(a[0].numpy(), b)


# ---------------------------------------------------------------------------
# windowed backend


@pytest.mark.parametrize("m,c", [(1, 2), (7, 33), (37, 515), (100, 700),
                                 (5, 130)])
def test_windowed_full_windows_equal_reference_bitwise(m, c):
    sig, w, act = _quantized(m, c, 3, seed=m * 1000 + c, frac_active=0.7)
    ts = _torch(sig, w, act)
    got = ann.WindowedFindWinners(n_windows=max(c, 2))(*ts)
    ref = find_winners_reference(*ts)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    jref = jax_reference(*_jax(sig, w, act))
    _eq(got[0].numpy(), jref[0])
    _eq(got[1].numpy(), jref[1])


def test_windowed_winner_always_exact():
    sig, w, act = _random_pool(c=777, m=256, seed=1)
    ts = _torch(sig, w, act)
    ref = find_winners_reference(*ts)
    for r in (0.8, 0.95):
        fw = ann.WindowedFindWinners(n_windows=ann.shortlist_size(r),
                                     recall_target=r, refine=False)
        out = fw(*ts)
        assert torch.equal(out[0], ref[0])
        jout = jann.WindowedFindWinners(n_windows=ann.shortlist_size(r),
                                        recall_target=r, refine=False)(
            *_jax(sig, w, act))
        _eq(out[0].numpy(), jout[0])
        _eq(out[1].numpy(), jout[1])


@pytest.mark.parametrize("seed", range(3))
def test_windowed_refined_top2_is_exact(seed):
    sig, w, act = _random_pool(c=1000 + 37 * seed, m=256, seed=seed)
    ts = _torch(sig, w, act)
    out = ann.windowed_find_winners(0.95)(*ts)
    for a, b in zip(out, find_winners_reference(*ts)):
        assert torch.equal(a, b)
    jout = jann.windowed_find_winners(0.95)(*_jax(sig, w, act))
    _eq(out[0].numpy(), jout[0])
    _eq(out[1].numpy(), jout[1])


def test_windowed_recall_tracks_birthday_model():
    sig, w, act = _random_pool(c=2048, m=512, seed=2)
    ts = _torch(sig, w, act)
    ref = find_winners_reference(*ts)
    pref = torch.stack(ref[:2], 1).numpy()
    for r in (0.8, 0.95):
        out = ann.WindowedFindWinners(n_windows=ann.shortlist_size(r),
                                      refine=False)(*ts)
        pann = torch.stack(out[:2], 1).numpy()
        recall = np.mean([len(set(a) & set(b)) / 2.0
                          for a, b in zip(pref, pann)])
        assert recall >= r - 0.05, (r, recall)


@pytest.mark.parametrize("n_active", [0, 1, 2])
def test_windowed_handles_degenerate_pools(n_active):
    sig = np.zeros((4, 3), np.float32)
    w = np.ones((37, 3), np.float32)
    w[9] = 2.0
    act = np.zeros(37, bool)
    act[[5, 9][:n_active]] = True
    ts = _torch(sig, w, act)
    out = ann.windowed_find_winners(0.95)(*ts)
    for a, b in zip(out, find_winners_reference(*ts)):
        assert torch.equal(a, b)
    jout = jann.windowed_find_winners(0.95)(*_jax(sig, w, act))
    for a, b in zip(out, jout):
        _eq(a.numpy(), b)


def test_windowed_is_batched_per_network():
    pools = [_random_pool(c=300, m=64, seed=s) for s in range(3)]
    stacked = [t(np.stack(x)) for x in zip(*pools)]
    got = ann.windowed_find_winners(0.9)(*stacked)
    for b, pool in enumerate(pools):
        one = ann.windowed_find_winners(0.9)(*_torch(*pool))
        for a, c in zip(got, one):
            assert torch.equal(a[b], c)


# ---------------------------------------------------------------------------
# grid backend


def _aux_arrays(aux):
    return {k: np.asarray(getattr(aux, k))
            for k in ("origin", "cell", "sorted_units", "cell_start")}


@pytest.mark.parametrize("bbox", [None, ((-3.0,) * 3, (3.0,) * 3)])
@pytest.mark.parametrize("seed,frac", [(0, 0.8), (1, 0.3), (2, 1.0)])
def test_build_grid_buckets_bitwise(seed, frac, bbox):
    _, w, act = _random_pool(c=300, m=1, seed=seed, frac_active=frac)
    dims = (7, 7, 7)
    aux = ann.build_grid(t(w), t(act), dims, bbox=bbox)
    jaux = jann.build_grid(jnp.asarray(w), jnp.asarray(act), dims, bbox=bbox)
    for name, arr in _aux_arrays(jaux).items():
        _eq(getattr(aux, name).numpy(), arr, name)
    assert aux.dims == jaux.dims
    assert int(aux.cell_start[-1]) == int(act.sum())


def test_grid_aux_buckets_active_units_only():
    _, w, _ = _random_pool(c=64, m=1, seed=3)
    act = np.arange(64) < 40
    aux = ann.grid_find_winners(0.95).build(t(w), t(act))
    assert int(aux.cell_start[-1]) == 40
    assert set(aux.sorted_units[:40].tolist()) == set(range(40))


def test_grid_search_on_a_jax_built_aux_equals_jax():
    sig, w, act = _surface(1500, 2048, 512)
    jfw = jann.grid_find_winners(0.95)
    jaux = jfw.build(jnp.asarray(w), jnp.asarray(act))
    aux = convert.grid_aux_from_numpy(_aux_arrays(jaux), jaux.dims)
    kw = dict(per_cell_cap=jfw.per_cell_cap, n_anchors=jfw.n_anchors)
    got = ann.grid_search(aux, *_torch(sig, w, act), **kw)
    want = jann.grid_search(jaux, *_jax(sig, w, act), **kw)
    for a, b in zip(got, want):
        _eq(a.numpy(), b)


def test_grid_guard_top2_ids_exact_on_dense_surface():
    sig, w, act = _surface(2048, 2048, 512)
    ts = _torch(sig, w, act)
    calls, fires = guarded_search.calls, guarded_search.fires
    out = ann.grid_find_winners(0.95)(*ts)
    ref = find_winners_reference(*ts)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert guarded_search.calls == calls + 1
    jout = jann.grid_find_winners(0.95)(*_jax(sig, w, act))
    _eq(out[0].numpy(), jout[0])
    _eq(out[1].numpy(), jout[1])
    assert guarded_search.fires in (fires, fires + 1)


def test_grid_guard_selects_per_network():
    # network 0 dense (the guard passes), network 1 sparse (it fires):
    # each takes its own result, and the reference runs once
    dense = _surface(2048, 2048, 256, seed=0)
    sparse = list(_random_pool(c=2048, m=256, seed=4))
    sparse[2] = np.arange(2048) < 48
    batch = [t(np.stack(x)) for x in zip(dense, sparse)]
    fires = guarded_search.fires
    out = ann.grid_find_winners(0.95)(*batch)
    assert guarded_search.fires == fires + 1
    ref = find_winners_reference(*batch)
    assert torch.equal(out[0][0], ref[0][0])
    for a, b in zip(out, ref):
        assert torch.equal(a[1], b[1])


def test_grid_anchors_surface_recall():
    sig, w, act = _surface(1500, 2048, 512)
    ts = _torch(sig, w, act)
    ref = find_winners_reference(*ts)
    out = ann.GridFindWinners(per_cell_cap=24, n_anchors=64,
                              fallback="anchors", recall_target=0.95)(*ts)
    assert float((out[0] == ref[0]).float().mean()) >= 0.95


def test_grid_exact_fallback_matches_reference_when_stencil_starves():
    sig, w, act = _random_pool(c=256, m=64, seed=5, frac_active=0.2)
    ts = _torch(sig, w, act)
    out = ann.indexed_find_winners(grid_per_axis=64, per_cell_cap=4)(*ts)
    ref = find_winners_reference(*ts)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    jout = jann.indexed_find_winners(grid_per_axis=64, per_cell_cap=4)(
        *_jax(sig, w, act))
    _eq(out[0].numpy(), jout[0])
    _eq(out[1].numpy(), jout[1])


def test_grid_aux_none_equals_fresh_aux():
    sig, w, act = _random_pool(c=300, m=50, seed=6)
    ts = _torch(sig, w, act)
    for fw in (ann.grid_find_winners(0.95), ann.indexed_find_winners()):
        a = fw(*ts)
        b = fw(*ts, aux=fw.build(ts[1], ts[2]))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_grid_fixed_bbox_matches_derived_frame_results():
    sig, w, act = _surface(400, 512, 128)
    ts = _torch(sig, w, act)
    derived = ann.grid_find_winners(0.95, grid_per_axis=16)(*ts)
    fixed = ann.GridFindWinners(grid_per_axis=16, per_cell_cap=20,
                                n_anchors=64,
                                bbox=((-1.5,) * 3, (1.5,) * 3))(*ts)
    assert float((derived[0] == fixed[0]).float().mean()) >= 0.95


def test_build_grid_empty_pool_does_not_crash():
    aux = ann.build_grid(torch.zeros(16, 3), torch.zeros(16, dtype=bool),
                         (4, 4, 4))
    assert int(aux.cell_start[-1]) == 0
    jaux = jann.build_grid(jnp.zeros((16, 3)), jnp.zeros(16, bool),
                           (4, 4, 4))
    for name, arr in _aux_arrays(jaux).items():
        _eq(getattr(aux, name).numpy(), arr, name)


# ---------------------------------------------------------------------------
# the stateful protocol: step, indexed scan, fleet superstep


def _seeded(capacity=128, seed=0, n_seed=24):
    sampler = make_sampler("sphere")
    g = torch.Generator().manual_seed(seed)
    st = init_state(sampler(g, n_seed), capacity=capacity, max_deg=16,
                    init_threshold=0.35)
    return st, sampler, g


def test_step_fw_aux_matches_internal_rebuild():
    st, sampler, g = _seeded()
    p = torch_params(JParams(model="soam", insertion_threshold=0.35))
    sig = sampler(g, 32)
    prio = torch.randperm(32, generator=g, dtype=torch.int32)
    fw = ann.grid_find_winners(0.95)
    a = multi_signal_step(st, sig, p, prio, refresh_states=False,
                          find_winners=fw)
    b = multi_signal_step(st, sig, p, prio, refresh_states=False,
                          find_winners=fw, fw_aux=fw.build(st.w, st.active))
    for name in convert.FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_indexed_scan_matches_jax():
    st, sampler, g = _seeded(n_seed=2)
    jp = JParams(model="soam", insertion_threshold=0.35)
    sig = sampler(g, 128)
    box = ((-3.0,) * 3, (3.0,) * 3)
    fw = ann.GridFindWinners(grid_per_axis=12, per_cell_cap=24,
                             n_anchors=0, fallback="exact", bbox=box)
    out = ann.indexed_scan(st, sig, torch_params(jp), fw, rebuild_every=32,
                           refresh_every=50)
    assert int(out.n_active) > 2 and int(out.signal_count) == 128
    jfw = jann.GridFindWinners(grid_per_axis=12, per_cell_cap=24,
                               n_anchors=0, fallback="exact", bbox=box)
    jout = jann.indexed_scan(to_jax_state(st), jnp.asarray(sig.numpy()), jp,
                             jfw, rebuild_every=32, refresh_every=50)
    got = convert.state_to_numpy(out)
    for name in ("active", "nbr", "n_active", "signal_count", "topo_state"):
        _eq(got[name], jax_state_arrays(jout)[name], name)
    np.testing.assert_allclose(got["w"], np.asarray(jout.w), rtol=1e-5,
                               atol=1e-6)
    assert_invariants(got["nbr"], got["age"], got["active"])


def test_fleet_superstep_with_stateful_backend_at_b3():
    p = torch_params(JParams(model="soam", insertion_threshold=0.35))
    cfg = SuperstepConfig(length=30, refresh_every=5,
                          check_every=10).resolve(96, p)
    sampler = make_sampler("sphere")
    draws = [gson.TorchDraws(s, "cpu", sampler) for s in range(3)]
    fs, probes = fleet_core.fleet_init(
        draws, capacity=96, dim=3, max_deg=16, n_probe=128,
        init_threshold=0.35, device="cpu")
    fw = ann.grid_find_winners(0.95)
    built = []
    orig = ann.GridFindWinners.build

    def count_build(self, w, active):
        built.append(w.shape[0])
        return orig(self, w, active)
    ann.GridFindWinners.build = count_build
    try:
        fs, steps = fleet_core.run_fleet_superstep(
            fs, probes, np.array([30, 30, 12]), draws, params=p, cfg=cfg,
            find_winners=fw)
    finally:
        ann.GridFindWinners.build = orig
    assert steps.tolist() == [30, 30, 12]
    # one build at entry, one per refresh cadence (every 5 iterations)
    assert built == [3] * (1 + 30 // 5)
    assert bool(fleet_core.fleet_health(fs.nets).all())
    assert (fs.nets.n_active > 2).all()
    for b in range(3):
        assert_invariants(fs.nets.nbr[b].numpy(), fs.nets.age[b].numpy(),
                          fs.nets.active[b].numpy())


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_ann_grid_fleet_equals_sessions(variant):
    spec = gson.RunSpec(variant=variant, backend="ann-grid", capacity=96,
                        max_iterations=25, device="cpu")
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(3)))
    fleet.run()
    for i in range(3):
        sess = gson.Session(spec, seed=i)
        sess.run()
        st, stats = fleet.result(i)
        assert [{k: v for k, v in r.items() if k != "network"}
                for r in stats.history] == sess.stats.history
        for name in convert.FIELDS:
            assert torch.equal(getattr(st, name),
                               getattr(sess.state, name)), (i, name)


# ---------------------------------------------------------------------------
# registry and runs


def test_ann_backends_registered():
    assert {"ann-windowed", "ann-grid", "indexed"} <= set(gson.BACKENDS)
    b = gson.resolve_backend("ann-grid")
    assert b.find_winners.stateful and b.find_winners.fallback == "guard"
    assert b.update_phase is None
    assert gson.resolve_backend("ann-windowed").find_winners.recall_target \
        == 0.95
    assert gson.resolve_backend("indexed").find_winners.fallback == "exact"
    jb = jgson.resolve_backend("ann-grid").find_winners
    assert b.find_winners.per_cell_cap == jb.per_cell_cap
    assert b.find_winners.dims_for(32768) == jb.dims_for(32768) == (45,) * 3


def test_backend_instances_are_shared():
    a = gson.resolve_backend("ann-windowed").find_winners
    assert a is gson.resolve_backend("ann-windowed").find_winners
    assert a is gson.ann_backend("ann-windowed", 0.95).find_winners
    assert hash(a) == hash(ann.windowed_find_winners(0.95))


def test_ann_backend_custom_recall():
    b = gson.ann_backend("ann-windowed", 0.99)
    assert b.find_winners.n_windows == ann.shortlist_size(0.99)
    assert gson.ann_backend("ann-grid", 0.8).find_winners.recall_target == 0.8
    with pytest.raises(KeyError):
        gson.ann_backend("reference", 0.95)


@pytest.mark.parametrize("backend", ["ann-windowed", "ann-grid", "indexed"])
@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_runspec_smoke(backend, variant):
    spec = gson.RunSpec(variant=variant, model="soam", sampler="sphere",
                        backend=backend, capacity=96, max_iterations=30,
                        max_signals=100_000, device="cpu")
    state, stats = gson.run(spec, seed=0)
    assert int(state.n_active) > 2
    assert stats.iterations > 0


ROW_SPEC = dict(model="soam", sampler="sphere", capacity=96,
                max_iterations=30, check_every=10, n_probe=256)


@pytest.mark.parametrize("backend", ["ann-windowed", "ann-grid"])
@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_session_rows_match_jax_under_jax_draws(backend, variant):
    jsess = jgson.Session(jgson.RunSpec(variant=variant, backend=backend,
                                        **ROW_SPEC), seed=5)
    jsess.run()
    sess = gson.Session(gson.RunSpec(variant=variant, backend=backend,
                                     device="cpu", **ROW_SPEC),
                        JaxReplayDraws("sphere", seed=5))
    sess.run()
    rows, jrows = sess.stats.history, jsess.stats.history
    assert len(rows) == len(jrows) > 0
    for row, jrow in zip(rows, jrows):
        assert (row["iteration"], row["units"], row["signals"]) == (
            jrow["iteration"], jrow["units"], jrow["signals"])
        assert row["qe"] == pytest.approx(jrow["qe"], rel=1e-5, abs=1e-7)
    _eq(sess.state.nbr.numpy(), jsess.result()[0].nbr)
