"""The port's fleet API: B networks through one batched program.

Mirrors ``tests/test_fleet.py`` on the CPU at its sizes (capacity 128,
K = 12, 40–48 iterations):

  * a B = 8 ``FleetSession`` equals 8 ``Session``s — every state field,
    the stats and the history rows — for ``multi`` and ``multi-fused``;
  * at B = 3 under one ``JaxReplayDraws`` per network it equals the JAX
    ``FleetSession``: history rows (``qe`` within 1e-6), discrete fields
    bitwise, floats within 1e-6. (The JAX file's heterogeneous-sampler
    case fails in the reference itself, ROADMAP §C, so it is held against
    the port's own sessions only);
  * cohorts, per-network budgets, the non-fleet variant, topology
    invariants per network, stack/unstack, streaming, pause/resume and
    checkpoint/restore, as in the JAX file;
  * the health screen quarantines a poisoned network and leaves its
    cohort-mates bit-identical to an undisturbed run;
  * ``convert`` carries a JAX ``FleetState`` across.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import assert_invariants
from repro_torch import convert, gson
from repro_torch.core.gson import fleet as fleet_core
from repro_torch.core.gson.state import (GSONParams, init_state,
                                         stack_states, unstack_states)

torch.set_num_threads(1)

SURFACES = ("sphere", "torus", "eight", "trefoil")

STATE_FIELDS = ("w", "active", "nbr", "age", "error", "firing",
                "threshold", "topo_state", "inconsistent_for",
                "n_active", "signal_count", "discarded")
DISCRETE = ("active", "nbr", "age", "topo_state", "inconsistent_for",
            "n_active", "signal_count", "discarded")
FLOATS = ("w", "error", "firing", "threshold")
GWR = dict(model="gwr", insertion_threshold=0.5)


def short_spec(variant="multi", **kw) -> gson.RunSpec:
    base = dict(
        variant=variant, model=GSONParams(**GWR), sampler="sphere",
        capacity=128, max_deg=12, max_iterations=40, check_every=10,
        qe_threshold=1e-9, n_probe=256, device="cpu")
    base.update(kw)
    return gson.RunSpec(**base)


def assert_states_equal(a, b, ctx=""):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{ctx}: field {name!r} differs"


def rows(history):
    return [(r["iteration"], r["units"], r["signals"], r["qe"])
            for r in history]


# ---------------------------------------------------------------------------
# fleet == B sessions


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_equals_sessions(variant):
    spec = short_spec(variant)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(8)))
    assert len(fleet.cohorts) == 1      # one batched program for all 8
    fleet.run()
    for i in range(8):
        sess = gson.Session(spec, seed=i)
        sess.run()
        st_s, stats_s = sess.result()
        st_f, stats_f = fleet.result(i)
        assert_states_equal(st_s, st_f, f"{variant} network {i}")
        for key in ("iterations", "units", "signals", "discarded",
                    "connections", "converged", "quantization_error"):
            assert getattr(stats_s, key) == getattr(stats_f, key), key
        assert rows(stats_s.history) == rows(stats_f.history)
        assert {r["network"] for r in stats_f.history} == {i}


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX FleetSession at B = 3 (reference backend), per variant."""
    pytest.importorskip("jax")
    from repro import gson as jgson
    from repro.core.gson.state import GSONParams as JParams

    def run(variant):
        spec = jgson.RunSpec(variant=variant, model=JParams(**GWR),
                             sampler="sphere", capacity=128, max_deg=12,
                             max_iterations=40, check_every=10,
                             qe_threshold=1e-9, n_probe=256)
        fleet = jgson.FleetSession(jgson.FleetSpec.broadcast(
            spec, seeds=range(3)))
        fleet.run()
        return fleet
    return run


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_matches_jax_fleet_under_jax_draws(jax_fleet, variant):
    from _torch_parity import JaxReplayDraws
    jfleet = jax_fleet(variant)
    fleet = gson.FleetSession(
        gson.FleetSpec.broadcast(short_spec(variant), seeds=range(3)),
        draws=[JaxReplayDraws("sphere", seed=i) for i in range(3)])
    fleet.run()
    for i in range(3):
        jst, jstats = jfleet.result(i)
        st, stats = fleet.result(i)
        assert len(stats.history) == len(jstats.history) > 0
        for row, jrow in zip(stats.history, jstats.history):
            assert (row["network"], row["iteration"], row["units"],
                    row["signals"]) == (jrow["network"], jrow["iteration"],
                                        jrow["units"], jrow["signals"])
            assert row["qe"] == pytest.approx(jrow["qe"], rel=1e-6)
        got = convert.state_to_numpy(st)
        for name in DISCRETE:
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(jst, name)),
                f"network {i} {name}")
        for name in FLOATS:
            np.testing.assert_allclose(
                got[name], np.asarray(getattr(jst, name)), rtol=1e-6,
                atol=1e-7, err_msg=f"network {i} {name}")


def test_heterogeneous_samplers_equal_their_own_sessions():
    # one sampler per network, same pool shape -> ONE cohort; each
    # network equals its own single-surface session
    spec = short_spec("multi-fused", max_iterations=20)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(
        spec, seeds=range(len(SURFACES)), samplers=SURFACES))
    assert len(fleet.cohorts) == 1
    fleet.run()
    for i, surf in enumerate(SURFACES):
        sess = gson.Session(spec.replace(sampler=surf), seed=i)
        sess.run()
        assert_states_equal(sess.result()[0], fleet.result(i)[0],
                            f"surface {surf}")


# ---------------------------------------------------------------------------
# cohorts and per-network freezing


def test_mixed_shapes_make_one_cohort_each():
    fs = gson.FleetSpec(
        (short_spec(), short_spec(capacity=64), short_spec()), (0, 1, 2))
    fleet = gson.FleetSession(fs)
    assert len(fleet.cohorts) == 2
    fleet.run()
    assert list(fleet.iterations) == [40, 40, 40]
    assert fleet.network(1).capacity == 64


def test_per_network_budgets_freeze_within_cohort():
    # different max_iterations in ONE cohort: finished networks freeze
    # (equal to their own shorter session) while the others run on
    specs = tuple(short_spec("multi-fused", max_iterations=n)
                  for n in (12, 40, 24))
    fleet = gson.FleetSession(gson.FleetSpec(specs, (0, 1, 2)))
    assert len(fleet.cohorts) == 1      # run limits are not a shape key
    fleet.run()
    assert list(fleet.iterations) == [12, 40, 24]
    for i, n in enumerate((12, 40, 24)):
        sess = gson.Session(specs[i], seed=i)
        sess.run()
        assert_states_equal(sess.result()[0], fleet.result(i)[0],
                            f"budget {n} network {i}")


class _SequentialOnly:
    """A strategy with no batched step program."""

    name = "sequential-only"
    config_cls = gson.MultiConfig


def test_non_fleet_variant_raises():
    with pytest.raises(ValueError, match="not fleet-capable"):
        gson.FleetSession([short_spec(_SequentialOnly())])
    with pytest.raises(ValueError, match="not fleet-capable"):
        gson.Session(short_spec(_SequentialOnly()))


def test_mesh_rejections():
    """What a mesh still refuses: the signal axis on a FleetSpec, a mesh
    nested on both the fleet and a member, the network axis on a
    RunSpec (``tests/test_torch_mesh.py`` runs the meshes)."""
    with pytest.raises(ValueError, match="network axis"):
        gson.FleetSpec.broadcast(short_spec(), seeds=range(2),
                                 mesh=gson.MeshSpec(axis="signal"))
    with pytest.raises(ValueError, match="cannot also shard"):
        gson.FleetSpec((short_spec(mesh=gson.MeshSpec(axis="signal")),),
                       (0,), mesh=gson.MeshSpec(axis="network"))
    with pytest.raises(ValueError, match="FleetSpec"):
        gson.Session(short_spec(mesh=gson.MeshSpec(axis="network")))


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_on_a_one_rank_mesh_equals_unsharded(tmp_path, variant):
    """A network-sharded fleet (3 networks) and a signal-sharded Session
    on a world of one gloo rank in this process: bitwise the unsharded
    runs, and the sharded snapshot restores with no mesh."""
    dist = pytest.importorskip("torch.distributed")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        spec = short_spec(variant, max_iterations=24)
        mesh = gson.MeshSpec(axis="network")
        sharded = gson.FleetSession(
            gson.FleetSpec.broadcast(spec, seeds=range(3), mesh=mesh),
            checkpoint_dir=str(tmp_path / "ck"))
        sharded.run(budget=12)
        sharded.checkpoint()
        sharded.run()
        plain = gson.FleetSession(gson.FleetSpec.broadcast(spec,
                                                           seeds=range(3)))
        plain.run(budget=12)
        plain.run()
        back = gson.FleetSession.restore(
            gson.FleetSpec.broadcast(spec, seeds=range(3)),
            str(tmp_path / "ck"))
        back.run()
        for i in range(3):
            (a, sa), (b, sb) = sharded.result(i), plain.result(i)
            assert_states_equal(a, b, f"{variant} network {i}")
            assert_states_equal(back.result(i)[0], b, f"restored {i}")
            assert rows(sa.history) == rows(sb.history)
        sess = gson.Session(spec.replace(mesh=gson.MeshSpec(axis="signal")))
        sess.run()
        assert_states_equal(sess.state, plain.network(0), "signal mesh")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# topology invariants on every network of the stacked state


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_topology_invariants_per_network(variant):
    # SOAM on a small pool exercises growth, aging, expiry and pruning
    # through the batched step; every network of the stacked state must
    # satisfy the structural invariants on its own
    spec = short_spec(
        variant, model=GSONParams(model="soam", insertion_threshold=0.35,
                                  age_max=20.0),
        capacity=96, max_iterations=30)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(4)))
    fleet.run()
    fs = fleet.cohorts[0].fstate
    assert isinstance(fs, fleet_core.FleetState) and fs.batch == 4
    assert fs.nets.w.shape == (4, 96, 3) and fs.nets.n_active.shape == (4,)
    assert bool(fleet_core.fleet_health(fs.nets).all())
    for i in range(4):
        net = fs.network(i)
        assert int(net.n_active) > 2, f"network {i} did not grow"
        assert_invariants(net.nbr, net.age, net.active)
        assert int(net.n_active) == int(net.active.sum())
        assert bool(torch.isfinite(net.w).all())


def test_stack_unstack_roundtrip():
    spec = short_spec()
    sessions = [gson.Session(spec, seed=s) for s in range(3)]
    for s in sessions:
        s.run(budget=5)
    stacked = stack_states([s.state for s in sessions])
    assert stacked.w.shape[0] == 3 and stacked.signal_count.shape == (3,)
    for s, st in zip(sessions, unstack_states(stacked)):
        assert_states_equal(s.state, st)


def test_select_and_pad_fleet():
    g = torch.Generator().manual_seed(0)
    nets = [init_state(torch.randn((2, 3), generator=g), capacity=8,
                       max_deg=4) for _ in range(3)]
    new = fleet_core.FleetState(stack_states(nets), np.full(3, 5),
                                np.zeros(3, bool), np.full(3, np.nan))
    old = fleet_core.FleetState(
        stack_states([n.replace(w=n.w + 1.0) for n in nets]),
        np.full(3, 4), np.ones(3, bool), np.zeros(3))
    mask = np.array([True, False, True])
    out = fleet_core.select_fleet(mask, new, old)
    assert list(out.iteration) == [5, 4, 5]
    assert list(out.converged) == [False, True, False]
    for i, src in enumerate((new, old, new)):
        assert torch.equal(out.network(i).w, src.network(i).w)
    assert fleet_core.select_fleet(np.ones(3, bool), new, old) is not old
    padded = fleet_core.pad_fleet(new, 2)
    assert padded.batch == 5 and list(padded.converged) == [False] * 3 + [
        True] * 2
    assert torch.equal(padded.network(4).w, new.network(0).w)


# ---------------------------------------------------------------------------
# session contract: stream, pause/resume, checkpoint/restore


def test_fleet_streams_rows_per_network():
    rows_cb = []
    fleet = gson.FleetSession(
        gson.FleetSpec.broadcast(short_spec(), seeds=range(3)),
        on_history=rows_cb.append)
    streamed = list(fleet.stream())
    assert streamed == rows_cb
    assert {r["network"] for r in streamed} == {0, 1, 2}
    for r in streamed:
        assert r["iteration"] % 10 == 0     # check cadence
        assert r["units"] > 0
    assert len(streamed) == 3 * 4


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_pause_resume_matches_uninterrupted(variant):
    fs = gson.FleetSpec.broadcast(short_spec(variant, max_iterations=48),
                                  seeds=range(3))
    a = gson.FleetSession(fs)
    a.run()
    b = gson.FleetSession(fs)
    b.run(budget=13)            # pause mid-run (not on a check boundary)
    assert all(b.iterations == 13)
    b.resume(budget=20)
    b.resume()                  # to termination
    for i in range(3):
        assert_states_equal(a.result(i)[0], b.result(i)[0], f"network {i}")


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_checkpoint_restore_matches_uninterrupted(tmp_path, variant):
    fs = gson.FleetSpec.broadcast(short_spec(variant, max_iterations=48),
                                  seeds=range(3))
    a = gson.FleetSession(fs)
    a.run()

    b = gson.FleetSession(fs, checkpoint_dir=str(tmp_path))
    b.run(budget=17)
    b.checkpoint()
    del b                       # the process dies

    c = gson.FleetSession.restore(fs, str(tmp_path))
    assert all(c.iterations == 17)
    c.resume()
    for i in range(3):
        assert_states_equal(a.result(i)[0], c.result(i)[0], f"network {i}")
        assert c.result(i)[1].iterations == a.result(i)[1].iterations
        if variant == "multi":
            assert rows(c.stats[i].history) == rows(a.stats[i].history)


def test_network_snapshot_restores_one_network_alone(tmp_path):
    spec = short_spec("multi", max_iterations=40)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(3)))
    fleet.run(budget=20)
    tree, extra = fleet.network_snapshot(2)
    from repro_torch.checkpoint import save
    save(str(tmp_path), tree, 20, extra)
    alone = gson.FleetSession.restore(gson.FleetSpec((spec,), (2,)),
                                      str(tmp_path))
    alone.run()
    sess = gson.Session(spec, seed=2)
    sess.run()
    assert_states_equal(sess.result()[0], alone.result(0)[0])


# ---------------------------------------------------------------------------
# fault tolerance: the health screen


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_poisoned_network_is_quarantined(variant):
    fs = gson.FleetSpec.broadcast(short_spec(variant), seeds=range(3))
    clean = gson.FleetSession(fs)
    clean.run()
    fleet = gson.FleetSession(fs)
    fleet.run(budget=10)
    c, local = fleet._where[1]
    unit = int(torch.nonzero(c.fstate.nets.active[local])[0, 0])
    c.fstate.nets.w[local, unit, 0] = float("nan")
    fleet.run()
    assert list(fleet.quarantined) == [False, True, False]
    (fault,) = fleet.faults
    assert (fault["network"], fault["iteration"], fault["kind"]) == (
        1, 10, "unhealthy_state")
    assert list(fleet.iterations) == [40, 10, 40]
    for i in (0, 2):
        assert_states_equal(clean.result(i)[0], fleet.result(i)[0],
                            f"cohort-mate {i}")


def test_health_screen_flags_nan_and_broken_topology():
    spec = short_spec()
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(3)))
    fleet.run(budget=10)
    nets = fleet.cohorts[0].fstate.nets
    assert fleet_core.fleet_health(nets).tolist() == [True] * 3
    inactive = int(torch.nonzero(~nets.active[2])[0, 0])
    nets.nbr[2, int(torch.nonzero(nets.active[2])[0, 0]), 0] = inactive
    nets.error[0, int(torch.nonzero(nets.active[0])[0, 0])] = float("inf")
    assert fleet_core.fleet_health(nets).tolist() == [False, True, False]


# ---------------------------------------------------------------------------
# conversion from the JAX package


def test_convert_carries_a_jax_fleet_state(jax_fleet):
    jfleet = jax_fleet("multi")
    jfs = jfleet.cohorts[0].fstate
    arrays = {name: np.asarray(getattr(jfs.nets, name))
              for name in convert.FIELDS}
    arrays.update(iteration=np.asarray(jfs.iteration),
                  converged=np.asarray(jfs.converged),
                  qe=np.asarray(jfs.qe))
    fs = convert.fleet_from_numpy(arrays)
    assert fs.batch == 3 and fs.nets.w.shape == (3, 128, 3)
    assert list(fs.iteration) == [40, 40, 40]
    assert bool(fleet_core.fleet_health(fs.nets).all())
    back = convert.fleet_to_numpy(fs)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr, name)
    for i in range(3):
        np.testing.assert_array_equal(
            fs.network(i).nbr.numpy(), np.asarray(jfleet.result(i)[0].nbr))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("cols", [False, True], ids=["rows", "row-col"])
def test_sorted_add_equals_index_add(B, cols):
    """The card's ``batch.add`` (one spare target per dropped entry, a
    sorted sum) run on the CPU: the index-order sum within rounding, and
    bitwise where every target takes one value."""
    from repro_torch.core.gson import batch
    g = torch.Generator().manual_seed(B)
    C, K, n = 64, 8, 4096
    x = torch.randn(B, C, K, generator=g)

    def case(rows):
        if cols:
            return ((rows, torch.randint(0, K, rows.shape, generator=g)),
                    torch.randn(rows.shape, generator=g))
        return (rows,), torch.randn(*rows.shape, K, generator=g)

    index, vals = case(torch.randint(0, C + 1, (B, n), generator=g))
    torch.testing.assert_close(batch._add_sorted(x, index, vals),
                               batch.add(x, index, vals))
    # C drops: a permutation of C + 1 ids keeps C targets, one value each
    index, vals = case(torch.stack([torch.randperm(C + 1, generator=g)[:C]
                                    for _ in range(B)]))
    assert torch.equal(batch._add_sorted(x, index, vals),
                       batch.add(x, index, vals))
