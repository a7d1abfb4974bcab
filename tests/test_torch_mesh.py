"""The port's device meshes on ``torch.distributed``, on the CPU (gloo).

Mirrors ``tests/test_distributed.py::test_gson_distributed_equivalence``
(the GSON strategies) and ``tests/test_fleet_mesh.py`` at their sizes,
with one spawned world of 4 CPU ranks (``run_world``) for the whole file;
a mesh of 2 or 3 ranks is the first ranks of that world, the others
hold nothing, as ``MeshSpec(devices=n)`` says. The port is held to a
stricter contract than the JAX package, which only asks a signal-sharded
run to be valid:

  * the signal-sharded step (on 4 and 2 ranks) and the
    network-partitioned step (4 ranks) equal the port's unsharded step
    bitwise on every rank, with the plain reference and with the kernel
    wrapper's plain path, and hold against JAX's unsharded
    ``multi_signal_step_impl`` within JAX's own contract (weights within
    1e-5, ``n_active`` and ``discarded`` equal, the edge set equal);
  * the network partition is exact where a slice holds one active unit or
    none;
  * a network-sharded fleet of 8 on 4, 3 (padded) and 2 ranks equals its
    8 sessions (every field, stats, rows);
  * a snapshot taken on 4 ranks continues bitwise on 2, on 3 and with no
    mesh;
  * ``RunSpec.mesh`` (the signal axis) runs ``Session``s and an unsharded
    fleet of signal-sharded networks bitwise equal to the unsharded runs;
  * host-side ``MeshSpec`` validation, the memoized group and the error
    without a process group.

The JAX side runs in the pytest process; the ranks import no JAX (their
functions live in this module, which imports JAX only inside tests).
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import convert, gson
from repro_torch.core.gson import distributed as dist_core
from repro_torch.core.gson.multi import multi_signal_step
from repro_torch.core.gson.state import FIELDS, GSONParams
from repro_torch.kernels.find_winners import cuda_find_winners

torch.set_num_threads(1)

WORLD = 4
GWR = dict(model="gwr", insertion_threshold=0.5)
INNERS = {"reference": None, "kernel": cuda_find_winners}
# (mesh size, variant) of the network-sharded fleets of 8
FLEETS = ((4, "multi"), (4, "multi-fused"), (3, "multi-fused"),
          (2, "multi-fused"))
RESTORES = (2, 3, None)      # meshes a 4-rank snapshot is restored onto
CUT = 17                     # where that snapshot is taken (off cadence)


def short_spec(variant="multi", **kw) -> gson.RunSpec:
    base = dict(
        variant=variant, model=GSONParams(**GWR), sampler="sphere",
        capacity=128, max_deg=12, max_iterations=40, check_every=10,
        qe_threshold=1e-9, n_probe=256, device="cpu")
    base.update(kw)
    return gson.RunSpec(**base)


def snapshot(state) -> dict:
    return convert.state_to_numpy(state)


def summary(stats) -> tuple:
    return (stats.iterations, stats.signals, stats.units,
            [(r["iteration"], r["units"], r["signals"], r["qe"])
             for r in stats.history])


def assert_same(a: dict, b: dict, ctx):
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], f"{ctx}: {f}")


# ---------------------------------------------------------------------------
# the world: every rank runs this, the pytest process compares


def _fw_world(rank, st, sig):
    """Find Winners partitioned by units on 4 ranks, for each inner."""
    group = gson.MeshSpec(axis="network").build()
    return {name: [t.numpy() for t in
                   dist_core.network_parallel_find_winners(group, inner)(
                       sig, st.w, st.active)]
            for name, inner in INNERS.items()}


def _mesh_world(rank, ckdir, step_in, fw_in):
    torch.set_num_threads(1)
    # the ranks yield to the other test workers' wall-clock checks
    os.nice(10)
    out = {"fw": {k: _fw_world(rank, *v) for k, v in fw_in.items()}}

    # one step: signals split on 4 and on 2 ranks, units on 4
    st, sig, prio, params = step_in
    for strategy, n in (("data", 4), ("data", 2), ("network", 4)):
        group = gson.MeshSpec(axis="signal", devices=n).build()
        if rank >= n:
            continue
        for name, inner in INNERS.items():
            step = dist_core.make_distributed_step(group, params, strategy,
                                                   inner)
            a, b = step(st, sig, prio), step(st, sig, prio)
            out[(strategy, n, name)] = (snapshot(a), snapshot(b))

    # network-sharded fleets of 8
    for n, variant in FLEETS:
        sess = gson.FleetSession(gson.FleetSpec.broadcast(
            short_spec(variant), seeds=range(8),
            mesh=gson.MeshSpec(axis="network", devices=n)))
        sess.run()
        if rank < n:
            out[("fleet", n, variant)] = (sess.cohorts[0].pad, [
                (snapshot(s), summary(t)) for s, t in sess.results()])
        else:
            out[("fleet", n, variant)] = (list(sess.iterations),
                                         sess.cohorts[0].member)

    # a 4-rank snapshot restored onto 2, 3 and no mesh
    spec = short_spec("multi-fused", max_iterations=48)
    a = gson.FleetSession(gson.FleetSpec.broadcast(
        spec, seeds=range(8), mesh=gson.MeshSpec(axis="network")),
        checkpoint_dir=ckdir)
    a.run(budget=CUT)
    a.checkpoint()
    for n in RESTORES:
        mesh = None if n is None else gson.MeshSpec(axis="network",
                                                    devices=n)
        fspec = gson.FleetSpec.broadcast(spec, seeds=range(8), mesh=mesh)
        if n is not None and rank >= n:
            mesh.build()                # the group is built by every rank
            continue
        b = gson.FleetSession.restore(fspec, ckdir)
        its = list(b.iterations)
        b.resume()
        out[("restore", n)] = (its, [snapshot(s) for s, _ in b.results()])

    # the signal axis through the public API
    for n in (4, 2):
        sm = gson.MeshSpec(axis="signal", devices=n)
        sm.build()
        if rank >= n:
            continue
        for variant in ("multi", "multi-fused"):
            sess = gson.Session(short_spec(variant, mesh=sm), seed=0)
            sess.run()
            st_, stats = sess.result()
            out[("signal", n, variant)] = (snapshot(st_), summary(stats))
    sm = gson.MeshSpec(axis="signal")
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(
        short_spec("multi-fused", mesh=sm, max_iterations=12),
        seeds=range(2)))
    fleet.run()
    out["signal fleet"] = (list(fleet.iterations),
                           [snapshot(s) for s, _ in fleet.results()])
    return out


# ---------------------------------------------------------------------------
# what the ranks are compared with, in the pytest process


def _jax_step_inputs():
    """test_distributed's workload: a JAX network advanced 10 steps, the
    signals of one more and JAX's own step on them; the port's copy of
    the state and JAX's lock priorities."""
    jax = pytest.importorskip("jax")
    from _torch_parity import lock_priorities, t, to_torch_state, \
        torch_params
    from repro.core.gson.multi import multi_signal_step_impl
    from repro.core.gson.sampling import make_sampler
    from repro.core.gson.state import GSONParams as JaxParams
    from repro.core.gson.state import init_state

    p = JaxParams(model="soam", insertion_threshold=0.3)
    sampler = make_sampler("sphere")
    st = init_state(jax.random.key(3), capacity=256, dim=3, max_deg=16,
                    seed_points=sampler(jax.random.key(1), 2))
    step = jax.jit(multi_signal_step_impl,
                   static_argnames=("params", "refresh_states"))
    rng = jax.random.key(9)
    for _ in range(10):
        rng, k = jax.random.split(rng)
        st = step(st, sampler(k, 64), p, refresh_states=False)
    sig = sampler(jax.random.key(5), 64)
    ref = step(st, sig, p, refresh_states=False)
    prio = lock_priorities(jax.random.split(st.rng)[1], 64)
    return ref, (to_torch_state(st), t(sig), prio, torch_params(p))


def _few_active_pools(st, sig):
    """The grown pool with a slice of one active unit (units 128..191
    keep only 150) and one of none (192..255); a pool whose only active
    units are two in the last slice; a pool of one active unit."""
    one = st.active.clone()
    one[128:] = False
    one[150] = True
    pools = {"one": one}
    for name, ids in (("two", [200, 201]), ("lone", [150])):
        pools[name] = torch.zeros_like(one)
        pools[name][ids] = True
    return {k: (st.replace(active=v), sig) for k, v in pools.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ref, step_in = _jax_step_inputs()
    fw_in = _few_active_pools(step_in[0], step_in[1])
    out = dist_core.run_world(
        _mesh_world, WORLD,
        (str(tmp_path_factory.mktemp("mesh_ckpt")), step_in, fw_in))
    return ref, step_in, fw_in, out


@pytest.fixture(scope="module")
def sessions():
    """Each fleet's networks as their own unsharded Sessions."""
    out = {}
    for variant in ("multi", "multi-fused"):
        for i in range(8):
            sess = gson.Session(short_spec(variant), seed=i)
            sess.run()
            st, stats = sess.result()
            out[(variant, i)] = (snapshot(st), summary(stats))
    return out


def _edges(nbr: np.ndarray) -> set:
    return {(min(a, int(b)), max(a, int(b)))
            for a in range(nbr.shape[0]) for b in nbr[a] if b >= 0}


# ---------------------------------------------------------------------------
# the distributed step


@pytest.mark.parametrize("inner", sorted(INNERS))
@pytest.mark.parametrize("case", [("data", 4), ("data", 2), ("network", 4)],
                         ids=["data-4", "data-2", "network-4"])
def test_distributed_step_equals_unsharded_bitwise(world, case, inner):
    _, (st, sig, prio, params), _, out = world
    want = snapshot(multi_signal_step(st, sig, params, prio,
                                      refresh_states=False,
                                      find_winners=INNERS[inner]))
    strategy, n = case
    for rank in range(n):
        a, b = out[rank][(strategy, n, inner)]
        assert_same(want, a, (case, inner, rank))
        assert_same(a, b, (case, inner, rank, "rerun"))


@pytest.mark.parametrize("case", [("data", 4), ("data", 2), ("network", 4)],
                         ids=["data-4", "data-2", "network-4"])
def test_distributed_step_holds_against_jax(world, case):
    ref, _, _, out = world
    got = out[0][(*case, "reference")][0]
    np.testing.assert_allclose(np.asarray(ref.w), got["w"], atol=1e-5)
    assert int(ref.n_active) == int(got["n_active"])
    assert int(ref.discarded) == int(got["discarded"])
    assert _edges(np.asarray(ref.nbr)) == _edges(got["nbr"])


@pytest.mark.parametrize("inner", sorted(INNERS))
@pytest.mark.parametrize("pool", ["one", "two", "lone"])
def test_network_partition_with_few_active_units_per_slice(world, pool,
                                                           inner):
    _, _, fw_in, out = world
    st, sig = fw_in[pool]
    fw = INNERS[inner] or dist_core.find_winners_reference
    want = [t.numpy() for t in fw(sig, st.w, st.active)]
    for rank in range(WORLD):
        for a, b in zip(want, out[rank]["fw"][pool][inner]):
            np.testing.assert_array_equal(a, b, f"{pool} {inner} {rank}")


# ---------------------------------------------------------------------------
# network-sharded fleets


@pytest.mark.parametrize("case", FLEETS,
                         ids=[f"{n}-{v}" for n, v in FLEETS])
def test_sharded_fleet_equals_sessions(world, sessions, case):
    out = world[3]
    n, variant = case
    for rank in range(n):
        pad, nets = out[rank][("fleet", *case)]
        assert pad == (-8) % n
        for i, (st, stats) in enumerate(nets):
            want_st, want_stats = sessions[(variant, i)]
            assert_same(want_st, st, (case, rank, i))
            assert stats == want_stats, (case, rank, i)
    for rank in range(n, WORLD):      # outside the mesh: nothing held
        its, member = out[rank][("fleet", *case)]
        assert its == [0] * 8 and not member


@pytest.mark.parametrize("n", RESTORES, ids=["2", "3", "none"])
def test_sharded_snapshot_restores_onto_another_mesh(world, n):
    out = world[3]
    spec = short_spec("multi-fused", max_iterations=48)
    ref = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(8)))
    ref.run()
    want = [snapshot(s) for s, _ in ref.results()]
    for rank in range(WORLD if n is None else n):
        its, nets = out[rank][("restore", n)]
        assert its == [CUT] * 8
        for i, st in enumerate(nets):
            assert_same(want[i], st, (n, rank, i))


# ---------------------------------------------------------------------------
# the signal axis through the public API


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_signal_mesh_session_equals_unsharded(world, sessions, variant, n):
    out = world[3]
    want_st, want_stats = sessions[(variant, 0)]
    for rank in range(n):
        st, stats = out[rank][("signal", n, variant)]
        assert_same(want_st, st, (variant, n, rank))
        assert stats == want_stats


def test_unsharded_fleet_of_signal_sharded_networks(world):
    out = world[3]
    spec = short_spec("multi-fused", max_iterations=12)
    plain = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(2)))
    plain.run()
    for rank in range(WORLD):
        its, nets = out[rank]["signal fleet"]
        assert its == [12, 12]
        for (want, _), got in zip(plain.results(), nets):
            assert_same(snapshot(want), got, rank)


# ---------------------------------------------------------------------------
# host side: no world needed, or a one-rank world in this process


def test_meshspec_validation():
    with pytest.raises(ValueError, match="axis"):
        gson.MeshSpec(axis="nope")
    with pytest.raises(ValueError, match="devices"):
        gson.MeshSpec(devices=0)
    with pytest.raises(ValueError, match="FleetSpec"):
        gson.resolve(short_spec(mesh=gson.MeshSpec(axis="network")))
    with pytest.raises(ValueError, match="network axis"):
        gson.FleetSpec.broadcast(short_spec(), seeds=range(2),
                                 mesh=gson.MeshSpec(axis="signal"))
    with pytest.raises(ValueError, match="cannot also shard"):
        gson.FleetSpec.broadcast(
            short_spec(mesh=gson.MeshSpec(axis="signal")), seeds=range(2),
            mesh=gson.MeshSpec(axis="network"))


def test_meshspec_build_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        gson.MeshSpec(devices=1).build()


def test_meshspec_build_is_memoized_and_checks_the_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        a = gson.MeshSpec(axis="network", devices=1)
        b = gson.MeshSpec(axis="network", devices=1)
        assert a.build() is b.build()
        # the port has no shard_map: the axis label changes nothing
        c = gson.MeshSpec(axis="network", devices=1, axis_name="other")
        assert c == a and hash(c) == hash(a) and c.build() is a.build()
        assert gson.MeshSpec().ndev() == 1
        with pytest.raises(RuntimeError, match="torchrun"):
            gson.MeshSpec(devices=10_000).build()
    finally:
        dist.destroy_process_group()


def test_signal_mesh_is_a_cohort_key(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        base = short_spec(capacity=64, max_iterations=4, check_every=2,
                          n_probe=64)
        meshed = base.replace(mesh=gson.MeshSpec(axis="signal", devices=1))
        fleet = gson.FleetSession(gson.FleetSpec((base, meshed), (0, 1)))
        assert len(fleet.cohorts) == 2
        fleet.run()
        assert list(fleet.iterations) == [4, 4]
    finally:
        dist.destroy_process_group()
