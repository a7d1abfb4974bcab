"""Elastic recovery on the port's meshes, on the CPU (gloo).

Mirrors ``tests/test_ft.py`` (heartbeats and the checkpoint-restart loop;
not its wall-clock straggler test, which is flaky), the elastic
resharding case of ``tests/test_checkpoint.py`` and
``tests/test_robustness.py``'s device-loss cases, with one spawned world
of 4 CPU ranks (``run_world``) for the file:

  * ``ElasticFleetRunner`` over a fleet of 8 on 4 ranks that loses pods 2
    and 3 shrinks to ranks 0 and 1, reshard-restores, and ends bitwise
    equal to the run with no fault; the ranks left over leave the loop;
  * a ``ReconstructionServer`` on a 4-rank mesh whose ``device_loss``
    leaves 2 survivors ends with ``srv.mesh.ndev() == 2``, every job done,
    no retry counted and the stats of the server with no mesh; on a mesh
    with no fault its jobs equal their dedicated sessions;
  * a sampler that fails on rank 3 alone, as its wave starts or inside a
    tick, faults the same wave on every rank, and every job is retried
    once and ends equal to its dedicated session;
  * ``restore(..., shardings=)`` places a rank's rows of a logical tree.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from repro_torch import convert, gson
from repro_torch.checkpoint import CheckpointManager, Rows, restore, save
from repro_torch.core.gson import distributed as dist_core
from repro_torch.core.gson.state import FIELDS, GSONParams
from repro_torch.ft.elastic import ElasticRunner, FailureInjector, PodHealth
from repro_torch.serving import ReconstructionServer

torch.set_num_threads(1)

WORLD = 4
LOST = {2: ["pod2_down", "pod3_down"]}       # tick -> pods lost
SURVIVORS = 2
SERVE_BUDGETS = (12, 25, 25, 18, 25)
# the use of rank 3's sampler of network 3 that fails: as the wave
# starts (seed points) or inside its first tick (an iteration's signals)
RANK_FAULT_USES = {"start": 1, "tick": 5}
RANK_FAULT_ITERS = 10


class SamplerFailsAt:
    """The sphere sampler, raising at its ``use``-th call (0: never)."""

    def __init__(self, use: int):
        self.use, self.calls = use, 0
        self.inner = gson.resolve_sampler("sphere")

    def __call__(self, gen, n):
        self.calls += 1
        if self.calls == self.use:
            raise RuntimeError(f"injected sampler failure at use {self.use}")
        return self.inner(gen, n)


def spec(max_iterations: int, variant="multi") -> gson.RunSpec:
    return gson.RunSpec(
        variant=variant, sampler="sphere", capacity=64,
        model=GSONParams(model="gwr", insertion_threshold=0.5),
        max_iterations=max_iterations, device="cpu")


def job_stats(jobs) -> list:
    """Each job's outcome and rows (without the wave index a row carries,
    which a retry in its own wave changes)."""
    return [(j.jid, j.status, j.retries, j.stats.iterations, j.stats.units,
             j.stats.signals, j.stats.quantization_error,
             [{k: v for k, v in r.items() if k != "network"}
              for r in j.history])
            for j in jobs]


# ---------------------------------------------------------------------------
# heartbeats and the restart loop (plain Python)


def test_pod_health_weights():
    h = PodHealth(n_pods=4, straggle_factor=2.0)
    for step in range(8):
        for p in range(4):
            h.beat(p, step, 1.0 if p != 2 else 5.0)   # pod 2 straggles
    w = h.weights()
    assert w[0] == w[1] == w[3] == 1.0
    assert 0.1 < w[2] < 0.6
    for _ in range(3):
        h.miss(1)
    assert h.dead() == [1]
    assert h.weights()[1] == 0.0


def _make_build(log):
    """Toy training: state = (x, pods); a step adds its index to x, so the
    state is a pure function of the steps run."""

    def build(n_pods, ckpt):
        state = {"x": torch.zeros(4), "pods": torch.tensor(float(n_pods))}
        if ckpt is not None and ckpt.latest() is not None:
            state, _, _ = ckpt.restore(state)
            state = dict(state, pods=torch.tensor(float(n_pods)))

        def step_fn(state, step, weights):
            time.sleep(0.005)
            log.append((step, n_pods, tuple(np.asarray(weights))))
            return dict(state, x=state["x"] + step)

        return state, step_fn

    return build


def test_elastic_restart_resumes_exactly(tmp_path):
    ref_log = []
    r = ElasticRunner(_make_build(ref_log),
                      CheckpointManager(str(tmp_path / "a")), n_pods=2,
                      ckpt_every=5)
    final_ref = r.run(20)
    # pod 1 dies at step 12 -> restart from the step-10 checkpoint, 1 pod
    log = []
    r2 = ElasticRunner(_make_build(log),
                       CheckpointManager(str(tmp_path / "b")), n_pods=2,
                       ckpt_every=5,
                       injector=FailureInjector({12: "pod1_down"}))
    final = r2.run(20)
    assert r2.restarts == 1
    restart = [e for e in r2.log if e["event"] == "restart"]
    assert restart[0]["step"] == 10 and restart[0]["pods"] == 1
    assert torch.equal(final["x"], final_ref["x"])
    steps_run = [s for s, _, _ in log]
    assert steps_run.count(10) == 2 and steps_run.count(11) == 2


def test_elastic_runner_requires_mesh(tmp_path):
    with pytest.raises(ValueError, match="network-sharded"):
        gson.ElasticFleetRunner(
            gson.FleetSpec.broadcast(spec(10), seeds=range(2)),
            str(tmp_path))


# ---------------------------------------------------------------------------
# elastic resharding of a restore (the manager's shardings=)


def _tree():
    return {"nets": {"w": torch.arange(24.0).reshape(4, 3, 2)},
            "it": np.arange(4, dtype=np.int64), "step": 7}


@pytest.mark.parametrize("rows", [Rows(1, 3), Rows(4, 6, pad=2),
                                  Rows(0, 4, device="cpu")],
                         ids=["slice", "padded", "whole"])
def test_restore_places_a_ranks_rows(tmp_path, rows):
    t = _tree()
    save(str(tmp_path), t, step=1)
    pad = np.concatenate
    want_w = torch.cat([t["nets"]["w"], t["nets"]["w"][:1].expand(
        rows.pad, 3, 2)])[rows.start:rows.stop]
    want_it = pad([t["it"], np.repeat(t["it"][:1], rows.pad)])[
        rows.start:rows.stop]
    # the target keeps the logical shapes; a meta leaf takes the device
    # from its placement
    target = {"nets": {"w": torch.empty((4, 3, 2), device="meta")},
              "it": np.empty(4, np.int64), "step": 0}
    if rows.device is None:
        target["nets"]["w"] = torch.empty((4, 3, 2))
    out, step, _ = restore(str(tmp_path), target,
                           shardings={"nets": rows, "it": rows})
    assert step == 1 and out["step"] == 7
    assert torch.equal(out["nets"]["w"], want_w)
    np.testing.assert_array_equal(out["it"], want_it)


def test_restore_rejects_a_meta_leaf_without_a_device(tmp_path):
    save(str(tmp_path), _tree(), step=1)
    target = {"nets": {"w": torch.empty((4, 3, 2), device="meta")},
              "it": np.empty(4, np.int64), "step": 0}
    with pytest.raises(ValueError, match="meta"):
        restore(str(tmp_path), target, step=1)


# ---------------------------------------------------------------------------
# the world: every rank runs this, the pytest process compares


def _elastic_world(rank, root):
    torch.set_num_threads(1)
    # the ranks yield to the other test workers' wall-clock checks
    os.nice(10)
    out = {}

    def fleet():
        return gson.FleetSpec.broadcast(
            spec(150), seeds=range(8), mesh=gson.MeshSpec(axis="network"))

    r0 = gson.ElasticFleetRunner(fleet(), f"{root}/e0", tick_iters=25)
    s0 = r0.run()
    nets0 = [convert.state_to_numpy(s) for s, _ in s0.results()]
    r1 = gson.ElasticFleetRunner(fleet(), f"{root}/e1", tick_iters=25,
                                 injector=FailureInjector(dict(LOST)))
    s1 = r1.run()
    out["elastic"] = (r0.restarts, r1.restarts, r1.fspec.mesh.ndev(),
                      [e["event"] for e in r1.log], nets0,
                      None if s1 is None else
                      [convert.state_to_numpy(s) for s, _ in s1.results()])

    srv = ReconstructionServer(
        slots=4, slice_iters=50, checkpoint_dir=f"{root}/srv",
        injector=gson.GsonFaultInjector(
            {2: {"kind": "device_loss", "survivors": SURVIVORS}}),
        mesh=gson.MeshSpec(axis="network"))
    jobs = [srv.submit(spec(200), seed=s) for s in range(4)]
    srv.run(max_ticks=100)
    out["serve loss"] = (srv.left, srv.mesh.ndev(),
                         None if srv.left else job_stats(jobs),
                         [j.error and j.error["kind"] for j in jobs])

    srv = ReconstructionServer(slots=4, slice_iters=10,
                               mesh=gson.MeshSpec(axis="network"))
    jobs = [srv.submit(spec(n, "multi-fused"), seed=s)
            for s, n in enumerate(SERVE_BUDGETS)]
    srv.run(max_ticks=100)
    out["serve"] = job_stats(jobs)

    for where, use in RANK_FAULT_USES.items():
        srv = ReconstructionServer(slots=4, slice_iters=10,
                                   mesh=gson.MeshSpec(axis="network"))
        jobs = [srv.submit(spec(RANK_FAULT_ITERS).replace(
            sampler=SamplerFailsAt(use if rank == 3 else 0)), seed=s)
            if s == 3 else srv.submit(spec(RANK_FAULT_ITERS), seed=s)
            for s in range(4)]
        srv.run(max_ticks=100)
        out[("rank fault", where)] = (job_stats(jobs),
                                      [j.error for j in jobs])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    return dist_core.run_world(_elastic_world, WORLD, (root,))


def test_elastic_fleet_runner_survives_lost_pods(world):
    for rank in range(WORLD):
        r0, r1, ndev, events, _, _ = world[rank]["elastic"]
        assert (r0, r1, ndev, events) == (0, 1, SURVIVORS, ["restart"])


def test_elastic_fleet_runner_equals_the_run_with_no_fault(world):
    for rank in range(WORLD):
        _, _, _, _, nets0, nets1 = world[rank]["elastic"]
        if rank >= SURVIVORS:          # left the loop at the shrink
            assert nets1 is None
            continue
        for i, (a, b) in enumerate(zip(nets0, nets1)):
            for f in FIELDS:
                np.testing.assert_array_equal(a[f], b[f], (rank, i, f))


def test_server_device_loss_shrinks_the_mesh(world):
    ref = ReconstructionServer(slots=4, slice_iters=50)
    jobs = [ref.submit(spec(200), seed=s) for s in range(4)]
    ref.run(max_ticks=100)
    want = job_stats(jobs)
    for rank in range(WORLD):
        left, ndev, got, faults = world[rank]["serve loss"]
        assert ndev == SURVIVORS
        assert left == (rank >= SURVIVORS)
        assert faults == ["device_loss"] * 4     # every wave was lost
        if left:
            continue
        assert [g[1:3] for g in got] == [("done", 0)] * 4
        # the same stats as the server with no mesh (its rows too)
        for g, w in zip(got, want):
            assert g[3:] == w[3:], g[0]


def test_server_places_waves_on_the_mesh(world):
    want = []
    for seed, n in enumerate(SERVE_BUDGETS):
        sess = gson.Session(spec(n, "multi-fused"), seed=seed)
        sess.run()
        stats = sess.result()[1]
        want.append((n, stats.units, stats.signals))
    for rank in range(WORLD):
        got = world[rank]["serve"]
        assert [g[1] for g in got] == ["done"] * len(SERVE_BUDGETS)
        assert [g[3:6] for g in got] == want, rank


@pytest.mark.parametrize("where", sorted(RANK_FAULT_USES))
def test_server_shares_a_fault_of_one_rank(world, where):
    want = []
    for seed in range(4):
        sess = gson.Session(spec(RANK_FAULT_ITERS), seed=seed)
        sess.run()
        stats = sess.result()[1]
        want.append((RANK_FAULT_ITERS, stats.units, stats.signals))
    got0, errors0 = world[0][("rank fault", where)]
    for rank in range(WORLD):
        got, errors = world[rank][("rank fault", where)]
        assert got == got0 and errors == errors0, rank
    assert [g[1:3] for g in got0] == [("done", 1)] * 4
    assert [g[3:6] for g in got0] == want
    for e in errors0:
        assert e["kind"] == "advance_error", e
        assert "rank 3 of the mesh raised RuntimeError('injected " \
            "sampler failure" in e["detail"], e
