"""Fault injection in the port, and the facade behaviour it needs.

On the CPU, at the sizes of ``tests/test_robustness.py`` (capacity 64,
50–200 iterations):

  * ``Session(on_history=...)``, ``add_callback`` and
    ``Session.restore(..., on_history=...)``; ``FleetSession.active_network``
    and ``add_callback``; ``health_every`` on ``FleetSession`` and its
    cohorts; the checkpoint manager's pre-publish hook — as the JAX
    package has them;
  * a crash mid-checkpoint leaves the ``.tmp`` orphan, which
    ``latest(gc_orphans=True)`` ignores and collects, and restore-and-resume
    equals an uninterrupted run (mirrors
    ``test_crash_mid_checkpoint_orphan_ignored_and_collected``);
  * a poisoned network (``"nan"`` or ``"topology"``) is quarantined while
    its cohort-mates stay bitwise equal to a clean run (mirrors
    ``test_poisoned_network_quarantines_others_bit_identical``), and
    ``health_every=0`` screens nothing (``test_health_screen_can_be_disabled``);
  * ``lowering_failure_backend()`` raises in a ``Session`` and in a
    ``FleetSession``: the port has no reference fallback (the counterparts
    of the JAX package's fallback tests, which pin that fallback);
  * ``FaultySampler`` fails before its inner sampler runs;
    ``GsonFaultInjector`` fires each tick's events once.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch import gson
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams
from repro_torch.gson import faults

torch.set_num_threads(1)


def _spec(iters: int = 200, **kw) -> gson.RunSpec:
    return gson.RunSpec(variant="multi", sampler="sphere", capacity=64,
                        model=GSONParams(model="gwr",
                                         insertion_threshold=0.5),
                        max_iterations=iters, device="cpu").replace(**kw)


def _same_network(a, b) -> bool:
    return (torch.equal(a.w, b.w) and torch.equal(a.nbr, b.nbr)
            and torch.equal(a.error, b.error)
            and int(a.signal_count) == int(b.signal_count))


# ---------------------------------------------------------------------------
# the facade: history callbacks, active_network, health_every, the hook


def test_session_on_history_streams_the_rows():
    seen, more = [], []
    sess = gson.Session(_spec(iters=60), seed=2, on_history=seen.append)
    sess.run(budget=30)
    sess.add_callback(more.append)
    sess.run()
    assert seen == sess.stats.history and len(seen) == 6
    assert more == sess.stats.history[3:]


def test_session_restore_streams_to_its_callback(tmp_path):
    full = gson.Session(_spec(iters=80), seed=1)
    full.run()
    cut = gson.Session(_spec(iters=80), seed=1, checkpoint_dir=str(tmp_path))
    cut.run(budget=40)
    cut.checkpoint()
    seen = []
    back = gson.Session.restore(_spec(iters=80), str(tmp_path),
                                on_history=seen.append)
    back.run()
    assert back.stats.history == full.stats.history
    assert seen == full.stats.history[4:]


def test_fleet_active_network_and_add_callback():
    specs = (_spec(iters=20), _spec(iters=40))
    fleet = gson.FleetSession(gson.FleetSpec(specs, (0, 1)))
    rows = []
    fleet.add_callback(rows.append)
    fleet.run(budget=30)
    assert [fleet.active_network(i) for i in range(2)] == [False, True]
    fleet.run()
    assert not fleet.active_network(1)
    assert rows == sorted(fleet.stats[0].history + fleet.stats[1].history,
                          key=lambda r: (r["iteration"], r["network"]))


@pytest.mark.parametrize("health_every,quarantined",
                         [(1, [True, False]), (0, [False, False])])
def test_health_every_switches_the_screen(health_every, quarantined):
    fs = gson.FleetSession(gson.FleetSpec.broadcast(
        _spec(iters=100, variant="multi-fused"), seeds=range(2)),
        health_every=health_every)
    assert all(c.health_every == health_every for c in fs.cohorts)
    fs.run(budget=50)
    faults.poison_network(fs, 0, "nan")
    fs.run(budget=10)
    assert fs.quarantined.tolist() == quarantined


def test_health_every_spaces_the_device_screen(monkeypatch):
    fs = gson.FleetSession(gson.FleetSpec.broadcast(
        _spec(iters=40, variant="multi-fused",
              variant_config=gson.FusedConfig(
                  superstep=gson.SuperstepConfig(length=4))),
        seeds=range(2)), health_every=3)
    c = fs.cohorts[0]
    screened = []
    orig = c._screen
    monkeypatch.setattr(c, "_screen", lambda: (screened.append(c._ticks),
                                               orig()))
    fs.run()
    assert c._ticks == 10
    assert screened == [0, 3, 6, 9]


def test_fleet_restore_passes_health_every(tmp_path):
    fs = gson.FleetSession(gson.FleetSpec.broadcast(_spec(iters=60),
                                                    seeds=range(2)),
                           checkpoint_dir=str(tmp_path))
    fs.run(budget=30)
    fs.checkpoint()
    back = gson.FleetSession.restore(
        gson.FleetSpec.broadcast(_spec(iters=60), seeds=range(2)),
        str(tmp_path), health_every=0)
    assert back.cohorts[0].health_every == 0


def test_pre_publish_hook_runs_between_fsync_and_rename(tmp_path,
                                                        monkeypatch):
    d = str(tmp_path)
    seen = []

    def hook(tmp, step):
        seen.append((os.path.basename(tmp), sorted(os.listdir(tmp)),
                     ckpt.valid_steps(d)))
        raise faults.SimulatedCrash("die before the rename")

    tree = {"x": torch.arange(4)}
    ckpt.save(d, tree, 1)
    monkeypatch.setattr(ckpt, "_PRE_PUBLISH_HOOK", hook)
    with pytest.raises(faults.SimulatedCrash):
        ckpt.save(d, tree, 2)
    assert seen == [("step_00000002.tmp", ["arrays.npz", "manifest.json"],
                     [1])]
    assert "step_00000002.tmp" in os.listdir(d)
    assert ckpt.latest(d) == 1


# ---------------------------------------------------------------------------
# checkpoint hygiene


def test_crash_mid_checkpoint_orphan_ignored_and_collected(tmp_path):
    d = str(tmp_path)
    sess = gson.Session(_spec(), seed=0, checkpoint_dir=d)
    sess.run(budget=50)
    sess.checkpoint()
    sess.run(budget=50)
    with gson.checkpoint_crash():
        with pytest.raises(gson.SimulatedCrash):
            sess.checkpoint()
    assert ckpt._PRE_PUBLISH_HOOK is None        # disarmed on the way out
    # the crash died between fsync and rename: orphan present, published
    # history intact
    assert any(x.endswith(".tmp") for x in os.listdir(d))
    assert ckpt.latest(d) == 50
    assert ckpt.valid_steps(d) == [50]
    assert ckpt.latest(d, gc_orphans=True) == 50
    assert not any(x.endswith(".tmp") for x in os.listdir(d))
    # restore-and-resume equals an uninterrupted run
    res = gson.Session.restore(_spec(), d)
    assert res.iteration == 50
    res.run()
    ref = gson.Session(_spec(), seed=0)
    ref.run()
    assert _same_network(res.state, ref.state)


def test_arm_checkpoint_crash_counts_publishes(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.zeros(2)}
    faults.arm_checkpoint_crash(times=2)
    try:
        for step in (1, 2):
            with pytest.raises(faults.SimulatedCrash, match=f"step {step}"):
                ckpt.save(d, tree, step)
        ckpt.save(d, tree, 3)
    finally:
        faults.disarm_checkpoint_crash()
    assert ckpt.valid_steps(d) == [3]


# ---------------------------------------------------------------------------
# quarantine


@pytest.mark.parametrize("kind", ["nan", "topology"])
def test_poisoned_network_quarantines_others_bit_identical(kind):
    clean = gson.FleetSession(gson.FleetSpec.broadcast(_spec(),
                                                       seeds=range(4)))
    clean.run()
    fs = gson.FleetSession(gson.FleetSpec.broadcast(_spec(), seeds=range(4)))
    fs.run(budget=60)
    before = fs.cohorts[0].fstate.nets.w
    faults.poison_network(fs, 2, kind)
    assert torch.isfinite(before).all()          # a copy took the poison
    fs.run()
    assert fs.quarantined.tolist() == [False, False, True, False]
    rec = fs.faults
    assert rec and rec[0]["network"] == 2
    assert rec[0]["kind"] == "unhealthy_state"
    assert rec[0]["iteration"] == 60
    # the poisoned network froze right after the screen caught it ...
    assert fs.iterations[2] == 60 < fs.iterations[0]
    # ... and its wave-mates never felt it
    for i in (0, 1, 3):
        assert _same_network(clean.result(i)[0], fs.result(i)[0]), i


def test_poison_network_rejects_unknown_kind():
    fs = gson.FleetSession(gson.FleetSpec.broadcast(_spec(iters=10),
                                                    seeds=range(2)))
    fs.run()
    with pytest.raises(ValueError, match="unknown poison kind"):
        faults.poison_network(fs, 0, "bitflip")


# ---------------------------------------------------------------------------
# a backend that cannot run raises; nothing swaps in the reference


def test_lowering_failure_raises_in_session():
    broken = _spec(iters=100).replace(
        backend=gson.lowering_failure_backend())
    sess = gson.Session(broken, seed=0)
    with pytest.raises(RuntimeError, match="injected kernel lowering"):
        sess.run()
    assert sess.iteration == 0
    with pytest.raises(RuntimeError, match="injected kernel lowering"):
        gson.run(broken, seed=0)


def test_lowering_failure_raises_in_fleet():
    broken = _spec(iters=100).replace(
        backend=gson.lowering_failure_backend())
    fs = gson.FleetSession(gson.FleetSpec.broadcast(broken, seeds=range(2)))
    for _ in range(2):               # a second try raises again
        with pytest.raises(RuntimeError, match="injected kernel lowering"):
            fs.run()
    assert fs.cohorts[0].find_winners is faults.failing_find_winners
    assert fs.iterations.tolist() == [0, 0]


# ---------------------------------------------------------------------------
# the sampler wrapper and the schedule


def test_faulty_sampler_fails_before_drawing():
    inner = make_sampler("sphere")
    flaky = gson.FaultySampler(inner, fail_times=2, exc=ValueError)
    g = torch.Generator().manual_seed(3)
    for use in (1, 2):
        with pytest.raises(ValueError, match=f"use {use} of 2"):
            flaky(g, 5)
    got = flaky(g, 5)
    want = inner(torch.Generator().manual_seed(3), 5)
    assert torch.equal(got, want)                # no draw was consumed
    assert flaky.calls == 3


def test_fleet_session_starts_lazily():
    flaky = gson.FaultySampler(make_sampler("sphere"), fail_times=1)
    fs = gson.FleetSession(gson.FleetSpec.broadcast(
        _spec(iters=20, sampler=flaky), seeds=range(2)))
    assert flaky.calls == 0 and not fs.started
    with pytest.raises(RuntimeError, match="injected sampler failure"):
        fs.run()


def test_injector_events_fire_once():
    inj = gson.GsonFaultInjector({
        2: {"kind": "poison", "job": 1},
        5: [{"kind": "crash_checkpoint"}, {"kind": "device_loss"}]})
    assert inj.events_at(0) == []
    assert inj.events_at(2) == [{"kind": "poison", "job": 1}]
    assert [e["kind"] for e in inj.events_at(5)] == ["crash_checkpoint",
                                                     "device_loss"]
    inj.pop(5)
    inj.pop(7)                                   # nothing there: no error
    assert inj.events_at(5) == [] and list(inj.schedule) == [2]


def test_faults_api_matches_the_jax_package():
    names = {"DeviceLossError", "FaultySampler", "GsonFaultInjector",
             "SimulatedCrash", "checkpoint_crash",
             "lowering_failure_backend", "poison_network"}
    assert names <= set(gson.__all__)
    assert {"ElasticFleetRunner", "MeshSpec"} <= set(gson.__all__)
    assert issubclass(gson.DeviceLossError, RuntimeError)
    assert np.all([callable(getattr(gson, n)) for n in names])
