"""The port's reconstruction server: waves, supervision, and the JAX server.

On the CPU, at the JAX tests' sizes (capacity 64, 20–300 iterations):

  * mirrors of ``tests/test_serving.py::test_no_slot_starvation_mixed_fleet_legacy``
    (its ``single`` job at chunks of 4 signals, not 256: the port's eager
    ``single`` pays ~3 ms per signal on this CPU) and
    ``::test_incremental_waves_match_dedicated_sessions``, and of
    ``tests/test_gson_api.py::test_reconstruction_server_waves``, where
    each job equals its dedicated port ``Session``;
  * the five serving cases of ``tests/test_robustness.py`` (poison and
    retry from checkpoint, the retry budget, a transient sampler failure,
    terminal statuses under ``max_ticks``, the stall detector — its slice
    two iterations long, since the port's sampler sleeps on every call);
  * the rules the JAX server keeps: backoff ``backoff_ticks *
    2**(retries - 1)`` with the clock fast-forwarded, a failed wave
    construction returned to the queue front, device loss free of charge,
    a failing backend ending ``failed`` (never completed on the
    reference), waves on a one-rank mesh equal to waves without one;
  * one parity run against ``repro.serving.engine.ReconstructionServer``:
    the same submissions and fault schedule (poison, crash mid-checkpoint,
    an injected job failure, device loss), the port under the JAX draws
    (``JaxReplayDraws``): per tick each job's status, retries and error
    kind are equal; at the end each job's iterations and discrete state
    bitwise, floats within 1e-6, and its rows equal with ``qe`` at
    relative 1e-6.
"""
from __future__ import annotations

import copy
import warnings

import numpy as np
import pytest
import torch

from _torch_parity import DISCRETE, FLOATS, JaxReplayDraws
from repro_torch import convert, gson
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams
from repro_torch.serving import ReconstructionServer

torch.set_num_threads(1)

GWR = dict(model="gwr", insertion_threshold=0.5)


def _spec(iters: int = 200, **kw) -> gson.RunSpec:
    """``tests/test_robustness.py``'s spec."""
    return gson.RunSpec(variant="multi", sampler="sphere", capacity=64,
                        model=GSONParams(**GWR), max_iterations=iters,
                        device="cpu").replace(**kw)


def _recon_spec(variant="multi", iters=20, **kw) -> gson.RunSpec:
    """``tests/test_serving.py``'s spec."""
    return gson.RunSpec(
        variant=variant, model=GSONParams(**GWR), sampler="sphere",
        capacity=64, max_deg=12, max_iterations=iters, check_every=10,
        qe_threshold=1e-9, n_probe=128, device="cpu", **kw)


def _same_network(a, b) -> bool:
    return (torch.equal(a.w, b.w) and torch.equal(a.nbr, b.nbr)
            and torch.equal(a.error, b.error)
            and int(a.signal_count) == int(b.signal_count))


def _rows(history):
    """History rows without the wave's network index, which a retry
    changes."""
    return [{k: v for k, v in r.items() if k != "network"}
            for r in history]


def _dedicated(spec, seed):
    sess = gson.Session(spec, seed=seed)
    sess.run()
    return sess.result()[1]


# ---------------------------------------------------------------------------
# waves


def test_no_slot_starvation_mixed_fleet_legacy():
    # a long "single" job shares the server with quick fleet jobs; a
    # queued job is admitted as soon as a slot frees, not when the whole
    # wave drains behind the straggler
    srv = ReconstructionServer(slots=2, slice_iters=10)
    single = _recon_spec("single", iters=120,
                         variant_config=gson.SingleConfig(chunk=4))
    long_legacy = srv.submit(single)
    quick_fleet = srv.submit(_recon_spec("multi", iters=20))
    queued = srv.submit(_recon_spec("multi", iters=20))

    srv.step()                          # both slots fill; third waits
    assert queued.session is None
    assert isinstance(long_legacy.session, gson.Session)
    for _ in range(50):                 # drain the quick fleet job
        if quick_fleet.done:
            break
        srv.step()
    assert quick_fleet.done and not long_legacy.done
    srv.step()                          # freed slot refills THIS tick
    assert queued.session is not None, \
        "queued job starved behind the long legacy job"
    assert not long_legacy.done

    done = srv.run(max_ticks=200)
    assert {j.jid for j in done} == {long_legacy.jid, quick_fleet.jid,
                                     queued.jid}
    for job, iters in ((long_legacy, 120), (quick_fleet, 20),
                       (queued, 20)):
        assert job.stats.iterations == iters
        assert job.history, "history must stream during serving"
    want = _dedicated(single, 0)
    assert (long_legacy.stats.units, long_legacy.stats.signals) == (
        want.units, want.signals)
    assert long_legacy.history == want.history


def test_incremental_waves_match_dedicated_sessions():
    # jobs admitted across different (overlapping) waves still produce
    # exactly their dedicated-session results
    srv = ReconstructionServer(slots=2, slice_iters=7)
    jobs = [srv.submit(_recon_spec("multi-fused", iters=n), seed=s)
            for s, n in enumerate((12, 30, 18))]
    srv.run(max_ticks=100)
    for s, (job, n) in enumerate(zip(jobs, (12, 30, 18))):
        stats = _dedicated(_recon_spec("multi-fused", iters=n), s)
        assert job.stats.iterations == stats.iterations == n
        assert job.stats.units == stats.units
        assert job.stats.signals == stats.signals
        assert job.stats.quantization_error == stats.quantization_error


def test_reconstruction_server_waves():
    spec = gson.RunSpec(variant="multi", model=GSONParams(**GWR),
                        sampler="sphere", capacity=128, max_deg=12,
                        max_iterations=25, check_every=10,
                        qe_threshold=0.05, n_probe=256, device="cpu")
    srv = ReconstructionServer(slots=2, slice_iters=10)
    jobs = [srv.submit(spec, seed=s) for s in range(3)]
    finished = srv.run(max_ticks=50)
    assert len(finished) == 3
    for s, job in enumerate(jobs):
        assert job.done
        assert job.stats.iterations == 25
        assert job.stats.units > 2
        assert job.history, "history must stream during serving"
        assert job.stats.units == _dedicated(spec, s).units


# ---------------------------------------------------------------------------
# supervision (the serving cases of tests/test_robustness.py)


def test_serving_poison_retries_from_checkpoint(tmp_path):
    spec = _spec(iters=300)
    inj = gson.GsonFaultInjector({2: {"kind": "poison", "job": 1},
                                  3: {"kind": "crash_checkpoint"}})
    srv = ReconstructionServer(slots=4, slice_iters=50,
                               checkpoint_dir=str(tmp_path),
                               injector=inj, max_retries=2,
                               backoff_ticks=1)
    jobs = [srv.submit(spec, seed=s) for s in range(3)]
    with pytest.warns(RuntimeWarning, match="checkpoint failed"):
        done = srv.run(max_ticks=100)
    assert {j.jid for j in done} == {0, 1, 2}
    assert all(j.status == "done" for j in jobs)
    # the poisoned job took exactly one supervised retry ...
    assert jobs[1].retries == 1
    assert jobs[1].error["kind"] == "unhealthy_state"
    assert jobs[1].error["job"] == 1
    # ... the healthy ones none
    assert jobs[0].retries == 0 and jobs[2].retries == 0
    # the retried job equals a fault-free run
    ref_srv = ReconstructionServer(slots=1, slice_iters=50)
    ref = ref_srv.submit(spec, seed=1)
    ref_srv.run(max_ticks=100)
    assert jobs[1].stats.units == ref.stats.units
    assert (jobs[1].stats.quantization_error
            == ref.stats.quantization_error)
    assert jobs[1].stats.iterations == ref.stats.iterations
    assert _rows(jobs[1].history) == _rows(ref.history)


def test_serving_exhausts_retry_budget_to_structured_failure():
    spec = _spec(iters=300)
    always_failing = spec.replace(
        sampler=gson.FaultySampler(make_sampler("sphere"), fail_times=99))
    srv = ReconstructionServer(slots=2, slice_iters=50, max_retries=1,
                               backoff_ticks=1)
    bad = srv.submit(always_failing, seed=0)
    good = srv.submit(spec, seed=1)
    done = srv.run(max_ticks=100)            # must NOT raise
    assert {j.jid for j in done} == {bad.jid, good.jid}
    assert good.status == "done"
    assert bad.status == "failed" and bad.done
    assert bad.retries == 2                  # initial try + 1 retry
    assert bad.error["kind"] == "advance_error"
    assert "injected sampler failure" in bad.error["detail"]


def test_serving_sampler_recovers_after_transient_failure():
    spec = _spec(iters=200)
    flaky = spec.replace(
        sampler=gson.FaultySampler(make_sampler("sphere"), fail_times=1))
    srv = ReconstructionServer(slots=1, slice_iters=50, max_retries=2,
                               backoff_ticks=1)
    job = srv.submit(flaky, seed=0)
    srv.step()          # the wave starts lazily: its first draw fails
    assert job.status == "retrying"         # ... in the advance
    assert job.error["kind"] == "advance_error"
    srv.run(max_ticks=100)
    assert job.status == "done"
    assert job.retries == 1
    # the failure consumed no signals: same result as fault-free
    ref_state, _ = gson.run(spec, seed=0)
    assert job.stats.units == int(ref_state.n_active)


def test_serving_run_returns_terminal_status_for_every_job():
    spec = _spec(iters=300)
    srv = ReconstructionServer(slots=1, slice_iters=10)
    a = srv.submit(spec, seed=0)
    b = srv.submit(spec, seed=1)
    out = srv.run(max_ticks=2)
    # nothing dropped: both jobs come back, marked
    assert {j.jid for j in out} == {a.jid, b.jid}
    assert {j.status for j in out} == {"budget_exhausted"}
    # a later run picks them back up to completion
    out2 = srv.run(max_ticks=1000)
    assert {j.jid for j in out2} == {a.jid, b.jid}
    assert all(j.status == "done" for j in out2)


def test_serving_stall_detector_faults_wedged_job():
    spec = _spec(iters=200)
    slow = spec.replace(
        sampler=gson.FaultySampler(make_sampler("sphere"), hang_s=0.1))
    srv = ReconstructionServer(slots=1, slice_iters=2, max_retries=0,
                               tick_timeout_s=0.05)
    job = srv.submit(slow, seed=0)
    srv.run(max_ticks=20)                    # returns instead of wedging
    assert job.status == "failed"
    assert job.error["kind"] == "stall"


# ---------------------------------------------------------------------------
# the server's other rules


def test_backoff_doubles_and_the_clock_fast_forwards():
    spec = _spec(iters=20).replace(
        sampler=gson.FaultySampler(make_sampler("sphere"), fail_times=2))
    srv = ReconstructionServer(slots=1, slice_iters=10, max_retries=2,
                               backoff_ticks=3)
    job = srv.submit(spec, seed=0)
    gates, turns = [], 0
    while not job.done:
        srv.step()
        turns += 1
        if job.status == "retrying" and job.not_before_tick not in gates:
            gates.append(job.not_before_tick)
            assert job.not_before_tick - job.error["tick"] == \
                3 * 2 ** (job.retries - 1)
    assert gates == [1 + 3, 5 + 6]
    assert job.status == "done" and job.retries == 2
    # idle ticks cost one loop turn each wait, not one per tick
    assert srv.ticks == 13 and turns == 6


def test_failed_wave_construction_returns_the_wave_and_raises():
    srv = ReconstructionServer(slots=2, slice_iters=10)
    good = srv.submit(_spec(iters=20), seed=0)
    bad = srv.submit(_spec(iters=20, backend="no-such-backend"), seed=1)
    with pytest.raises(KeyError, match="no-such-backend"):
        srv.step()
    assert srv.queue == [good, bad]
    assert good.status == bad.status == "queued"


def test_device_loss_retries_every_wave_free(tmp_path):
    spec = _spec(iters=80)
    inj = gson.GsonFaultInjector({2: {"kind": "device_loss"}})
    srv = ReconstructionServer(slots=3, slice_iters=20,
                               checkpoint_dir=str(tmp_path), injector=inj,
                               backoff_ticks=5)
    jobs = [srv.submit(spec, seed=s) for s in range(3)]
    srv.step()
    srv.step()
    srv.step()          # tick 2: the wave dies before it advances
    assert all(j.status == "running" and j.retries == 0 for j in jobs)
    assert all(j.error["kind"] == "device_loss" for j in jobs)
    assert len(srv._fleets) == 3      # one single-job wave per retry
    srv.run(max_ticks=20)
    for s, job in enumerate(jobs):
        assert job.status == "done" and job.retries == 0
        assert _rows(job.history) == _dedicated(spec, s).history


def test_failing_backend_job_fails_and_never_completes():
    broken = _spec(iters=50).replace(
        backend=gson.lowering_failure_backend())
    srv = ReconstructionServer(slots=2, slice_iters=10, max_retries=1)
    bad = srv.submit(broken, seed=0)
    good = srv.submit(_spec(iters=50), seed=1)
    srv.run(max_ticks=50)
    assert bad.status == "failed" and bad.stats is None
    assert bad.error["kind"] == "advance_error"
    assert "injected kernel lowering failure" in bad.error["detail"]
    assert good.status == "done"


def test_server_on_a_one_rank_mesh_matches_the_server_without(tmp_path):
    """Waves placed on a one-rank gloo mesh in this process, under a
    poison and a device loss that keeps the one survivor: the same
    statuses, retries, stats and rows as with no mesh
    (``tests/test_torch_elastic.py`` shrinks a 4-rank mesh)."""
    dist = pytest.importorskip("torch.distributed")
    faults = {1: {"kind": "poison", "job": 1},
              3: {"kind": "device_loss", "survivors": 1}}

    def serve(root, mesh):
        srv = ReconstructionServer(
            slots=3, slice_iters=20, checkpoint_dir=str(root), mesh=mesh,
            injector=gson.GsonFaultInjector(copy.deepcopy(faults)))
        jobs = [srv.submit(_spec(iters=80), seed=s) for s in range(3)]
        srv.run(max_ticks=40)
        return srv, [(j.status, j.retries, j.stats.iterations,
                      j.stats.units, j.stats.signals, _rows(j.history))
                     for j in jobs]

    _, want = serve(tmp_path / "plain", None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        srv, got = serve(tmp_path / "mesh", gson.MeshSpec(axis="network"))
    finally:
        dist.destroy_process_group()
    assert got == want
    assert [g[:2] for g in got] == [("done", 0), ("done", 1), ("done", 0)]
    assert srv.mesh.ndev() == 1 and not srv.left


# ---------------------------------------------------------------------------
# against the JAX server


PARITY_SCHEDULE = {
    2: {"kind": "poison", "job": 1, "poison": "nan"},
    3: {"kind": "crash_checkpoint"},
    4: {"kind": "fail_job", "job": 0},
    6: {"kind": "device_loss"},
}


def _parity_specs(pkg_gson, params, **kw):
    base = dict(model=params, sampler="sphere", capacity=64, max_deg=12,
                check_every=10, qe_threshold=1e-9, n_probe=128, **kw)
    return [pkg_gson.RunSpec(variant=v, max_iterations=n, **base)
            for v, n in (("multi", 80), ("multi", 60), ("multi-fused", 70),
                         ("multi", 40))]


def _drive(srv, jobs):
    """Step ``srv`` to the end; per step each job's (status, retries,
    error kind), and where each job's network last lived."""
    ticks, where = [], {}
    for _ in range(100):
        if not (srv.queue or srv._retry or srv._live_jobs()):
            break
        srv.step()
        for f, wave in srv._fleets:
            for i, j in enumerate(wave):
                if j.session is f:
                    where[j.jid] = (f, i)
        ticks.append((srv.ticks, [
            (j.status, j.retries, j.error and j.error["kind"])
            for j in jobs]))
    return ticks, where


def test_server_matches_the_jax_server(tmp_path):
    pytest.importorskip("jax")
    from repro import gson as jgson
    from repro.core.gson.state import GSONParams as JParams
    from repro.serving.engine import ReconstructionServer as JaxServer

    kw = dict(slots=3, slice_iters=10, max_retries=2, backoff_ticks=1)
    jsrv = JaxServer(checkpoint_dir=str(tmp_path / "jax"),
                     injector=jgson.GsonFaultInjector(
                         copy.deepcopy(PARITY_SCHEDULE)), **kw)
    tsrv = ReconstructionServer(
        checkpoint_dir=str(tmp_path / "torch"),
        injector=gson.GsonFaultInjector(copy.deepcopy(PARITY_SCHEDULE)),
        draws=lambda jid, seed: JaxReplayDraws("sphere", seed=seed), **kw)
    jspecs = _parity_specs(jgson, JParams(**GWR))
    tspecs = _parity_specs(gson, GSONParams(**GWR), device="cpu")
    jjobs = [jsrv.submit(s, seed=10 + k) for k, s in enumerate(jspecs)]
    tjobs = [tsrv.submit(s, seed=10 + k) for k, s in enumerate(tspecs)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jticks, jwhere = _drive(jsrv, jjobs)
        tticks, twhere = _drive(tsrv, tjobs)
    assert tticks == jticks
    kinds = {k for _, row in tticks for _, _, k in row}
    assert kinds == {None, "unhealthy_state", "injected_failure",
                     "device_loss"}
    assert all(j.status == "done" for j in tjobs)
    for jj, tj in zip(jjobs, tjobs):
        ctx = f"job {tj.jid}"
        assert tj.stats.iterations == jj.stats.iterations, ctx
        assert len(tj.history) == len(jj.history) > 0, ctx
        for row, jrow in zip(tj.history, jj.history):
            assert ({k: v for k, v in row.items() if k != "qe"}
                    == {k: v for k, v in jrow.items() if k != "qe"}), ctx
            assert row["qe"] == pytest.approx(jrow["qe"], rel=1e-6), ctx
        f, i = twhere[tj.jid]
        jf, ji = jwhere[jj.jid]
        got = convert.state_to_numpy(f.network(i))
        jst = jf.network(ji)
        for name in DISCRETE:
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(jst, name)), f"{ctx} {name}")
        for name in FLOATS:
            np.testing.assert_allclose(
                got[name], np.asarray(getattr(jst, name)), rtol=1e-6,
                atol=1e-7, err_msg=f"{ctx} {name}")
