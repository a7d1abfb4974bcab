#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. environment — torch and CUDA versions, the card's name and power
   limit; TF32 off for matrix products and convolutions.
2. build — every CUDA source of the port, one ``nvcc`` each, in parallel.
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes (C=4096, K=16, d=3, a buffer of m=8192 signals,
   unmasked, masked to the m-schedule's m_t = next_pow2(n_active) as the
   main path hands it, and masked to m_t=64) on a pool grown by a short
   plain run: bitwise where the contract says so (Find Winners ids where
   the three nearest distances are more than 1e-4 apart, its distances
   within rtol=2e-4, atol=1e-5; the neighbor sums of the accumulators
   within rtol=1e-6, atol=1e-7; their winner fields and the aged edge
   table, which the same launch computes, bitwise), and bitwise
   repeatable. Times of the kernel (the lock and the fused accumulators
   at both the full and the main path's masked buffer), its plain version
   and, where one PyTorch call computes the same function, that call; the
   bound; the device kernels one call launches (``torch.profiler``),
   which must be the ones ``DEVICE_KERNELS`` names, and the port's device
   launches in one ``update_phase_op`` call (3); and, as the floor of a
   launch-bound kernel, the time of one launch of a one-element
   ``fill_``.
4. main path — ``Session(RunSpec())`` (variant ``multi``) and
   ``variant="multi-fused"`` at the full default geometry through the
   ``cuda-full`` backend, with every launch counter set to 0 before and
   read after; the state must be finite with symmetric edges, and the
   ``reference`` backend from the same seed must give the same history
   rows over the first ``HORIZON`` iterations. Then the SOAM sphere
   configuration of the JAX package's acceptance gate, whose chi, units
   and QE are printed beside the JAX CPU result (not asserted: the draws
   differ). Last, ``PAIRS`` alternating pairs of ``cuda-full`` and
   ``reference`` runs time the two backends end to end.
5. fleet kernels — each wrapper at B = 8 (eight pools grown by a fleet
   on the ``reference`` backend, the main path's shapes) against its
   plain version, with the same tolerances, unmasked and masked by each
   network's m-schedule; device ms and device launches per call.
6. fleet — ``FleetSession(FleetSpec.broadcast(RunSpec(), seeds=range(8)))``
   for ``FLEET_ITERS`` iterations with ``multi`` and ``multi-fused``,
   every launch counter set to 0 before and read after: each wrapper
   launches once per fleet iteration for the whole batch, and every
   network's state fields and history rows equal those of its own
   ``Session(RunSpec(), seed=i)`` (``qe`` within 1e-6; its mean runs over
   a batch of another shape). Network-iterations/s at B = 1 (the eight
   sessions) and at B = 8.
7. checkpoint — a ``Session`` runs ``CKPT_ITERS`` iterations, checkpoints,
   is dropped, is restored and runs as many again: its rows and state
   equal an uninterrupted run's; the same for a ``FleetSession`` at
   B = 4; for ``multi`` and ``multi-fused``.
8. profile — where the main path's time goes (``torch.profiler``):
   device busy share and top kernels at B = 1, then device ops and
   device time per iteration and the busy share of the fleet at B = 8,
   whose window must show one launch of each of the port's device
   kernels per fleet iteration (a profiler that records nothing prints
   "not measured" instead).
9. report — the ``kernels`` JSON line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

It needs ``src/repro_torch`` beside it and a CUDA device; without
either it exits nonzero before printing any result. Long output goes to
``chiprun_out/``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

SEED = 7
HORIZON = 64           # iterations over which cuda-full == reference rows
MAIN_ITERS = 256       # main-path budget per variant
PAIRS, PAIR_ITERS = 3, 128   # cuda-full vs reference timing pairs
FLEET_B, FLEET_ITERS = 8, 128     # the fleet phase
# the checkpoint phase cuts at CKPT_ITERS, a multiple of the fused
# superstep (64), so multi-fused emits the rows of an uninterrupted run
CKPT_B, CKPT_ITERS = 4, 64
STATE_FIELDS = ("w", "active", "nbr", "age", "error", "firing",
                "threshold", "topo_state", "inconsistent_for", "n_active",
                "signal_count", "discarded")
GATE = dict(capacity=768, iterations=1500, jax_chi=2, jax_units=94,
            jax_qe=0.02538)

# The device kernels that one call of each wrapper launches, by their
# names in the CUDA sources; the profile phase sums the port's kernels
# over these names.
DEVICE_KERNELS = {
    "find_winners": ("find_winners_kernel",),
    "winner_lock": ("lock_tile_kernel",),
    "update_accum": ("owner_scatter_kernel", "accum_group_kernel"),
}
# Edge aging (B4) runs inside the accumulators' launch: its entry of the
# kernels line reports that launch.
SHARED = {"edge_age": "update_accum"}
# The accumulators and edge aging as two calls, before the fusion: 0.0050
# + 0.0033 ms (this script on an H100 80GB HBM3 at 700 W).
PAIR_BEFORE_MS = 0.0083

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 (no tensor core)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` call, from CUDA events around ``reps``
    back-to-back calls. A sleep kernel first holds the card while the
    host queues the calls, so host overhead does not show."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e6) * reps)  # ~2.5 ms per call at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_launches(fn, calls: int = 4) -> list:
    """Names of the device kernels that one ``fn()`` launches, from
    ``torch.profiler`` over ``calls`` calls in one window (empty if it
    records no device activity). A window can come back empty now and
    then, so an empty one is taken again, up to three times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = Counter(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        # a window missing some of the calls' ops is taken again too
        if seen and all(n % calls == 0 for n in seen.values()):
            return [name for name, n in sorted(seen.items())
                    for _ in range(n // calls)]
    return []


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def near_tie_free(sig, w, active, eps=1e-4):
    """Rows whose three nearest active distances (float64) are more than
    ``eps`` apart."""
    import torch
    x, u = sig.double(), w.double()
    d = (x * x).sum(1, keepdim=True) - 2 * x @ u.T + (u * u).sum(1)
    d = torch.where(active[None, :], d, math.inf)
    top = torch.topk(d, 3, dim=1, largest=False).values
    gaps = torch.diff(top, dim=1).nan_to_num(nan=math.inf)
    return (gaps > eps).all(dim=1)


# ---------------------------------------------------------------------------


def phase_environment():
    import torch
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{len(_build.SOURCES)} sources (parallel nvcc)")
    OUT.mkdir(exist_ok=True)
    with open(OUT / "build.log", "w") as f:
        for name, (sec, text) in built.items():
            f.write(f"== {name}: {sec:.1f} s\n{text}\n")
            for line in text.splitlines():
                if "Used" in line:
                    log(f"  ptxas {name}: {line.strip()}")


def grown_pool(seed: int):
    """A pool at the default geometry grown by a short plain run."""
    from repro_torch import gson
    spec = gson.RunSpec(variant="multi-fused", backend="reference",
                        max_iterations=128)
    sess = gson.Session(spec, seed=seed)
    sess.run()
    return sess.state, sess.cohorts[0].params


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.core.gson import topology as topo
    from repro_torch.core.gson.multi import (find_winners_reference,
                                             stable_units,
                                             update_phase_inputs)
    from repro_torch.core.gson.sampling import make_sampler
    from repro_torch.core.gson.superstep import next_pow2
    from repro_torch.kernels.find_winners import kernel as fwk
    from repro_torch.kernels.update_phase import kernel as upk
    from repro_torch.kernels.update_phase.ops import update_phase_op

    dev = torch.device("cuda")
    state, params = grown_pool(SEED)
    C, K, D = state.capacity, state.max_deg, state.dim
    M = params.max_parallel
    log(f"kernels: pool of {int(state.n_active)} active units, C={C} "
        f"K={K} d={D} M={M}")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sig = make_sampler("sphere")(g, M)
    results = {}

    # ---- B1 find winners
    act = state.active
    args = (sig[None].contiguous(), state.w[None].contiguous(), act[None])
    d2k, idk = fwk.find_winners_top2(*args)
    d2k2, idk2 = fwk.find_winners_top2(*args)
    d2p, idp = fwk.find_winners_top2_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(d2k, d2k2) and torch.equal(idk, idk2), \
        "find_winners not repeatable"
    ok = near_tie_free(sig, state.w, act)
    assert torch.equal(idk[0][ok], idp[0][ok]), "find_winners ids differ"
    torch.testing.assert_close(d2k, d2p, rtol=2e-4, atol=1e-5)
    # what the function needs: the signals, the rows of the active units
    # and every active flag, the outputs; 2d+2 flops per (signal, active
    # unit) pair (an inactive unit cannot win while two are active)
    n_act = int(act.sum())
    nbytes = (M * D + n_act * D) * 4 + C + M * 2 * 8
    b, by = bound_ms(nbytes, M * n_act * (2 * D + 2))
    results["find_winners"] = dict(
        fn=lambda: fwk.find_winners_top2(*args),
        plain=lambda: fwk.find_winners_top2_plain(*args), library=None,
        err=float((d2k - d2p).abs().max()), bound=b, by=by,
        note=f"ids equal on {int(ok.sum())}/{M} tie-free rows")

    # ---- B2 and the fused B3 + B4 on the main path's inputs: the full
    # buffer, the buffer masked as the main path's m-schedule masks it,
    # and m_t = 64
    wid, sid, d2b, _ = find_winners_reference(sig, state.w, act)
    prio = torch.randperm(M, generator=g, device=dev, dtype=torch.int32)
    stable = stable_units(state, params)
    errs = {"update_accum": 0.0, "edge_age": 0.0}
    m_main = min(next_pow2(n_act), M)
    main_fns = {}   # B2 and B3 + B4 on the buffer as the main path hands it
    for m_t in dict.fromkeys((M, m_main, 64)):
        mask = torch.arange(M, device=dev) < m_t
        prio_m = torch.where(mask, prio, upk.BIG_PRIO)
        largs = (wid[None].contiguous(), prio_m[None].contiguous(), C)
        best = upk.winner_lock_min(*largs)
        assert torch.equal(best, upk.winner_lock_min(*largs)), "lock repeat"
        assert torch.equal(best, upk.winner_lock_min_plain(*largs)), \
            "winner_lock differs"
        selected = (prio_m == best[0][wid.long()]) & mask
        ins, adapt, scale_b, dec_b, _, _, _, scale_n, dec_n = \
            update_phase_inputs(state, wid, d2b, selected, params)
        aargs = [x[None].contiguous() for x in (
            sig, wid, selected, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
            state.nbr, state.w, sid, state.age, stable)]
        got = upk.update_accum(*aargs)
        again = upk.update_accum(*aargs)
        plain = upk.update_accum_plain(*aargs)
        names = ("w1", "nsc", "nsx", "err", "decb_u", "decn_u", "wind",
                 "age")
        for name, k, k2, p in zip(names, got, again, plain):
            assert torch.equal(k, k2), f"update_accum {name} not repeatable"
            if name in ("w1", "err", "decb_u", "wind", "age"):
                assert torch.equal(k, p), f"update_accum {name} differs"
            torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-7)
            key = "edge_age" if name == "age" else "update_accum"
            errs[key] = max(errs[key], float((k - p).abs().max()))
        n_reset = int(topo.edge_slots(state.nbr, wid, sid, adapt).sum())
        n_sel = int(selected.sum())
        log(f"  m_t={m_t}: {n_sel} lock survivors, "
            f"{int(adapt.sum())} adapting, {n_reset} winner-second slots "
            f"reset; B2 and the fused B3 + B4 match their plain versions")
        if m_t == m_main:
            main_fns["winner_lock"] = lambda a=largs: upk.winner_lock_min(*a)
            main_fns["update_accum"] = lambda a=aargs: upk.update_accum(*a)
            op_args = (state, sig, wid, sid, d2b, prio, params, mask)
        if m_t == M:   # the unmasked buffer is the timed case
            init = torch.full((1, C), upk.BIG_PRIO, dtype=torch.int32,
                              device=dev)
            results["winner_lock"] = dict(
                fn=lambda a=largs: upk.winner_lock_min(*a),
                plain=lambda a=largs: upk.winner_lock_min_plain(*a),
                library=lambda a=largs, i=init: i.scatter_reduce(
                    1, a[0].long(), a[1], reduce="amin"),
                err=0.0, bound=bound_ms(M * 8 + C * 4, 0)[0], by="bytes",
                note="bitwise")
            # what the function needs: sel and wid of every row, the
            # other per-signal inputs and sid of the selected rows, nbr,
            # w, the age table in and out, stable, and its other outputs
            need = (M * 5 + n_sel * (D * 4 + 1 + 12 + 2 * K * 4 + 4)
                    + C * K * 4 + C * D * 4 + C * K * 8 + C
                    + C * (2 * D + 5) * 4)
            results["update_accum"] = dict(
                fn=lambda a=aargs: upk.update_accum(*a),
                plain=lambda a=aargs: upk.update_accum_plain(*a),
                library=None, err=None, bound=bound_ms(need, 0)[0],
                by="bytes", note="winner fields and aged table bitwise")
    results["update_accum"]["err"] = errs["update_accum"]

    for name, r in results.items():
        r["ms"] = device_ms(r["fn"], 50)
        r["plain_ms"] = device_ms(r["plain"], 10)
        r["library_ms"] = (device_ms(r["library"], 50)
                           if r["library"] is not None else None)
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        main = (f"  at m_t={m_main}: {device_ms(main_fns[name], 50):.4f} ms"
                if name in main_fns else "")
        launched = device_launches(r["fn"])
        if launched:
            want = DEVICE_KERNELS[name]
            assert len(launched) == len(want) and all(
                any(k in n for k in want) for n in launched), (
                f"{name} launched {launched}, expected {want}")
            per_call = f"{len(launched)} device launch(es) per call"
        else:
            per_call = "device launches per call not measured"
        log(f"  {name:13s} kernel {r['ms']:.4f} ms{main}  plain "
            f"{r['plain_ms']:.4f} ms  library {lib} ms  bound "
            f"{r['bound']:.5f} ms ({r['by']})  max|err| {r['err']:.3g}  "
            f"{per_call}  {r['note']}")
    for name, host in SHARED.items():
        results[name] = dict(results[host], err=errs[name],
                             note=f"inside {host}'s launch")
    log(f"  edge_age      inside update_accum's launch: max|err| "
        f"{errs['edge_age']:.3g} (aged table bitwise); the two as separate "
        f"calls took {PAIR_BEFORE_MS:.4f} ms before the fusion")

    # the port's device launches in one Update phase
    ours = [n for names in DEVICE_KERNELS.values() for n in names]
    launched = device_launches(lambda: update_phase_op(*op_args))
    mine = [o for n in launched for o in ours if o in n]
    if launched:
        assert len(mine) == 3, f"update_phase_op launched {mine}"
        log(f"  update_phase_op at m_t={m_main}: {len(mine)} launches of "
            f"the port's kernels ({', '.join(mine)}), {len(launched)} "
            f"device ops in all")
    else:
        log("  update_phase_op device launches: not measured")
    one = torch.zeros(1, device=dev)
    log(f"  launch floor: a one-element fill_ takes "
        f"{device_ms(lambda: one.fill_(0), 50):.4f} ms")
    return results


def counters():
    from repro_torch.kernels.find_winners import kernel as fwk
    from repro_torch.kernels.update_phase import kernel as upk
    wrappers = {"find_winners": fwk.find_winners_top2,
                "winner_lock": upk.winner_lock_min,
                "update_accum": upk.update_accum}
    return {**wrappers, **{k: wrappers[v] for k, v in SHARED.items()}}


def check_state(st):
    import numpy as np
    import torch
    act = st.active
    assert torch.isfinite(st.w[act]).all(), "non-finite weights"
    for f in (st.error, st.firing, st.threshold):
        assert torch.isfinite(f[act]).all(), "non-finite unit field"
    nbr = st.nbr.cpu().numpy()
    age = st.age.cpu().numpy()
    rows, slots = np.nonzero(nbr >= 0)
    cols = nbr[rows, slots]
    back = nbr[cols] == rows[:, None]
    assert np.all(back.sum(1) == 1), "asymmetric edges"
    assert np.all(age[cols, back.argmax(1)] == age[rows, slots]), \
        "asymmetric ages"
    assert np.all(cols != rows), "self edges"
    assert np.all(st.active.cpu().numpy()[cols]), "edge to inactive unit"


def run_session(spec, seed, budget):
    import torch
    from repro_torch import gson
    from repro_torch.core.gson import metrics
    sess = gson.Session(spec, seed=seed)
    sess._start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(budget=budget)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, stats = sess.result()
    _, _, _, chi = metrics.euler_characteristic(st)
    return sess, st, stats, wall, chi


def phase_paired_timing():
    """End to end, ``cuda-full`` against the ``reference`` backend:
    ``PAIRS`` pairs of ``PAIR_ITERS``-iteration runs per variant (same
    seed within a pair, the order alternating between pairs). Prints
    each run's it/s and the medians."""
    import statistics
    from repro_torch import gson
    for variant in ("multi", "multi-fused"):
        its = {"cuda-full": [], "reference": []}
        for i in range(PAIRS):
            order = list(its) if i % 2 == 0 else list(its)[::-1]
            for be in order:
                _, _, stats, wall, _ = run_session(
                    gson.RunSpec(variant=variant, backend=be),
                    SEED + 1 + i, PAIR_ITERS)
                its[be].append(stats.iterations / wall)
        log(f"paired {variant} ({PAIRS} pairs x {PAIR_ITERS} it): " + "; ".join(
            f"{be} median {statistics.median(v):.1f} it/s "
            f"{[round(x, 1) for x in v]}" for be, v in its.items()))


def phase_main_path():
    import torch
    from repro_torch import gson
    cnt = counters()
    for f in cnt.values():
        f.launches = 0
    runs = {}
    for variant in ("multi", "multi-fused"):
        spec = gson.RunSpec(variant=variant)
        runs[variant] = run_session(spec, SEED, MAIN_ITERS)
    launches = {name: f.launches for name, f in cnt.items()}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    for variant, (sess, st, stats, wall, chi) in runs.items():
        check_state(st)
        log(f"main path {variant}: {stats.iterations} it in {wall:.3f} s "
            f"= {stats.iterations / wall:.1f} it/s, units {stats.units}, "
            f"signals {stats.signals}, QE {stats.quantization_error:.6f}, "
            f"chi {chi}, edges {stats.connections}")
        ref = run_session(gson.RunSpec(variant=variant, backend="reference"),
                          SEED, MAIN_ITERS)
        log(f"  reference backend {variant}: "
            f"{ref[2].iterations / ref[3]:.1f} it/s, units {ref[2].units}")
        rows = [r for r in stats.history if r["iteration"] <= HORIZON]
        rrows = [r for r in ref[2].history if r["iteration"] <= HORIZON]
        assert rows and len(rows) == len(rrows)
        for a, b in zip(rows, rrows):
            assert (a["iteration"], a["units"], a["signals"]) == (
                b["iteration"], b["units"], b["signals"]), (a, b)
            assert math.isclose(a["qe"], b["qe"], rel_tol=1e-4), (a, b)
        same = sum(
            (a["units"], a["signals"]) == (b["units"], b["signals"])
            for a, b in zip(stats.history, ref[2].history))
        log(f"  history rows equal to the reference backend's: "
            f"{same}/{len(stats.history)} (asserted through it {HORIZON})")

    # the JAX package's acceptance-gate configuration
    p = gson.GSONParams(model="soam", insertion_threshold=0.35,
                        age_max=64.0, eps_b=0.1, eps_n=0.01,
                        stuck_window=60)
    spec = gson.RunSpec(
        variant="multi-fused", model=p, sampler="sphere",
        variant_config=gson.FusedConfig(
            superstep=gson.SuperstepConfig(length=64), refresh_every=2),
        capacity=GATE["capacity"], max_deg=16, check_every=25,
        max_iterations=GATE["iterations"])
    sess, st, stats, wall, chi = run_session(spec, 42, None)
    check_state(st)
    log(f"gate config (capacity 768, 1500 it): chi {chi}, units "
        f"{stats.units}, QE {stats.quantization_error:.5f}, "
        f"{stats.iterations} it in {wall:.2f} s "
        f"(JAX reference on CPU: chi {GATE['jax_chi']}, units "
        f"{GATE['jax_units']}, QE {GATE['jax_qe']}; other draws, so not "
        f"asserted)")
    return launches


def grown_fleet(seeds):
    """Pools at the default geometry, one per seed, grown together by a
    short fleet run on the plain backend."""
    from repro_torch import gson
    spec = gson.RunSpec(variant="multi-fused", backend="reference",
                        max_iterations=128)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=seeds))
    fleet.run()
    c = fleet.cohorts[0]
    return c.fstate.nets, c.params


def phase_fleet_kernels():
    """Each wrapper at B = FLEET_B against its plain version, at the main
    path's shapes on eight grown pools, unmasked and masked by each
    network's m-schedule; device ms and launches per call."""
    import torch
    from repro_torch.core.gson.batch import take
    from repro_torch.core.gson.multi import (find_winners_reference,
                                             stable_units,
                                             update_phase_inputs)
    from repro_torch.core.gson.sampling import make_sampler
    from repro_torch.core.gson.superstep import next_pow2
    from repro_torch.kernels.find_winners import kernel as fwk
    from repro_torch.kernels.update_phase import kernel as upk

    dev = torch.device("cuda")
    B = FLEET_B
    nets, params = grown_fleet(range(SEED, SEED + B))
    C, K, D = nets.capacity, nets.max_deg, nets.dim
    M = params.max_parallel
    units = nets.n_active.tolist()
    log(f"fleet kernels: B={B} pools of {units} active units, C={C} K={K} "
        f"d={D} M={M}")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    sampler = make_sampler("sphere")
    sig = torch.stack([sampler(g, M) for _ in range(B)])
    w, act = nets.w.contiguous(), nets.active.contiguous()
    timed = {}

    # ---- B1
    d2k, idk = fwk.find_winners_top2(sig, w, act)
    d2k2, idk2 = fwk.find_winners_top2(sig, w, act)
    d2p, idp = fwk.find_winners_top2_plain(sig, w, act)
    torch.cuda.synchronize()
    assert torch.equal(d2k, d2k2) and torch.equal(idk, idk2), \
        "find_winners not repeatable at B=8"
    torch.testing.assert_close(d2k, d2p, rtol=2e-4, atol=1e-5)
    n_ok = 0
    for b in range(B):
        ok = near_tie_free(sig[b], w[b], act[b])
        assert torch.equal(idk[b][ok], idp[b][ok]), \
            f"find_winners ids differ in network {b}"
        n_ok += int(ok.sum())
    timed["find_winners"] = (lambda: fwk.find_winners_top2(sig, w, act),
                             float((d2k - d2p).abs().max()),
                             f"ids equal on {n_ok}/{B * M} tie-free rows")

    # ---- B2 and the fused B3 + B4: the full buffer, and each network's
    # m-schedule mask as the main path hands it
    wid, sid, d2b, _ = find_winners_reference(sig, w, act)
    prio = torch.stack([torch.randperm(M, generator=g, device=dev,
                                       dtype=torch.int32) for _ in range(B)])
    stable = stable_units(nets, params)
    m_main = torch.tensor([min(next_pow2(n), M) for n in units],
                          device=dev)
    for label, m_t in (("M", torch.full_like(m_main, M)),
                       ("m_t", m_main)):
        mask = torch.arange(M, device=dev) < m_t[:, None]
        prio_m = torch.where(mask, prio, upk.BIG_PRIO).contiguous()
        largs = (wid.contiguous(), prio_m, C)
        best = upk.winner_lock_min(*largs)
        assert torch.equal(best, upk.winner_lock_min(*largs)), "lock repeat"
        assert torch.equal(best, upk.winner_lock_min_plain(*largs)), \
            "winner_lock differs at B=8"
        selected = (prio_m == take(best, wid.long())) & mask
        ins, adapt, scale_b, dec_b, _, _, _, scale_n, dec_n = \
            update_phase_inputs(nets, wid, d2b, selected, params)
        aargs = [x.contiguous() for x in (
            sig, wid, selected, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
            nets.nbr, w, sid, nets.age, stable)]
        got = upk.update_accum(*aargs)
        again = upk.update_accum(*aargs)
        plain = upk.update_accum_plain(*aargs)
        err = 0.0
        names = ("w1", "nsc", "nsx", "err", "decb_u", "decn_u", "wind",
                 "age")
        for name, k, k2, p in zip(names, got, again, plain):
            assert torch.equal(k, k2), f"update_accum {name} not repeatable"
            if name in ("w1", "err", "decb_u", "wind", "age"):
                assert torch.equal(k, p), f"update_accum {name} differs"
            torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-7)
            err = max(err, float((k - p).abs().max()))
        log(f"  B={B} buffer {label}: {int(selected.sum())} lock survivors "
            f"over the batch; B2 bitwise, the fused B3 + B4 winner fields "
            f"and aged table bitwise, sums within {err:.3g}")
        if label == "M":
            timed["winner_lock"] = (
                lambda a=largs: upk.winner_lock_min(*a), 0.0, "bitwise")
            timed["update_accum"] = (
                lambda a=aargs: upk.update_accum(*a), err,
                "winner fields and aged table bitwise")
    out = {}
    for name, (fn, err, note) in timed.items():
        ms = device_ms(fn, 50)
        launched = device_launches(fn)
        if launched:
            want = DEVICE_KERNELS[name]
            assert len(launched) == len(want) and all(
                any(k in n for k in want) for n in launched), (
                f"{name} at B={B} launched {launched}, expected {want}")
            per_call = f"{len(launched)} device launch(es) per call"
        else:
            per_call = ("device launches per call not measured here "
                        "(profiler empty; the profile phase counts them "
                        "per fleet iteration)")
        out[name] = ms
        log(f"  {name:13s} B={B}: kernel {ms:.4f} ms ({ms / B:.5f} ms per "
            f"network)  max|err| {err:.3g}  {per_call}  {note}")
    return out


def assert_same_network(a, b, rows_a, rows_b, ctx):
    """States bitwise; rows equal with ``qe`` within 1e-6 relative.
    Returns the largest relative ``qe`` difference."""
    import torch
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{ctx}: {name} differs"
    assert len(rows_a) == len(rows_b) > 0, ctx
    worst = 0.0
    for x, y in zip(rows_a, rows_b):
        assert (x["iteration"], x["units"], x["signals"]) == (
            y["iteration"], y["units"], y["signals"]), (ctx, x, y)
        rel = abs(x["qe"] - y["qe"]) / max(abs(y["qe"]), 1e-30)
        assert rel <= 1e-6, (ctx, x, y)
        worst = max(worst, rel)
    return worst


def phase_fleet():
    """``FleetSession`` at B = FLEET_B on the default RunSpec against the
    eight sessions it stands for; one launch per wrapper per fleet
    iteration."""
    import torch
    from repro_torch import gson
    wrappers = {n: f for n, f in counters().items() if n not in SHARED}
    out = {}
    for variant in ("multi", "multi-fused"):
        spec = gson.RunSpec(variant=variant, max_iterations=FLEET_ITERS)
        sessions, t_sess = [], 0.0
        for i in range(FLEET_B):
            sess = gson.Session(spec, seed=i)
            sess._start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run()
            torch.cuda.synchronize()
            t_sess += time.perf_counter() - t0
            sessions.append(sess)
        fleet = gson.FleetSession(gson.FleetSpec.broadcast(
            spec, seeds=range(FLEET_B)))
        fleet._start()
        torch.cuda.synchronize()
        for f in wrappers.values():
            f.launches = 0
        t0 = time.perf_counter()
        fleet.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: f.launches for n, f in wrappers.items()}
        assert list(fleet.iterations) == [FLEET_ITERS] * FLEET_B, \
            fleet.iterations
        assert all(n == FLEET_ITERS for n in launches.values()), (
            f"{variant}: {launches} launches in {FLEET_ITERS} fleet "
            "iterations, expected one per iteration")
        worst = 0.0
        for i, sess in enumerate(sessions):
            st, stats = fleet.result(i)
            worst = max(worst, assert_same_network(
                st, sess.result()[0], stats.history, sess.stats.history,
                f"{variant} network {i}"))
        rate1 = FLEET_B * FLEET_ITERS / t_sess
        rate8 = FLEET_B * FLEET_ITERS / wall
        out[variant] = (rate1, rate8, launches)
        log(f"fleet {variant}: B={FLEET_B} x {FLEET_ITERS} it, launches "
            f"{launches} (one per fleet iteration); {FLEET_B}/{FLEET_B} "
            f"networks equal to their sessions (state fields bitwise, "
            f"rows equal, qe max rel diff {worst:.3g}); network-it/s "
            f"B=1 {rate1:.1f} (eight sessions), B={FLEET_B} {rate8:.1f} "
            f"(x{rate8 / rate1:.2f})")
    return out


def phase_checkpoint():
    """Cut a run at CKPT_ITERS, checkpoint, drop it, restore and finish:
    rows and state equal an uninterrupted run's, for a Session and for a
    FleetSession at B = CKPT_B."""
    import shutil
    from repro_torch import gson
    root = ROOT / "build" / "chip_smoke_ckpt"
    for variant in ("multi", "multi-fused"):
        spec = gson.RunSpec(variant=variant, max_iterations=2 * CKPT_ITERS)
        shutil.rmtree(root, ignore_errors=True)
        full = gson.Session(spec, seed=SEED)
        full.run()
        cut = gson.Session(spec, seed=SEED, checkpoint_dir=str(root))
        cut.run(budget=CKPT_ITERS)
        cut.checkpoint()
        del cut
        back = gson.Session.restore(spec, str(root))
        assert back.iteration == CKPT_ITERS and back.state.w.device == \
            full.state.w.device
        back.run()
        assert back.stats.history == full.stats.history, variant
        assert_same_network(back.result()[0], full.result()[0],
                            back.stats.history, full.stats.history,
                            f"{variant} session")

        fs = gson.FleetSpec.broadcast(spec, seeds=range(CKPT_B))
        shutil.rmtree(root, ignore_errors=True)
        fleet = gson.FleetSession(fs)
        fleet.run()
        cut = gson.FleetSession(fs, checkpoint_dir=str(root))
        cut.run(budget=CKPT_ITERS)
        cut.checkpoint()
        del cut
        back = gson.FleetSession.restore(fs, str(root))
        back.run()
        for i in range(CKPT_B):
            assert back.stats[i].history == fleet.stats[i].history
            assert_same_network(back.result(i)[0], fleet.result(i)[0],
                                back.stats[i].history,
                                fleet.stats[i].history,
                                f"{variant} fleet network {i}")
        log(f"checkpoint {variant}: Session and FleetSession (B={CKPT_B}) "
            f"cut at {CKPT_ITERS}, restored, run to {2 * CKPT_ITERS}: rows "
            f"and state fields equal to the uninterrupted runs "
            f"({len(full.stats.history)} and {CKPT_B} x "
            f"{len(fleet.stats[0].history)} rows)")
    shutil.rmtree(root, ignore_errors=True)


def profile_window(run):
    """``torch.profiler`` around ``run()``: (wall s, device busy s, device
    ops, {kernel name: (launches, us)}, profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, n_ops = {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_ops += 1
        cnt, us = kernels.get(e.name, (0, 0))
        kernels[e.name] = (cnt + 1, us + e.time_range.end
                           - e.time_range.start)
    busy = sum(us for _, us in kernels.values()) / 1e6
    return wall, busy, n_ops, kernels, prof


def phase_profile(iters: int = 32, fleet_iters: int = 16):
    """Where the time goes: ``torch.profiler`` over ``iters`` fused
    iterations of one session at the default geometry (busy share, top
    kernels; the full table goes to ``chiprun_out/profile.txt``), then
    over ``fleet_iters`` iterations of a B = FLEET_B fleet (device ops
    and device ms per iteration, busy share, and the port's device
    launches per fleet iteration, which must be those of
    ``DEVICE_KERNELS``, once each per iteration for the whole batch).
    A profiler that records no device time prints "not measured"; only
    a wrong launch count fails the run."""
    from repro_torch import gson
    spec = gson.RunSpec(variant="multi-fused", max_iterations=10_000)
    sess = gson.Session(spec, seed=SEED)
    sess.run(budget=64)                    # warm, pool grown a little
    wall, busy, n_ops, kernels, prof = profile_window(
        lambda: sess.run(budget=iters))
    ours = [n for names in DEVICE_KERNELS.values() for n in names]
    if busy <= 0:
        log("profile: not measured (no device time recorded)")
    else:
        OUT.mkdir(exist_ok=True)
        with open(OUT / "profile.txt", "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
            for name, (_, us) in sorted(kernels.items(),
                                        key=lambda kv: -kv[1][1]):
                f.write(f"{us:12.1f} us  {name}\n")
        log(f"profile B=1 ({iters} fused iterations, units "
            f"{int(sess.state.n_active)}): wall {wall * 1e3:.2f} ms, device "
            f"busy {busy * 1e3:.2f} ms = {100 * busy / wall:.1f}% "
            f"({100 - 100 * busy / wall:.1f}% idle), {n_ops / iters:.0f} "
            f"device ops per iteration, {busy * 1e3 / iters:.3f} ms device "
            f"time per iteration")
        mine = sum(us for n, (_, us) in kernels.items()
                   if any(o in n for o in ours))
        log(f"  the port's kernels: {mine / 1e3:.3f} ms = "
            f"{100 * mine / 1e6 / busy:.1f}% of device time")
        for name, (_, us) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][1])[:8]:
            log(f"  {us / iters:9.1f} us/it  {name[:90]}")

    fleet = gson.FleetSession(gson.FleetSpec.broadcast(
        spec, seeds=range(FLEET_B)))
    fleet.run(budget=64)
    assert fleet.active, "the profiled fleet stopped before its window"
    wall, busy, n_ops, kernels, _ = profile_window(
        lambda: fleet.run(budget=fleet_iters))
    if busy <= 0:
        log(f"profile B={FLEET_B}: not measured (no device time recorded)")
        return
    mine = sum(us for n, (_, us) in kernels.items()
               if any(o in n for o in ours))
    log(f"profile B={FLEET_B} ({fleet_iters} fused fleet iterations, units "
        f"{fleet.cohorts[0].units.tolist()}): wall {wall * 1e3:.2f} ms, "
        f"device busy {busy * 1e3:.2f} ms = {100 * busy / wall:.1f}% "
        f"({100 - 100 * busy / wall:.1f}% idle), {n_ops / fleet_iters:.0f} "
        f"device ops per iteration, {busy * 1e3 / fleet_iters:.3f} ms "
        f"device time per iteration ({busy * 1e3 / fleet_iters / FLEET_B:.3f}"
        f" per network); the port's kernels {100 * mine / 1e6 / busy:.1f}%")
    per_it = {}
    for wrapper, names in DEVICE_KERNELS.items():
        for o in names:
            n = sum(cnt for k, (cnt, _) in kernels.items() if o in k)
            per_it[o] = n / fleet_iters
        assert all(per_it[o] == 1 for o in names), (
            f"{wrapper} at B={FLEET_B}: {[per_it[o] for o in names]} "
            f"launches of {names} per fleet iteration, expected 1 each")
    log(f"  the port's device launches per fleet iteration at "
        f"B={FLEET_B}: {per_it} (one of each for the whole batch)")
    for name, (_, us) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][1])[:6]:
        log(f"  {us / fleet_iters:9.1f} us/it  {name[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    try:
        phase_environment()
        phase_build()
        results = phase_kernels()
        launches = phase_main_path()
        phase_paired_timing()
        phase_fleet_kernels()
        phase_fleet()
        phase_checkpoint()
        phase_profile()
    except Exception:  # noqa: BLE001 — report and fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    sources = {"find_winners": _build.SOURCES["find_winners"]}
    sources.update({k: _build.SOURCES["update_phase"]
                    for k in ("winner_lock", "update_accum", "edge_age")})
    replaces = {
        "find_winners": "src/repro/kernels/find_winners/kernel.py:52",
        "winner_lock": "src/repro/kernels/update_phase/kernel.py:68",
        "update_accum": "src/repro/kernels/update_phase/kernel.py:124",
        "edge_age": "src/repro/kernels/update_phase/kernel.py:272",
    }
    kernels = [{
        "name": name, "route": "cuda",
        "source": str(sources[name].relative_to(ROOT)),
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"], "bound_by": r["by"],
        "library_ms": r["library_ms"],
    } for name, r in results.items()]
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
