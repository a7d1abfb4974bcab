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
   ``fill_``. Then B1's first launch (the packing of the active units)
   bitwise against its plain version, its two scan regimes bitwise
   equal, and B1 held, timed and bounded at m = 1 (the ``single``
   path) and on a dense pool (``DENSE_ACTIVE`` of ``DENSE_C`` units
   active, ``DENSE_M`` signals). Last (``refresh``), the SOAM refresh's
   ladder kernel at both benchmark cells' shapes (``REFRESH_CELLS``:
   B = 64 at C = 4096, B = 32 at the paper's C = 32768; K = 16) on fleets
   grown by the card for ``REFRESH_ITERS`` iterations, bitwise its plain
   version (also with every unit habituated): device ms of both, the
   bound, device launches per call and the device memory one call
   allocates. The main path, the fleet and the paper's configuration each
   check that the kernel launches once per SOAM refresh (the program's
   ``gson.refresh`` spans).
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
8. slab kernels — B2 and the fused B3 + B4 as the winner-neighborhood
   slab (``update_phase_sparse``) hands them their inputs, at the autotune
   cells (256, 4096, 512) and (384, 8192, 768) on a grown pool, against
   their plain versions with phase 3's tolerances; the slab's whole result
   equals ``update_phase_op``'s bitwise; each kernel's time at slab
   capacity beside its time on the whole pool at the same m, device
   launches per call, and both phases end to end (host clock).
9. ``cuda-sparse`` — ``RunSpec(backend="cuda-sparse",
   variant_config=MultiConfig(fixed_m=512))`` for ``SPARSE_ITERS``
   iterations against the same spec on ``cuda-update``: rows and state
   equal, the slab taken on more than half of the iterations; branch
   counts, launches and it/s of both.
10. ``cuda-auto`` — at every cell of the committed selection table
   (``src/repro_torch/gson/autotune_table.json``) the autotuned Update
   phase dispatches to the cell's best (the kernel counters move exactly
   when that is ``cuda`` or ``sparse``); two cells timed again live beside
   their committed figures.
11. ``single`` — the paper's sequential baseline,
   ``RunSpec(variant="single", backend="cuda-full")``, for
   ``SINGLE_CHUNKS`` chunks of 256 signals: B1 launches exactly once per
   signal, and the rows equal the ``reference`` backend's (a row that
   differs is traced to the first signal whose winners differ, which must
   be a near-tie: distances within 1e-4). Signals/s beside ``multi``'s.
12. ann — ``ann-windowed`` and ``ann-grid`` Sessions (``multi`` and
   ``multi-fused``, ``ANN_ITERS`` iterations) and variant ``indexed``
   (``INDEXED_CHUNKS`` chunks of 256 signals) at the default geometry,
   each beside the ``reference`` backend (``single`` for ``indexed``) on
   the same seed: it/s or signals/s, ``topology_quality``, the grid
   guard's fires, and each ANN backend's history rows equal to the
   ``reference`` run's through ``HORIZON`` (asserted: both searches are
   exact); the ANN backends run the reference Update phase, so the
   kernels' counters read 0 on this path. Then the JAX package's ANN
   acceptance gate on the card: the gate configuration of phase 4 for
   both ANN backends, as many iterations as the ``cuda-full`` run, chi
   equal to its chi and QE within 5% of it (asserted).
13. paper — ``configs/soam_paper.paper_spec()`` (capacity 32768, m up
   to 8192) on ``cuda-full`` for ``PAPER_ITERS`` iterations, every
   kernel launched on it, then each kernel held against its plain
   version on that grown pool with phase 3's tolerances (B2 over four
   8192-unit tiles), with its ms and bound at this shape; ``ann-grid``
   (45^3 cells) at the same capacity beside it.
14. serve — a ``ReconstructionServer`` (``SERVE_SLOTS`` slots, slices of
   ``SERVE_SLICE`` iterations, checkpoints under ``build/``) on
   ``cuda-full`` serves four ``multi-fused`` and two ``multi`` jobs at the
   default geometry, the paper's configuration (its own cohort in a
   mixed-shape wave) and a ``single`` job on the solo path, under the
   injected faults of ``SERVE_FAULTS`` (a poisoned job, a crash
   mid-checkpoint, device loss), every launch counter set to 0 before and
   read after: every job ends ``done``, the poisoned job after one retry
   from its pre-poison checkpoint, device loss costs no retry, and every
   fault record and warning is an injected one (no ``advance_error``,
   ``stall`` or ``admission_error``); each job equals its dedicated
   ``Session`` (fleet jobs: state bitwise, rows equal, ``qe`` within
   1e-6; the single job: rows and state); B1 and B2 / B3 + B4 on the calls
   recorded inside the server (one per shape) equal their plain versions
   with phase 3's tolerances. Ticks, wall, jobs/s, network-it/s beside
   phase 6's fleet, checkpoint ms per tick, beside the card's line.
15. mesh — device meshes (``MeshSpec`` on ``torch.distributed``, one
   process per rank, ``run_world``): a world of one NCCL rank on
   ``cuda`` runs a ``Session`` on a signal mesh and a B = ``MESH_B``
   fleet on a network mesh, each equal to its unsharded run (state
   bitwise, rows equal); then two gloo ranks that both name ``cuda:0``
   run the signal-sharded step at m = ``MESH_M`` and the
   network-partitioned Find Winners (each bitwise the unsharded one on
   both ranks), a B = ``MESH_B`` network-sharded fleet (equal to its
   sessions), ``ElasticFleetRunner`` losing pod 1 (equal to the run with
   no fault; rank 1 leaves) and a served wave whose ``device_loss``
   shrinks the mesh to one rank (every job done, no retry, the stats of
   the server with no mesh); B1 on the mesh shapes against its plain
   version. Each rank's launch counters are set to 0 before its mesh
   runs and read after: B1, B2 and B3 + B4 launch on every rank. Two
   ranks on one card measure correctness and host overhead, not scaling.
16. c2 — the ``cuda`` tests of the paths that had not run on the card
   (``GSONEngine.run``, ``autotune()``'s cache, ``cuda-auto`` in a
   ``Session``, a ``cuda-sparse`` fleet at B = 4), the windowed
   search's refusal of TF32, the grid search's own answer on a dense
   pool (the guard passes, the ids are the exhaustive search's), a
   served poisoned job on the card and the LM smoke config's
   ``ServeEngine`` on the card against the CPU; and (``c4_``) paths that
   no record had shown on the card: the ``indexed`` backend inside
   ``multi``/``multi-fused``, ANN backends in a B = 4 fleet, the engine
   shim's ``indexed`` variant, ``PointCloudStream``/``NoisySampler``, an
   ANN backend at recall 0.8, the vlm family, sampling at temperature >
   0, ``python -m repro_torch.launch.serve``, and the three examples
   (``torch_serve_lm``, ``torch_quickstart``,
   ``torch_surface_reconstruction``), each against the CPU or the port's
   own reference path; a smoke train step on the card against the CPU
   (``lm_train``); the SSM, hybrid and enc-dec smoke configs on the
   card against the CPU (``families_on_card``); and (``lm_mesh``)
   ``flash_decode``, the MoE's expert parallelism and the mesh decode on a
   one-rank NCCL mesh against the unmeshed results on the card; run by
   pytest in a child process.
17. lm — the LM substrate, which launches none of the GSON kernels (every
   counter set to 0 before and 0 after): ``LM_ARCH`` (qwen1.5-0.5b) at its
   published width from random weights, a ``ServeEngine`` of
   ``LM_BATCH`` slots serving ``LM_REQUESTS`` requests drawn as
   ``repro_torch.launch.serve`` draws them, ``LM_MAX_TOKENS`` tokens each
   (2 prefill waves, 62 decode steps, asserted): tokens/s, prefill ms per
   wave and decode ms per step (CUDA events), device time, device ops and
   busy share over ``LM_PROFILE_STEPS`` decode steps (``torch.profiler``),
   peak device memory, and the decode step's bound (bf16 weights without
   the embedding rows, plus the cache, over HBM's rate). Then prefill +
   decode against the teacher-forced forward at f32 compute (rtol = atol
   = ``LM_F32_TOL``) and at bf16 (within twice the bf16 forward's
   distance from the f32 forward); the card against the CPU from the same
   f32 weights (rtol = atol = ``LM_CARD_CPU_TOL``, greedy tokens equal
   wherever the CPU's top-2 margin exceeds it); ``LM_GQA_ARCH``
   (granite-3-2b, GQA 32/8) through the same two checks and one wave;
   ``LM_MOE_ARCH`` (qwen2-moe-a2.7b) at full width with bf16 parameters
   served on the same requests (tokens/s, decode ms per step, peak
   memory, the bytes bound of the dense reference path beside a routed
   design's), prefill + decode against the forward at f32 on a 2-layer
   full-width model, and one smoke-size MoE train step on the card
   against the CPU. Its memory is freed before the next phase.
18. families — the SSM, hybrid and enc-dec families (``FAM_ARCHS``:
   mamba2-2.7b, zamba2-2.7b, whisper-medium), one model at a time with
   its memory freed in between, every counter set to 0 before and 0
   after: each at its published width (random weights from ``SEED``, f32
   master, bf16 compute) serving the lm phase's requests (whisper on the
   engine's zero frames; 2 waves, 62 decode steps, asserted): tokens/s,
   prefill ms per wave and decode ms per step (CUDA events), the device's
   busy share over ``LM_PROFILE_STEPS`` decode steps, peak memory and
   the decode step's bytes bound (the bf16 weights it reads, the hybrid's
   shared block once per invocation, plus the cache, each SSM state and
   conv tail read and written, over HBM's rate). Then prefill + decode
   against the forward at f32 on the full-width model cut to
   ``FAM_DEPTH`` (mamba2 2 layers, zamba2 6, whisper 2 + 2), over
   ``FAM_PROMPT_LEN`` = 1024 tokens (four SSD chunks of 256) or, for
   whisper, over its 1500 frames (rtol = atol = ``LM_F32_TOL``); and the
   card against the CPU from the same f32 weights (rtol = atol =
   ``LM_CARD_CPU_TOL``).
19. train — ``TRAIN_ARCH`` (qwen1.5-0.5b) trained at full width with its
   depth cut to ``TRAIN_LAYERS`` (f32 master, bf16 compute, remat full)
   on ``train_4k``'s 4096-token
   sequences, the global batch cut to ``TRAIN_BATCH``, through
   ``launch.steps.build_train_step`` with the cell's deployment (one
   sequence per microbatch, AdamW), ``TRAIN_STEPS`` steps: ms per step
   (CUDA events), tokens/s, peak memory, the step's FLOP bound and its
   share; loss and gnorm finite, every parameter changed; a checkpoint
   after ``TRAIN_SAVE_AT`` steps restored into a fresh tree replays the
   rest (bitwise or within 2 lr per step, as printed); the card against
   the CPU on a 2-layer full-width model (loss within 1e-5, gradients
   within 1e-4 of each parameter's largest). Every counter reads 0.
20. lm_mesh — the LM on a mesh (``launch/mesh.py``, ``models/placement.py``;
   every counter of every rank set to 0 before and 0 after): (a) one
   NCCL rank on ``make_mesh_for_env``'s (data 1, model 1) mesh serves
   ``LM_ARCH`` at full width in bf16 (its decode deployment) through
   ``ServeEngine(mesh=)`` on the lm phase's requests, every token equal
   to the lm phase's; a full-width train step on ``TRAIN_BATCH`` x 4096
   tokens through ``build_train_step(mesh)``, its loss within
   ``LMM_LOSS_TOL`` of the train phase's first step; (b) four gloo ranks
   that all name one card (NCCL cannot put two ranks on one card): the
   f32 prefill + ``LMM_DECODE`` decode steps of ``LM_ARCH`` cut to
   ``TRAIN_LAYERS`` at B = ``LMM_B`` on (data 2,
   model 2), the cache seq-sharded over model, within ``LMM_LOGIT_TOL``
   of (a)'s and the greedy tokens equal; a train step on ``TRAIN_BATCH`` x
   ``LMM_TRAIN_SEQ`` tokens (sequences cut from 4096), its loss within
   ``LMM_LOSS_TOL`` of (a)'s; the pod-manual step (int8 error feedback,
   straggler masking, health ``LMM_HEALTH``) on (pod 2, model 2),
   parameters finite and bitwise
   alike on every rank, ef = g - deq on every rank; ``LM_MOE_ARCH`` at
   full width cut to ``LMM_MOE_LAYERS`` layers, its layer 0 through
   expert parallelism (32 of 64 experts per rank) against the dense
   reference at capacity 8 (``LMM_MOE_TOL``, aux ``LMM_AUX_TOL``), and
   the drops at the config's capacity. Each part's wall and peak memory
   per rank. Four ranks on one card check correctness and host overhead,
   not scaling. Then its ``families_mesh`` part (ROADMAP A15f-2, A15g;
   the counters of every rank set to 0 before it and 0 after): (a) on the
   NCCL rank each of ``FAM_ARCHS`` at full width served in bf16 through
   ``ServeEngine(mesh=)`` on the families phase's requests, every token
   equal to that phase's (tokens/s, decode ms per step, peak memory), and
   the unmeshed references of (b); (b) on the four gloo ranks each family
   at full width cut to ``FAM_MESH_DEPTH`` (mamba2 2 layers, zamba2 6,
   whisper 2 + 2): the f32 prefill + ``LMM_DECODE`` decode steps on (data
   2, model 2) within ``LMM_LOGIT_TOL`` of the same weights without a
   mesh, greedy tokens equal, and a train step on ``TRAIN_BATCH`` x
   ``FAM_MESH_SEQ`` tokens under the cell's deployment, its loss within
   ``LMM_LOSS_TOL`` of the unmeshed step's; (c) ``launch.dryrun``'s
   per-rank residency, step FLOPs and roofline terms of the train phase's
   cell and the lm phase's decode cell beside their measured peaks.
21. profile — where the main path's time goes (``torch.profiler``):
   device busy share and top kernels at B = 1, then device ops and
   device time per iteration and the busy share of the fleet at B = 8,
   whose window must show one launch of each of the port's device
   kernels per fleet iteration (a profiler that records nothing prints
   "not measured" instead).
22. report — the ``kernels`` JSON line (each kernel's launches on the main
   path, under ``paths`` on every path driven with the counters set to 0
   before and read after (``lm``, ``families``, ``train``, ``lm_mesh``
   and ``families_mesh`` among them, all 0), under ``paper`` the capacity that phase
   13 ran and its launches, ms and bound there, and for B1 under
   ``shapes`` phase 3's m = 1 and dense-pool figures), the card's line,
   and last ``{"ok": true, "device": {...}}``.

It needs ``src/repro_torch`` beside it and a CUDA device; without
either it exits nonzero before printing any result. Long output goes to
``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
import functools
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
PAIRS, PAIR_ITERS = 2, 128   # cuda-full vs reference timing pairs
FLEET_B, FLEET_ITERS = 8, 128     # the fleet phase
# the checkpoint phase cuts at CKPT_ITERS, a multiple of the fused
# superstep (64), so multi-fused emits the rows of an uninterrupted run
CKPT_B, CKPT_ITERS = 4, 64
SLAB_CELLS = ((256, 4096, 512), (384, 8192, 768))   # (units, capacity, m)
SPARSE_ITERS = 128     # the cuda-sparse session (fixed_m = 512)
SINGLE_CHUNKS = 2      # chunks of 256 signals of the single session
ANN_ITERS = 64         # each ANN session at the default RunSpec
INDEXED_CHUNKS = 1     # chunks of 256 signals of the indexed session
PAPER_ITERS = 512      # the paper's configuration (capacity 32768)
# the serve phase: slots, slice (one fused superstep), fleet-job and
# paper-job iterations, the single job's chunks of SERVE_CHUNK signals
SERVE_SLOTS, SERVE_SLICE = 4, 64
SERVE_ITERS, SERVE_PAPER_ITERS = 256, 128
SERVE_CHUNK, SERVE_CHUNKS = 16, 4
# tick -> the faults the serve phase injects; the retry of the poisoned
# job waits out a backoff of 2 ticks, so the device loss finds it queued
SERVE_FAULTS = {2: {"kind": "poison", "job": 1, "poison": "nan"},
                3: {"kind": "crash_checkpoint"},
                5: {"kind": "device_loss"}}
SERVE_BACKOFF = 2
# the mesh phase: iterations of each run (one fused superstep), the fleet,
# the signal-sharded step's buffer; the elastic fleet and the served jobs
# (iterations, ticks of ELASTIC_TICK) and their faults
MESH_ITERS, MESH_B, MESH_M = 64, 8, 8192
ELASTIC_B, ELASTIC_ITERS, ELASTIC_TICK = 4, 48, 16
ELASTIC_LOST = {1: ["pod1_down"]}
MESH_SERVE_JOBS = 4
MESH_SERVE_FAULTS = {1: {"kind": "device_loss", "survivors": 1}}
STATE_FIELDS = ("w", "active", "nbr", "age", "error", "firing",
                "threshold", "topo_state", "inconsistent_for", "n_active",
                "signal_count", "discarded")
GATE = dict(capacity=768, iterations=1500, jax_chi=2, jax_units=94,
            jax_qe=0.02538)
# B1 on a dense pool: a converged network at the paper's capacity
DENSE_C, DENSE_ACTIVE, DENSE_M = 32768, 16384, 8192
# the refresh phase: the benchmark cells' fleets, grown this many iterations
REFRESH_CELLS = (("sphere4k.fleet64", 64), ("paper.fleet32", 32))
REFRESH_ITERS = 64

# The device kernels that one call of each wrapper launches, by their
# names in the CUDA sources; the profile phase sums the port's kernels
# over these names.
DEVICE_KERNELS = {
    "find_winners": ("fw_compact_kernel", "fw_scan_kernel"),
    "winner_lock": ("lock_tile_kernel",),
    "update_accum": ("owner_scatter_kernel", "accum_group_kernel"),
    "topo_states": ("topo_ladder_kernel", "topo_patch_kernel"),
}
# Launched once per SOAM refresh, not once per iteration.
PER_REFRESH = ("topo_states",)
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


@functools.lru_cache(maxsize=None)
def grown_pool(seed: int):
    """A pool at the default geometry grown by a short plain run."""
    from repro_torch import gson
    spec = gson.RunSpec(variant="multi-fused", backend="reference",
                        max_iterations=128)
    sess = gson.Session(spec, seed=seed)
    sess.run()
    return sess.state, sess.cohorts[0].params


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes;
    B1 also at m = 1 and on a dense pool."""
    state, params = grown_pool(SEED)
    results = hold_kernels(state, params, "kernels")
    results["find_winners"]["shapes"] = hold_find_winners_shapes(state)
    return results


def phase_refresh() -> dict:
    """The ladder kernel at both benchmark cells' shapes on fleets grown by
    the card: bitwise its plain version with the cell's firing counters
    and with every unit habituated; device ms of the kernel and of the
    plain version, the bound (the table, the counters, the flags and the
    states, each byte once), device launches per call and the device
    memory a call allocates beyond what was allocated before it."""
    import torch
    from repro_torch import gson
    from repro_torch.configs import soam_paper
    from repro_torch.core.gson.topology import (compute_topo_states,
                                                compute_topo_states_plain)
    specs = {"sphere4k.fleet64": gson.RunSpec(),
             "paper.fleet32": soam_paper.paper_spec()}
    out = {}
    for cell, B in REFRESH_CELLS:
        spec = specs[cell].replace(max_iterations=REFRESH_ITERS)
        fleet = gson.FleetSession(gson.FleetSpec.broadcast(
            spec, seeds=range(B)))
        fleet.run()
        nets = fleet.cohorts[0].fstate.nets
        _, C, K = nets.nbr.shape
        thr = fleet.cohorts[0].params.firing_threshold
        args = (nets.nbr, nets.active, nets.firing, thr)
        for firing in (nets.firing, torch.zeros_like(nets.firing)):
            a = (nets.nbr, nets.active, firing, thr)
            assert torch.equal(compute_topo_states(*a),
                               compute_topo_states_plain(*a)), cell
        extra = {}
        for name, fn in (("kernel", compute_topo_states),
                         ("plain", compute_topo_states_plain)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(*args)
            torch.cuda.synchronize()
            extra[name] = torch.cuda.max_memory_allocated() - base
        ms = device_ms(lambda: compute_topo_states(*args), 50)
        plain_ms = device_ms(lambda: compute_topo_states_plain(*args), 5)
        bound, by = bound_ms(B * C * (4 * K + 4 + 1 + 4), 0)
        launched = device_launches(lambda: compute_topo_states(*args))
        if launched:
            want = DEVICE_KERNELS["topo_states"]
            assert len(launched) == len(want) and all(
                any(k in n for k in want) for n in launched), (
                f"topo_states launched {launched}, expected {want}")
            per_call = f"{len(launched)} device launches per call"
        else:
            per_call = "device launches per call not measured"
        with_edges = int((nets.nbr >= 0).any(dim=-1).sum())
        units = int(nets.active.sum())
        out[cell] = dict(B=B, C=C, K=K, units=units,
                         rows_with_edges=with_edges, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         alloc_bytes=extra["kernel"],
                         plain_alloc_bytes=extra["plain"])
        log(f"refresh {cell} (B={B}, C={C}, K={K}, {units} units, "
            f"{with_edges} rows with edges, {REFRESH_ITERS} it): kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.5f} ms "
            f"({by}, {100 * bound / ms:.1f}% of it)  {per_call}; allocates "
            f"{extra['kernel'] / 2**20:.2f} MiB (plain "
            f"{extra['plain'] / 2**30:.2f} GiB); bitwise the plain version")
    return out


def hold_find_winners_shapes(state) -> dict:
    """B1's first launch (the packing of the active units) against its
    plain version bitwise, its two scan regimes against each other, and
    B1 at two more shapes against its plain version with phase 3's
    tolerances: m = 1 on ``state``'s pool (the ``single`` path) and M =
    DENSE_M signals on a pool of DENSE_C sphere points with DENSE_ACTIVE
    active (a converged pool at the paper's capacity). Times and bounds
    of each."""
    import torch
    from repro_torch.core.gson.sampling import make_sampler
    from repro_torch.kernels.find_winners import kernel as fwk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    sphere = make_sampler("sphere")
    sig = sphere(g, DENSE_M)[None].contiguous()
    dense_act = torch.zeros((1, DENSE_C), dtype=torch.bool, device=dev)
    dense_act[0, torch.randperm(DENSE_C, generator=g, device=dev)
              [:DENSE_ACTIVE]] = True
    pools = {"m1": (sig[:, :1].contiguous(), state.w[None].contiguous(),
                    state.active[None].contiguous()),
             "dense": (sig, sphere(g, DENSE_C)[None].contiguous(),
                       dense_act)}
    out = {}
    for name, args in pools.items():
        x, w, act = args
        M, D = x.shape[1:]
        C = w.shape[1]
        packed, ids, count = fwk.compact_active(w, act)
        pp, ip, cp = fwk.compact_active_plain(w, act)
        n = int(cp[0])
        assert torch.equal(count, cp) and torch.equal(ids[0, :n], ip[0, :n]) \
            and torch.equal(packed[0, :n], pp[0, :n]), \
            f"find_winners packing differs ({name})"
        d2k, idk = fwk.find_winners_top2(*args)
        d2k2, idk2 = fwk.find_winners_top2(*args)
        d2p, idp = fwk.find_winners_top2_plain(*args)
        assert torch.equal(d2k, d2k2) and torch.equal(idk, idk2), \
            f"find_winners not repeatable ({name})"
        ok = near_tie_free(x[0], w[0], act[0])
        assert torch.equal(idk[0][ok], idp[0][ok]), \
            f"find_winners ids differ ({name})"
        torch.testing.assert_close(d2k, d2p, rtol=2e-4, atol=1e-5)
        scan = fwk.regime(1, M)
        other = [r for r in fwk.REGIMES if r != scan][0]
        d2o, ido = fwk.find_winners_top2(*args, scan=other)
        assert torch.equal(d2o, d2k) and torch.equal(ido, idk), \
            f"find_winners regimes differ ({name})"
        nbytes = (M * D + n * D) * 4 + C + M * 2 * 8
        b, by = bound_ms(nbytes, M * n * (2 * D + 2))
        r = dict(M=M, C=C, n_active=n, regime=scan,
                 ms=device_ms(lambda a=args: fwk.find_winners_top2(*a), 50),
                 other_regime_ms=device_ms(
                     lambda a=args, o=other: fwk.find_winners_top2(*a, scan=o),
                     50),
                 plain_ms=device_ms(
                     lambda a=args: fwk.find_winners_top2_plain(*a), 10),
                 bound_ms=b, bound_by=by,
                 max_abs_err=float((d2k - d2p).abs().max()))
        out[name] = r
        log(f"  find_winners {name} (M={M}, {n} active of C={C}): kernel "
            f"{r['ms']:.4f} ms ({scan}; {other} {r['other_regime_ms']:.4f}) "
            f" plain {r['plain_ms']:.4f} ms  bound {b:.5f} ms ({by})  "
            f"max|err| {r['max_abs_err']:.3g}  ids equal on "
            f"{int(ok.sum())}/{M} tie-free rows; packing bitwise, both "
            f"regimes bitwise equal")
    return out


def hold_kernels(state, params, tag: str):
    """Each kernel against its plain version on ``state``'s pool with a
    buffer of ``params.max_parallel`` signals (full, masked to the
    m-schedule's m_t and to 64); times, bounds and device launches."""
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
    C, K, D = state.capacity, state.max_deg, state.dim
    M = params.max_parallel
    log(f"{tag}: pool of {int(state.n_active)} active units, C={C} "
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
    from repro_torch.kernels.topo_states import kernel as tsk
    from repro_torch.kernels.update_phase import kernel as upk
    wrappers = {"find_winners": fwk.find_winners_top2,
                "winner_lock": upk.winner_lock_min,
                "update_accum": upk.update_accum,
                "topo_states": tsk.topo_states}
    return {**wrappers, **{k: wrappers[v] for k, v in SHARED.items()}}


def zero_counters():
    for f in counters().values():
        f.launches = 0


def read_counters(path: str, must: tuple) -> dict:
    """The launch counters after a path; each kernel in ``must`` has to
    have launched."""
    got = {name: f.launches for name, f in counters().items()}
    for name in must:
        assert got[name] > 0, f"kernel {name} was not launched on the {path}"
    return got


@contextlib.contextmanager
def every_refresh_launches(path: str):
    """Tracing on inside the block: the ``gson.refresh`` spans it logs (one
    per SOAM refresh) must equal the ladder kernel's launches in it."""
    from repro_torch.kernels.topo_states import topo_states
    from repro_torch.utils import timing
    before = topo_states.launches
    with timing.tracing(True):
        timing.clear()
        yield
        refreshes = sum(s[0] == "gson.refresh" for s in timing.spans())
        timing.clear()
    got = topo_states.launches - before
    assert got == refreshes > 0, (
        f"{path}: {got} launches of the ladder kernel for {refreshes} "
        f"refreshes")
    log(f"  {path}: {refreshes} SOAM refreshes, {got} launches of the "
        f"ladder kernel")


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


def same_rows(stats, ref_stats) -> str:
    """Assert that the history rows through ``HORIZON`` equal the other
    run's (iteration, units and signals; QE within 1e-4): beyond it the
    float atomics of the Update phase may part two trajectories at a near
    tie. Returns how many rows of the whole run are equal."""
    rows = [r for r in stats.history if r["iteration"] <= HORIZON]
    rrows = [r for r in ref_stats.history if r["iteration"] <= HORIZON]
    assert rows and len(rows) == len(rrows)
    for a, b in zip(rows, rrows):
        assert (a["iteration"], a["units"], a["signals"]) == (
            b["iteration"], b["units"], b["signals"]), (a, b)
        assert math.isclose(a["qe"], b["qe"], rel_tol=1e-4), (a, b)
    same = sum((a["units"], a["signals"]) == (b["units"], b["signals"])
               for a, b in zip(stats.history, ref_stats.history))
    return f"{same}/{len(stats.history)} (asserted through it {HORIZON})"


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
    with every_refresh_launches("main path"):
        for variant in ("multi", "multi-fused"):
            spec = gson.RunSpec(variant=variant)
            runs[variant] = run_session(spec, SEED, MAIN_ITERS)
    launches = {name: f.launches for name, f in cnt.items()}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    multi_rate = runs["multi"][2].signals / runs["multi"][3]
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
        log(f"  history rows equal to the reference backend's: "
            f"{same_rows(stats, ref[2])}")

    # the JAX package's acceptance-gate configuration
    sess, st, stats, wall, chi = run_session(gate_spec("cuda-full"), 42,
                                             None)
    check_state(st)
    GATE_RUNS["cuda-full"] = (st, stats, wall)
    log(f"gate config (capacity 768, 1500 it): chi {chi}, units "
        f"{stats.units}, QE {stats.quantization_error:.5f}, "
        f"{stats.iterations} it in {wall:.2f} s "
        f"(JAX reference on CPU: chi {GATE['jax_chi']}, units "
        f"{GATE['jax_units']}, QE {GATE['jax_qe']}; other draws, so not "
        f"asserted)")
    return launches, multi_rate


GATE_RUNS: dict = {}   # backend -> (state, stats, wall) of the gate config


def gate_spec(backend: str):
    """The JAX package's acceptance-gate configuration
    (``tests/test_ann.py:548-563``): SOAM on the sphere, capacity 768,
    fused supersteps of 64, refresh every 2, 1500 iterations."""
    from repro_torch import gson
    p = gson.GSONParams(model="soam", insertion_threshold=0.35,
                        age_max=64.0, eps_b=0.1, eps_n=0.01,
                        stuck_window=60)
    return gson.RunSpec(
        variant="multi-fused", model=p, sampler="sphere", backend=backend,
        variant_config=gson.FusedConfig(
            superstep=gson.SuperstepConfig(length=64), refresh_every=2),
        capacity=GATE["capacity"], max_deg=16, check_every=25,
        max_iterations=GATE["iterations"])


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
        with every_refresh_launches(f"fleet {variant}"):
            t0 = time.perf_counter()
            fleet.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {n: f.launches for n, f in wrappers.items()}
        assert list(fleet.iterations) == [FLEET_ITERS] * FLEET_B, \
            fleet.iterations
        assert all(n == FLEET_ITERS for k, n in launches.items()
                   if k not in PER_REFRESH), (
            f"{variant}: {launches} launches in {FLEET_ITERS} fleet "
            "iterations, expected one per iteration (the ladder kernel's: "
            "one per refresh)")
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
            f"{launches} (one per fleet iteration, the ladder kernel one per "
            f"refresh); {FLEET_B}/{FLEET_B} "
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


@contextlib.contextmanager
def recorded(module, *names):
    """``module.<name>`` replaced, for the block, by a function that
    records its arguments and calls the original; one call is kept per
    shapes of the tensor arguments (a server makes thousands)."""
    calls = {n: [] for n in names}
    seen = set()
    orig = {n: getattr(module, n) for n in names}

    def recorder(n):
        def call(*a):
            key = (n, *(tuple(x.shape) for x in a if hasattr(x, "shape")))
            if key not in seen:
                seen.add(key)
                calls[n].append(a)
            return orig[n](*a)
        return call
    for n in names:
        setattr(module, n, recorder(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(module, n, orig[n])


def padded_pool(state, capacity: int):
    """``state`` in a pool of ``capacity`` rows: the extra rows free."""
    import torch
    from repro_torch.core.gson.state import NetworkState
    C = state.capacity
    fill = {"w": 0.0, "active": False, "nbr": -1, "age": 0.0, "error": 0.0,
            "firing": 1.0, "topo_state": 0, "inconsistent_for": 0,
            "threshold": float(state.threshold[0])}
    out = {}
    for name in STATE_FIELDS + ("dropped_edges", "dropped_units"):
        a = getattr(state, name)
        if name in fill:
            a = torch.cat([a, a.new_full((capacity - C, *a.shape[1:]),
                                         fill[name])])
        out[name] = a
    return NetworkState(**out)


ACCUM_OUT = ("w1", "nsc", "nsx", "err", "decb_u", "decn_u", "wind", "age")
ACCUM_EXACT = ("w1", "err", "decb_u", "wind", "age")


def check_update_kernels(calls, ctx: str) -> float:
    """Every recorded call of B2 and of the fused B3 + B4 against its
    plain version on the same arguments, with phase 3's tolerances (the
    lock, the winner fields and the aged table bitwise; the sums within
    rtol=1e-6, atol=1e-7). Returns the largest error of the sums."""
    import torch
    from repro_torch.kernels.update_phase import kernel as upk
    assert calls["winner_lock_min"] and calls["update_accum"], \
        f"{ctx}: the Update-phase kernels were not called"
    for largs in calls["winner_lock_min"]:
        assert torch.equal(upk.winner_lock_min(*largs),
                           upk.winner_lock_min_plain(*largs)), \
            f"{ctx}: winner_lock differs"
    err = 0.0
    for aargs in calls["update_accum"]:
        for name, k, p in zip(ACCUM_OUT, upk.update_accum(*aargs),
                              upk.update_accum_plain(*aargs)):
            if name in ACCUM_EXACT:
                assert torch.equal(k, p), f"{ctx}: update_accum {name} differs"
            torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-7)
            err = max(err, float((k - p).abs().max()))
    return err


def phase_slab_kernels():
    """B2 and B3 + B4 on the gathered slab against their plain versions,
    at slab capacity beside the whole pool at the same m."""
    import torch
    from repro_torch.core.gson.multi import find_winners_reference
    from repro_torch.core.gson.sampling import make_sampler
    from repro_torch.gson.autotune import wall_timer
    from repro_torch.kernels.update_phase import kernel as upk
    from repro_torch.kernels.update_phase import ops
    from repro_torch.kernels.update_phase import sparse

    dev = torch.device("cuda")
    pool, params = grown_pool(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    host = wall_timer(n=20, warmup=3)
    out = {}
    for units, C, m in SLAB_CELLS:
        state = pool if C == pool.capacity else padded_pool(pool, C)
        sig = make_sampler("sphere")(g, m)
        wid, sid, d2b, _ = find_winners_reference(sig, state.w, state.active)
        prio = torch.randperm(m, generator=g, device=dev, dtype=torch.int32)
        args = (state, sig, wid, sid, d2b, prio, params)
        slab0 = sparse.update_phase_sparse.slab_calls
        with recorded(sparse, "winner_lock_min", "update_accum") as at_slab:
            got = sparse.update_phase_sparse(*args)
        assert sparse.update_phase_sparse.slab_calls == slab0 + 1, \
            f"({units}, {C}, {m}): the slab was not taken"
        with recorded(ops, "winner_lock_min", "update_accum") as at_pool:
            want = ops.update_phase_op(*args)
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a, b), \
                f"({units}, {C}, {m}): slab {name} differs from update_phase_op"
        largs = at_slab["winner_lock_min"][0]
        aargs = at_slab["update_accum"][0]
        Gs = largs[2]
        err = check_update_kernels(at_slab, f"slab ({units}, {C}, {m})")
        log(f"slab ({units}, {C}, {m}): {int(state.n_active)} active units, "
            f"slab of {Gs} rows of {C}; B2 bitwise, B3 + B4 winner fields "
            f"and aged table bitwise, sums within {err:.3g}; the slab's "
            f"result equals update_phase_op's bitwise")
        row = {}
        for name, slab_a, pool_a in (
                ("winner_lock", largs, at_pool["winner_lock_min"][0]),
                ("update_accum", aargs, at_pool["update_accum"][0])):
            fn = getattr(upk, "winner_lock_min" if name == "winner_lock"
                         else "update_accum")
            ms_s = device_ms(lambda f=fn, a=slab_a: f(*a), 50)
            ms_p = device_ms(lambda f=fn, a=pool_a: f(*a), 50)
            launched = device_launches(lambda f=fn, a=slab_a: f(*a))
            per = (f"{len(launched)} device launch(es) per call" if launched
                   else "device launches per call not measured")
            row[name] = (ms_s, ms_p)
            log(f"  {name:13s} at slab capacity {Gs}: {ms_s:.4f} ms, on the "
                f"whole pool {C}: {ms_p:.4f} ms; {per}")
        t_s = host("sparse", lambda: sparse.update_phase_sparse(*args))
        t_p = host("cuda", lambda: ops.update_phase_op(*args))
        n_s = len(device_launches(lambda: sparse.update_phase_sparse(*args)))
        n_p = len(device_launches(lambda: ops.update_phase_op(*args)))
        log(f"  the whole Update phase (host clock, synchronised): slab "
            f"{t_s * 1e3:.4f} ms, dense {t_p * 1e3:.4f} ms; device ops per "
            f"call: slab {n_s or 'not measured'}, dense "
            f"{n_p or 'not measured'}")
        out[(units, C, m)] = row
    return out


def phase_sparse_session():
    """``cuda-sparse`` at fixed_m = 512 against ``cuda-update``."""
    from repro_torch import gson
    from repro_torch.kernels.update_phase.sparse import update_phase_sparse
    base = gson.RunSpec(backend="cuda-update", max_iterations=SPARSE_ITERS,
                        variant_config=gson.MultiConfig(fixed_m=512))
    runs = {}
    for be in ("cuda-update", "cuda-sparse"):
        zero_counters()
        for k in ("slab_calls", "dense_calls", "pool_calls"):
            setattr(update_phase_sparse, k, 0)
        runs[be] = run_session(base.replace(backend=be), SEED, None)
        launches = read_counters(f"{be} path", ("winner_lock", "update_accum"))
    branches = {k: getattr(update_phase_sparse, k)
                for k in ("slab_calls", "dense_calls", "pool_calls")}
    (s_sess, s_st, s_stats, s_wall, _), (d_sess, d_st, d_stats, d_wall, _) = (
        runs["cuda-sparse"], runs["cuda-update"])
    assert s_stats.iterations == d_stats.iterations == SPARSE_ITERS
    assert_same_network(s_st, d_st, s_stats.history, d_stats.history,
                        "cuda-sparse vs cuda-update")
    assert branches["slab_calls"] > SPARSE_ITERS // 2, branches
    assert sum(branches.values()) == SPARSE_ITERS, branches
    r_s, r_d = SPARSE_ITERS / s_wall, SPARSE_ITERS / d_wall
    log(f"cuda-sparse (fixed_m=512, capacity 4096, {SPARSE_ITERS} it, units "
        f"{s_stats.units}): branches {branches}, launches "
        f"{ {k: launches[k] for k in ('winner_lock', 'update_accum')} }; rows "
        f"and state equal to cuda-update's ({len(s_stats.history)} rows); "
        f"{r_s:.1f} it/s vs cuda-update {r_d:.1f} it/s (x{r_s / r_d:.2f})")
    return launches


def phase_auto():
    """The autotuned Update phase dispatches to each committed cell's
    best, whose kernels hold against their plain versions at the cell's
    shapes; "last" raises on the card; two cells timed again live."""
    import dataclasses

    from repro_torch import gson
    from repro_torch.gson import autotune
    from repro_torch.kernels.update_phase import ops, sparse
    from repro_torch.kernels.update_phase.sparse import update_phase_sparse
    table = autotune.load_table(autotune.PACKAGED_TABLE)
    log(f"cuda-auto: committed table measured on {table.meta.get('nvidia_smi')}"
        f" (torch {table.meta.get('torch_version')}, CUDA "
        f"{table.meta.get('cuda_version')})")
    up = gson.resolve_backend("cuda-auto").update_phase
    launched = {}
    for cell in table.cells:
        u, C, m = cell.units, cell.capacity, cell.m
        assert up.select(C, m) == cell.best == min(
            set(cell.t_us) & set(autotune.CANDIDATES),
            key=lambda k: (cell.t_us[k], k)), cell
        inputs = autotune._cell_inputs(u, C, m, device="cuda")
        zero_counters()
        branch0 = (update_phase_sparse.slab_calls,
                   update_phase_sparse.dense_calls,
                   update_phase_sparse.pool_calls)
        with recorded(ops, "winner_lock_min", "update_accum") as at_pool, \
                recorded(sparse, "winner_lock_min", "update_accum") as at_slab:
            up(*inputs)
        n = counters()
        moved = n["winner_lock"].launches + n["update_accum"].launches
        for name in ("winner_lock", "update_accum"):
            launched[name] = launched.get(name, 0) + n[name].launches
        assert moved > 0, (cell, moved)
        branch = [k for k, a, b in zip(("slab", "dense", "pool"), (
            update_phase_sparse.slab_calls, update_phase_sparse.dense_calls,
            update_phase_sparse.pool_calls), branch0) if a != b]
        assert bool(branch) == (cell.best == "sparse"), (cell, branch)
        calls = {k: at_pool[k] + at_slab[k] for k in at_pool}
        err = check_update_kernels(calls, f"cuda-auto ({u}, {C}, {m})")
        times = "  ".join(f"{k} {v:.1f}" for k, v in sorted(cell.t_us.items()))
        log(f"  ({u}, {C}, {m}) -> {cell.best}"
            f"{' (' + branch[0] + ')' if branch else ''}: kernel launches "
            f"{moved}, B2 and B3 + B4 equal to their plain versions at "
            f"capacity {calls['winner_lock_min'][0][2]} (sums within "
            f"{err:.3g}); committed us: {times}")
    inputs = list(autotune._cell_inputs(32, 768, 64, device="cuda"))
    inputs[-1] = dataclasses.replace(inputs[-1], neighbor_collision="last")
    try:
        up(*inputs)
    except NotImplementedError:
        log('  neighbor_collision="last" raises on the card, as on the '
            'kernel backends')
    else:
        raise AssertionError('cuda-auto ran neighbor_collision="last" on '
                             'the card')
    for u, C, m in ((256, 4096, 512), (1024, 2048, 2048)):
        live = autotune.measure_cell(u, C, m, device="cuda")
        cell = next(c for c in table.cells
                    if (c.units, c.capacity, c.m) == (u, C, m))
        log(f"  live ({u}, {C}, {m}): best {live.best}, " + "  ".join(
            f"{k} {live.t_us[k]:.1f} us (committed {cell.t_us[k]:.1f})"
            for k in sorted(live.t_us)))
    return {**launched, "edge_age": launched["update_accum"]}


def phase_single(multi_signals_per_s: float):
    """The sequential baseline on the card: one B1 launch per signal, rows
    equal to the reference backend's; B1 held against its plain version
    at every signal of the reference trajectory."""
    import torch
    from repro_torch import gson
    from repro_torch.core.gson.multi import find_winners_reference
    from repro_torch.kernels.find_winners import kernel as fwk
    from repro_torch.kernels.find_winners.ops import cuda_find_winners
    n_sig = SINGLE_CHUNKS * gson.SingleConfig().chunk
    spec = gson.RunSpec(variant="single", backend="cuda-full",
                        max_iterations=SINGLE_CHUNKS, check_every=2)
    zero_counters()
    sess, st, stats, wall, chi = run_session(spec, SEED, None)
    launches = read_counters("single path", ("find_winners",))
    assert launches["find_winners"] == n_sig, launches
    assert stats.signals == n_sig, stats.signals
    check_state(st)
    ref = run_session(spec.replace(backend="reference"), SEED, None)
    rows, rrows = stats.history, ref[2].history
    assert len(rows) == len(rrows) == SINGLE_CHUNKS // 2

    def first_difference(rows, rrows):
        return next((i for i, (a, b) in enumerate(zip(rows, rrows))
                     if (a["units"], a["signals"]) != (b["units"],
                                                        b["signals"])
                     or not math.isclose(a["qe"], b["qe"], rel_tol=1e-4)),
                    None)
    first = first_difference(rows, rrows)
    # follow the reference trajectory and, at every signal, hold B1
    # against its plain version (phase 3's tolerances: ids on tie-free
    # signals, distances everywhere) and note the first signal at which
    # the kernel path's winners differ from the reference backend's
    flip = {}
    held = Counter()

    def probe(x, w, active):
        r = find_winners_reference(x, w, active)
        args = (x.float().contiguous(), w.float().contiguous(),
                active.contiguous())
        d2k, idk = fwk.find_winners_top2(*args)
        d2p, idp = fwk.find_winners_top2_plain(*args)
        ok = near_tie_free(x[0], w[0], active[0])
        assert torch.equal(idk[0][ok], idp[0][ok]), \
            f"find_winners ids differ at signal {held['signals']}"
        torch.testing.assert_close(d2k, d2p, rtol=2e-4, atol=1e-5)
        held.update(signals=1, tie_free=int(ok.sum()))
        held["err"] = max(held["err"], float((d2k - d2p).abs().max()))
        if not flip:
            k = cuda_find_winners(x, w, active)
            if not (torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])):
                d = ((x[0, 0] - w[0]) ** 2).sum(-1).double()
                d = torch.where(active[0], d, math.inf)
                top = torch.topk(d, 3, largest=False)
                flip.update(signal=held["signals"] - 1, kernel=(
                    int(k[0]), int(k[1])), plain=(int(r[0]), int(r[1])),
                    d2=top.values.tolist(), ids=top.indices.tolist())
        return r
    _, probe_stats = gson.run(
        spec.replace(backend=gson.Backend("probe", probe)), seed=SEED)
    assert held["signals"] == n_sig, held
    b1 = (f"B1 equal to its plain version at all {n_sig} signals of the "
          f"reference trajectory (ids on the {held['tie_free']} tie-free, "
          f"distances within {held['err']:.3g})")
    if first is None:
        verdict = f"rows equal to the reference backend's ({len(rows)} rows)"
    else:
        assert first_difference(probe_stats.history, rrows) is None, \
            "the probe left the reference path"
        assert flip, "rows differ but B1 agrees with the plain search"
        gap = min(b - a for a, b in zip(flip["d2"], flip["d2"][1:]))
        verdict = (f"row {first} differs from the reference backend's "
                   f"({rows[first]} vs {rrows[first]}); first B1 difference "
                   f"at signal {flip['signal']}: {flip}, nearest gap {gap:.3g}")
        assert gap <= 1e-4, "B1 flipped a winner that is not a near-tie"
    rate = n_sig / wall
    log(f"single (capacity 4096, {SINGLE_CHUNKS} chunks = {n_sig} signals, "
        f"units {stats.units}, chi {chi}): find_winners launched "
        f"{launches['find_winners']} times, once per signal; {verdict}; "
        f"{b1}; "
        f"{rate:.1f} signals/s (reference backend {n_sig / ref[3]:.1f}) "
        f"vs multi {multi_signals_per_s:.1f} signals/s on the main path "
        f"(x{multi_signals_per_s / rate:.0f})")
    return launches


def gate_probes():
    """The gate's probe set: 2048 sphere points from their own seed."""
    import torch
    from repro_torch.core.gson.sampling import make_sampler
    g = torch.Generator(device="cuda").manual_seed(123)
    return make_sampler("sphere")(g, 2048)


def quality_line(tq) -> str:
    return (f"chi {tq.chi} (exact {tq.exact_chi}), QE {tq.qe:.5f} (exact "
            f"{tq.exact_qe:.5f}, {tq.qe_rel:+.2%})")


def phase_ann():
    """The approximate Find Winners backends and the ``indexed`` variant
    at the default geometry beside the ``reference`` backend, then the
    JAX package's ANN acceptance gate on the card: chi equal to the
    ``cuda-full`` gate run's and QE within 5% of it."""
    from repro_torch import gson
    from repro_torch.ann.grid import guarded_search
    from repro_torch.core.gson import metrics
    zero_counters()
    for variant in ("multi", "multi-fused"):
        _, ref_st, ref_stats, ref_wall, _ = run_session(
            gson.RunSpec(variant=variant, backend="reference"), SEED,
            ANN_ITERS)
        log(f"ann {variant}: reference backend {ANN_ITERS} it, "
            f"{ANN_ITERS / ref_wall:.1f} it/s, units {ref_stats.units}")
        for be in ("ann-windowed", "ann-grid"):
            fires, calls = guarded_search.fires, guarded_search.calls
            sess, st, stats, wall, _ = run_session(
                gson.RunSpec(variant=variant, backend=be), SEED, ANN_ITERS)
            check_state(st)
            tq = metrics.topology_quality(st, ref_st, sess.probes)
            guard = (f"; guard fired on {guarded_search.fires - fires} of "
                     f"{guarded_search.calls - calls} searches"
                     if be == "ann-grid" else "")
            log(f"  {be}: {stats.iterations / wall:.1f} it/s "
                f"(x{ref_wall / wall:.2f} of "
                f"reference), units {stats.units}, "
                f"{quality_line(tq)}{guard}; rows equal to the reference "
                f"run's: {same_rows(stats, ref_stats)}")
    n_sig = INDEXED_CHUNKS * gson.IndexedConfig().chunk
    spec = gson.RunSpec(variant="indexed", max_iterations=INDEXED_CHUNKS,
                        check_every=1)
    _, st, stats, wall, _ = run_session(spec, SEED, None)
    check_state(st)
    assert stats.signals == n_sig, stats.signals
    sess, ref_st, _, ref_wall, _ = run_session(
        spec.replace(variant="single", backend="reference"), SEED, None)
    tq = metrics.topology_quality(st, ref_st, sess.probes)
    log(f"ann indexed (capacity {st.capacity}, {INDEXED_CHUNKS} chunks = "
        f"{n_sig} "
        f"signals): {n_sig / wall:.1f} signals/s, units {stats.units}; "
        f"single on the reference backend {n_sig / ref_wall:.1f} "
        f"signals/s; {quality_line(tq)}")
    launches = {name: f.launches for name, f in counters().items()}
    log(f"ann path launches: {launches} (the ANN backends and indexed run "
        f"the reference Update phase)")

    exact_st, exact_stats, exact_wall = GATE_RUNS["cuda-full"]
    probes = gate_probes()
    for be in ("ann-windowed", "ann-grid"):
        fires, calls = guarded_search.fires, guarded_search.calls
        _, st, stats, wall, _ = run_session(gate_spec(be), 42, None)
        check_state(st)
        # the gate compares runs of one length: neither converged early
        assert stats.iterations == exact_stats.iterations, (
            be, stats.iterations, exact_stats.iterations)
        tq = metrics.topology_quality(st, exact_st, probes, qe_tol=0.05)
        log(f"ann gate {be} (capacity 768, {stats.iterations} it in "
            f"{wall:.2f} s against cuda-full's {exact_stats.iterations} it "
            f"in {exact_wall:.2f} s): "
            f"{quality_line(tq)}, units {stats.units}"
            + (f"; guard fired on {guarded_search.fires - fires} of "
               f"{guarded_search.calls - calls} searches"
               if be == "ann-grid" else ""))
        assert tq.chi_match, f"{be}: chi {tq.chi} != exact {tq.exact_chi}"
        assert tq.qe_ok, f"{be}: QE {tq.qe_rel:+.2%} over the exact run's"
    return launches


def phase_paper():
    """The paper's configuration (``configs/soam_paper.py``: capacity
    32768, m up to 8192) on ``cuda-full`` for ``PAPER_ITERS`` iterations,
    each kernel held against its plain version on the grown pool, and
    ``ann-grid`` at the same capacity."""
    import torch
    from repro_torch import gson
    from repro_torch.ann.grid import guarded_search
    from repro_torch.configs import soam_paper
    from repro_torch.core.gson import metrics
    spec = soam_paper.paper_spec().replace(max_iterations=PAPER_ITERS)
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    with every_refresh_launches("paper path"):
        sess, st, stats, wall, chi = run_session(spec, SEED, None)
    launches = read_counters("paper path", tuple(counters()))
    check_state(st)
    log(f"paper (capacity {st.capacity}, m up to "
        f"{sess.cohorts[0].params.max_parallel}, {stats.iterations} it): "
        f"{stats.iterations / wall:.1f} it/s, units {stats.units}, signals "
        f"{stats.signals}, chi {chi}; launches {launches}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    results = hold_kernels(st, sess.cohorts[0].params, "paper kernels")
    fires, calls = guarded_search.fires, guarded_search.calls
    gsess, gst, gstats, gwall, _ = run_session(
        spec.replace(backend="ann-grid"), SEED, None)
    check_state(gst)
    fw = gson.resolve_backend("ann-grid").find_winners
    tq = metrics.topology_quality(gst, st, sess.probes)
    log(f"paper ann-grid ({'x'.join(map(str, fw.dims_for(st.capacity)))} "
        f"cells): {gstats.iterations / gwall:.1f} it/s against cuda-full's "
        f"{stats.iterations / wall:.1f}, units {gstats.units}, "
        f"{quality_line(tq)}; guard fired on {guarded_search.fires - fires}"
        f" of {guarded_search.calls - calls} searches")
    return launches, results, st.capacity


def check_find_winners(calls, ctx: str) -> float:
    """Every recorded B1 call against its plain version with phase 3's
    tolerances: ids on tie-free rows, distances within rtol=2e-4,
    atol=1e-5. Returns the largest distance error."""
    import torch
    from repro_torch.kernels.find_winners import kernel as fwk
    assert calls, f"{ctx}: find_winners was not called"
    err = 0.0
    for args in calls:
        d2k, idk = fwk.find_winners_top2(*args)
        d2p, idp = fwk.find_winners_top2_plain(*args)
        for b in range(args[0].shape[0]):
            ok = near_tie_free(args[0][b], args[1][b], args[2][b])
            assert torch.equal(idk[b][ok], idp[b][ok]), \
                f"{ctx}: find_winners ids differ"
        torch.testing.assert_close(d2k, d2p, rtol=2e-4, atol=1e-5)
        err = max(err, float((d2k - d2p).abs().max()))
    return err


def serve_jobs():
    """The serve phase's submissions: (spec, seed) in submit order."""
    from repro_torch import gson
    from repro_torch.configs import soam_paper
    fused = gson.RunSpec(variant="multi-fused", max_iterations=SERVE_ITERS)
    multi = gson.RunSpec(variant="multi", max_iterations=SERVE_ITERS)
    paper = soam_paper.paper_spec().replace(
        max_iterations=SERVE_PAPER_ITERS)
    single = gson.RunSpec(variant="single", max_iterations=SERVE_CHUNKS,
                          check_every=2, variant_config=gson.SingleConfig(
                              chunk=SERVE_CHUNK))
    return ([(fused, s) for s in range(4)] + [(multi, 4), (multi, 5),
                                               (paper, SEED), (single, SEED)])


def phase_serve(fleet_rates):
    """The main path, served: a ``ReconstructionServer`` on ``cuda-full``
    runs the jobs of ``serve_jobs()`` under the faults of ``SERVE_FAULTS``.
    Every job ends ``done``; the poisoned job retried once from its
    pre-poison checkpoint; device loss cost no retry; every fault record
    and warning is one the phase injected; each job equals its dedicated
    ``Session`` (fleet jobs: state bitwise, rows equal, ``qe`` within
    1e-6; the single job: rows equal); the kernels launched, and B1 and
    B2 / B3 + B4 on the calls recorded inside the server equal their plain
    versions. Ticks, wall, jobs/s, network-it/s beside phase 6's fleet,
    checkpoint ms per tick."""
    import shutil
    import warnings

    import torch
    from repro_torch import gson
    from repro_torch.kernels.find_winners import ops as fw_ops
    from repro_torch.kernels.update_phase import ops as up_ops
    from repro_torch.serving import ReconstructionServer
    root = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(root, ignore_errors=True)
    srv = ReconstructionServer(
        slots=SERVE_SLOTS, slice_iters=SERVE_SLICE, checkpoint_dir=str(root),
        backoff_ticks=SERVE_BACKOFF,
        injector=gson.GsonFaultInjector(dict(SERVE_FAULTS)))
    jobs = [srv.submit(spec, seed) for spec, seed in serve_jobs()]
    faults, ckpt_s = [], [0.0]
    fault_job, checkpoint_jobs = srv._fault_job, srv._checkpoint_jobs

    def logged_fault(job, kind, detail, *, count=True):
        faults.append((job.jid, kind, str(detail), count))
        fault_job(job, kind, detail, count=count)

    def timed_checkpoints():
        t0 = time.perf_counter()
        checkpoint_jobs()
        ckpt_s[0] += time.perf_counter() - t0
    srv._fault_job, srv._checkpoint_jobs = logged_fault, timed_checkpoints
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(fw_ops, "find_winners_top2") as fw_calls, \
            recorded(up_ops, "winner_lock_min", "update_accum") as up_calls, \
            warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        srv.run(max_ticks=100)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters("serve path", tuple(counters()))
    shutil.rmtree(root, ignore_errors=True)

    # only the injected faults happened
    assert [(j.status, j.retries) for j in jobs] == [
        ("done", int(j.jid == 1)) for j in jobs], [
        (j.jid, j.status, j.retries, j.error) for j in jobs]
    assert jobs[1].error["kind"] == "unhealthy_state", jobs[1].error
    assert [f[:2] for f in faults if f[1] != "device_loss"] == [
        (1, "unhealthy_state")], faults
    lost = sorted(f[0] for f in faults if f[1] == "device_loss")
    assert lost and all(not f[3] for f in faults if f[1] == "device_loss")
    assert all(jobs[j].retries == 0 for j in lost), lost
    crashes = [str(w.message) for w in warned]
    assert len(crashes) == 1 and "SimulatedCrash" in crashes[0], crashes

    # each job against its dedicated Session on the card
    worst, t_sess = 0.0, 0.0
    for job in jobs:
        sess = gson.Session(job.spec, seed=job.seed)
        t1 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
        t_sess += time.perf_counter() - t1
        if isinstance(job.session, gson.Session):
            assert job.history == sess.stats.history, job.jid
            assert_same_network(job.session.state, sess.state, job.history,
                                sess.stats.history, f"serve job {job.jid}")
            continue
        # the last row came from the job's final wave, at its index there
        st = job.session.network(job.history[-1]["network"])
        worst = max(worst, assert_same_network(
            st, sess.state, job.history, sess.stats.history,
            f"serve job {job.jid}"))

    # the kernels on calls recorded inside the server
    err_fw = check_find_winners(fw_calls["find_winners_top2"], "serve")
    err_up = check_update_kernels(up_calls, "serve")
    shapes = sorted({a[1].shape[:2] for a in fw_calls["find_winners_top2"]})
    iters = sum(j.stats.iterations for j in jobs if j.spec.variant != "single")
    card = nvidia_smi_line()
    log(f"serve: {len(jobs)} jobs ({SERVE_SLOTS} slots, slices of "
        f"{SERVE_SLICE} it) in {srv.ticks} ticks, {wall:.2f} s = "
        f"{len(jobs) / wall:.2f} jobs/s; every job done; faults "
        f"{[f[:2] for f in faults]} (all injected: poison, one checkpoint "
        f"crash warned, device loss free); launches {launches}  [{card}]")
    log(f"  {len(jobs)}/{len(jobs)} jobs equal to their dedicated Sessions "
        f"(fleet jobs: state bitwise, rows equal, qe max rel diff "
        f"{worst:.3g}; the single job's rows equal); dedicated Sessions "
        f"{t_sess:.2f} s in all")
    log(f"  network-it/s {iters / wall:.1f} ({iters} fleet-job iterations "
        f"kept, retried ones not counted) beside phase 6's fleet "
        + ", ".join(f"{v} B=1 {r[0]:.1f} B={FLEET_B} {r[1]:.1f}"
                    for v, r in fleet_rates.items())
        + f"; checkpoints {1e3 * ckpt_s[0] / srv.ticks:.2f} ms per tick "
        f"({ckpt_s[0]:.2f} s in all)  [{card}]")
    log(f"  B1 on {len(shapes)} recorded (B, C) shapes {shapes} equal to its"
        f" plain version (distances within {err_fw:.3g}); B2 and B3 + B4 on "
        f"{len(up_calls['update_accum'])} recorded shapes (sums within "
        f"{err_up:.3g})")
    return launches


# ---------------------------------------------------------------------------
# the mesh phase: worlds of torch.distributed ranks, each a process of its
# own (every function below with a ``rank`` runs in a spawned rank)

MESH_KERNELS = ("find_winners", "winner_lock", "update_accum")


def _mesh_rank_setup():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mesh_nccl_world(rank: int) -> dict:
    """One NCCL rank on ``cuda`` (= ``cuda:LOCAL_RANK``, card 0): a
    ``Session`` on a signal mesh and a B = MESH_B fleet on a network mesh,
    launches counted, then each against its unsharded run."""
    import torch
    from repro_torch import gson
    _mesh_rank_setup()
    spec = gson.RunSpec(variant="multi-fused", max_iterations=MESH_ITERS)
    zero_counters()
    t0 = time.perf_counter()
    sess = gson.Session(spec.replace(mesh=gson.MeshSpec(axis="signal")),
                        seed=SEED)
    sess.run()
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(
        spec, seeds=range(MESH_B), mesh=gson.MeshSpec(axis="network")))
    fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(f"mesh path (nccl rank {rank})", MESH_KERNELS)
    ref = gson.Session(spec, seed=SEED)
    ref.run()
    assert_same_network(sess.state, ref.state, sess.stats.history,
                        ref.stats.history, "nccl signal-mesh Session")
    plain = gson.FleetSession(gson.FleetSpec.broadcast(spec,
                                                       seeds=range(MESH_B)))
    plain.run()
    for i in range(MESH_B):
        assert_same_network(fleet.network(i), plain.network(i),
                            fleet.stats[i].history, plain.stats[i].history,
                            f"nccl network-mesh fleet network {i}")
    return {"launches": launches, "wall": wall,
            "device": str(sess.cohorts[0].device),
            "backend": torch.distributed.get_backend()}


def mesh_gloo_world(rank: int, root: str) -> dict:
    """Two gloo ranks that both name ``cuda:0``: the plain backend's
    Session on a signal mesh (the ranks hold one network), the
    signal-sharded step at m = MESH_M, the network-partitioned B1, a
    network-sharded fleet,
    ``ElasticFleetRunner`` losing a pod and a served wave shrunk by a
    device loss, launches counted; then each against its unsharded run
    (B1 on the recorded mesh shapes against its plain version)."""
    import torch
    from repro_torch import gson
    from repro_torch.core.gson import distributed as dist_core
    from repro_torch.core.gson.multi import multi_signal_step
    from repro_torch.ft.elastic import FailureInjector
    from repro_torch.kernels.find_winners import cuda_find_winners
    from repro_torch.kernels.find_winners import ops as fw_ops
    from repro_torch.kernels.update_phase import update_phase_op
    from repro_torch.serving import ReconstructionServer
    _mesh_rank_setup()
    spec = gson.RunSpec(variant="multi-fused", max_iterations=MESH_ITERS,
                        device="cuda:0")
    dev = spec.device
    signal = gson.MeshSpec(axis="signal")
    group = signal.build()
    # a pool grown by the plain backend on the signal mesh: its replicated
    # Update phase sums in an order fixed by the index on the card, so
    # both ranks must hold one network
    grow = gson.Session(spec.replace(backend="reference", mesh=signal),
                        seed=SEED)
    grow.run()
    st = grow.state
    grown = [None, None]
    torch.distributed.all_gather_object(
        grown, {f: getattr(st, f).cpu() for f in STATE_FIELDS})
    for name in STATE_FIELDS:
        assert torch.equal(grown[0][name], grown[1][name]), \
            f"the plain backend's signal-mesh run: {name} differs " \
            f"between the ranks"
    params = grow.cohorts[0].params
    g = torch.Generator(device=dev).manual_seed(SEED)
    sig = gson.resolve_sampler("sphere")(g, MESH_M)
    prio = torch.randperm(MESH_M, generator=g, device=dev, dtype=torch.int32)
    network = gson.MeshSpec(axis="network")
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(fw_ops, "find_winners_top2") as fw_calls:
        step = dist_core.make_distributed_step(group, params, "data",
                                               cuda_find_winners)
        stepped = step(st, sig, prio, update_phase=update_phase_op)
        fw_net = dist_core.network_parallel_find_winners(
            group, cuda_find_winners)(sig, st.w, st.active)
        fleet = gson.FleetSession(gson.FleetSpec.broadcast(
            spec, seeds=range(MESH_B), mesh=network))
        fleet.run()
        fleet_nets = [(s, t.history) for s, t in fleet.results()]
        elastic = gson.FleetSpec.broadcast(
            spec.replace(max_iterations=ELASTIC_ITERS),
            seeds=range(ELASTIC_B), mesh=network)
        s0 = gson.ElasticFleetRunner(elastic, f"{root}/e0",
                                     tick_iters=ELASTIC_TICK).run()
        nets0 = [s for s, _ in s0.results()]
        r1 = gson.ElasticFleetRunner(
            elastic, f"{root}/e1", tick_iters=ELASTIC_TICK,
            injector=FailureInjector(dict(ELASTIC_LOST)))
        s1 = r1.run()
        srv = ReconstructionServer(
            slots=MESH_SERVE_JOBS, slice_iters=ELASTIC_TICK,
            checkpoint_dir=f"{root}/srv", mesh=network,
            injector=gson.GsonFaultInjector(dict(MESH_SERVE_FAULTS)))
        jobs = [srv.submit(spec.replace(max_iterations=ELASTIC_ITERS), s)
                for s in range(MESH_SERVE_JOBS)]
        srv.run(max_ticks=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(f"mesh path (gloo rank {rank})", MESH_KERNELS)

    # against the unsharded runs, on this rank; the replicated Update
    # phase is the same on both ranks
    want = multi_signal_step(st, sig, params, prio, refresh_states=False,
                             find_winners=cuda_find_winners,
                             update_phase=update_phase_op)
    both = [None, None]
    torch.distributed.all_gather_object(
        both, {f: getattr(stepped, f).cpu() for f in STATE_FIELDS})
    for name in STATE_FIELDS:
        assert torch.equal(getattr(stepped, name), getattr(want, name)), \
            f"rank {rank}: the signal-sharded step's {name} differs"
        assert torch.equal(both[0][name], both[1][name]), \
            f"the signal-sharded step's {name} differs between the ranks"
    for a, b in zip(fw_net, cuda_find_winners(sig, st.w, st.active)):
        assert torch.equal(a, b), f"rank {rank}: network-partitioned B1"
    shapes = sorted({tuple(a[1].shape[:2]) + (a[0].shape[1],)
                     for a in fw_calls["find_winners_top2"]})
    err = check_find_winners(fw_calls["find_winners_top2"],
                             f"mesh rank {rank}")
    per = MESH_B // 2
    for i in range(rank * per, (rank + 1) * per):
        sess = gson.Session(spec, seed=i)
        sess.run()
        assert_same_network(fleet_nets[i][0], sess.state, fleet_nets[i][1],
                            sess.stats.history, f"mesh fleet network {i}")
    assert (s1 is None) == (rank == 1) and r1.fspec.mesh.ndev() == 1
    assert [e["event"] for e in r1.log] == ["restart"], r1.log
    assert srv.mesh.ndev() == 1 and srv.left == (rank == 1)
    if rank == 0:
        for i, (a, (b, _)) in enumerate(zip(nets0, s1.results())):
            for name in STATE_FIELDS:
                assert torch.equal(getattr(a, name), getattr(b, name)), \
                    f"elastic network {i}: {name} differs from no fault"
        ref = ReconstructionServer(slots=MESH_SERVE_JOBS,
                                   slice_iters=ELASTIC_TICK)
        refs = [ref.submit(j.spec, j.seed) for j in jobs]
        ref.run(max_ticks=50)
        for j, r in zip(jobs, refs):
            assert (j.status, j.retries, j.error["kind"]) == (
                "done", 0, "device_loss"), (j.jid, j.status, j.error)
            assert (j.stats.iterations, j.stats.units, j.stats.signals) == (
                r.stats.iterations, r.stats.units, r.stats.signals), j.jid
    return {"launches": launches, "wall": wall, "shapes": shapes,
            "err": err, "restore_s": r1.log[0]["restore_s"]}


def phase_mesh():
    """Device meshes (``MeshSpec`` on ``torch.distributed``): a world of
    one NCCL rank, then two gloo ranks on the one card. Two ranks on one
    card check correctness and host overhead, not scaling. Returns the
    launches of each rank's mesh path."""
    import shutil

    from repro_torch.core.gson.distributed import run_world
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    (nccl,) = run_world(mesh_nccl_world, 1, backend="nccl", timeout_s=300)
    t_nccl = time.perf_counter() - t0
    log(f"mesh nccl: 1 rank on {nccl['device']} ({nccl['backend']}), world "
        f"{t_nccl:.1f} s (mesh runs {nccl['wall']:.2f} s): a signal-mesh "
        f"Session and a B={MESH_B} network-mesh fleet ({MESH_ITERS} it) "
        f"equal to the unsharded runs (state bitwise, rows equal); "
        f"launches {nccl['launches']}  [{card}]")
    root = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_world(mesh_gloo_world, 2, (str(root),), timeout_s=400)
    t_gloo = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    log(f"mesh gloo: 2 ranks on cuda:0, world {t_gloo:.1f} s (mesh runs "
        + ", ".join(f"rank {r} {x['wall']:.2f} s" for r, x in
                    enumerate(ranks))
        + f"): the plain backend's signal-mesh Session ({MESH_ITERS} it) "
        f"bitwise alike on both ranks; the signal-sharded step at "
        f"m={MESH_M} and the "
        f"network-partitioned B1 equal to the unsharded ones bitwise on "
        f"both ranks; a B={MESH_B} network-sharded fleet equal to its "
        f"sessions; ElasticFleetRunner losing pod 1 (restore "
        f"{ranks[0]['restore_s']:.2f} s) equal to the run with no fault; a "
        f"served wave shrunk to 1 rank by device loss, every job done "
        f"with no retry and the stats of the server with no mesh  [{card}]")
    for r, x in enumerate(ranks):
        log(f"  gloo rank {r}: launches {x['launches']}; B1 on the mesh "
            f"shapes (B, C, m) {x['shapes']} equal to its plain version "
            f"(distances within {x['err']:.3g})")
    return {"mesh-nccl": nccl["launches"],
            **{f"mesh-gloo-{r}": x["launches"] for r, x in enumerate(ranks)}}


# the lm phase: the model served at full width, its requests and tokens,
# the profiled decode steps; the prefill + decode check (prompts, their
# length, decode steps), its f32 tolerance and the card-against-CPU
# tolerance and steps; the GQA model's wave
LM_ARCH, LM_GQA_ARCH = "qwen1.5-0.5b", "granite-3-2b"
LM_BATCH, LM_MAX_LEN, LM_REQUESTS, LM_MAX_TOKENS = 8, 256, 16, 32
LM_PROFILE_STEPS = 8
LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE = 2, 12, 8
LM_F32_TOL, LM_CARD_CPU_TOL, LM_CARD_CPU_STEPS = 2e-3, 1e-3, 4
LM_GQA_WAVE, LM_GQA_TOKENS = 8, 16
LM_DEVICE = "cuda"
# the MoE model served at full width in bf16 (DEPLOY's serve_bf16)
LM_MOE_ARCH = "qwen2-moe-a2.7b"

# the families phase: the SSM, hybrid and enc-dec models served at full
# width one at a time on the lm phase's requests; their prefill + decode
# against the forward at f32 on full-width models cut to FAM_DEPTH, over a
# prompt of FAM_PROMPT_LEN tokens (four SSD chunks of 256; whisper: the lm
# phase's prompt over encoder_ctx frames) with the forward over
# FAM_FORWARD_LEN tokens (whole chunks); the card against the CPU over a
# prompt of FAM_CARD_CPU_LEN tokens
FAM_ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium")
# (zamba2 cut from 12 to 6 layers, one shared invocation, to keep the
# script under 780 s with the families_mesh part)
FAM_DEPTH = {"mamba2-2.7b": dict(n_layers=2),
             "zamba2-2.7b": dict(n_layers=6),
             "whisper-medium": dict(n_layers=2, n_encoder_layers=2)}
FAM_PROMPT_LEN, FAM_FORWARD_LEN, FAM_CARD_CPU_LEN = 1024, 1280, 512

# the train phase: the model trained at full width, train_4k's sequence
# length with the global batch cut from 256 to TRAIN_BATCH sequences,
# TRAIN_STEPS steps with a checkpoint after TRAIN_SAVE_AT; the card
# against the CPU on a TRAIN_CHECK_LAYERS-layer full-width model over
# TRAIN_CHECK_SEQ tokens (loss within TRAIN_LOSS_TOL relative, each
# gradient within TRAIN_GRAD_TOL of its parameter's largest gradient)
TRAIN_ARCH = "qwen1.5-0.5b"
# the trained model's depth, cut from 24 (at full width) to keep the
# script inside its time with the families_mesh part and four ranks of
# the lm_mesh phase inside the card's memory; the lm_mesh phase trains
# the same model, and its dense prefill + decode runs that depth too
TRAIN_LAYERS = 6
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_AT = 8, 4, 2
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SEQ = 2, 256
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)

# the lm_mesh phase: (a) one NCCL rank on launch.train.make_mesh_for_env's
# (data 1, model 1) mesh, (b) four gloo ranks that all name cuda:0. The f32
# prefill + decode of both (LMM_B prompts of LMM_PROMPT tokens, LMM_DECODE
# steps, a cache of LMM_MAX_LEN positions), its logits within LMM_LOGIT_TOL
# of each other; (b)'s train steps on TRAIN_BATCH sequences cut from 4096
# to LMM_TRAIN_SEQ tokens, the loss within LMM_LOSS_TOL relative of (a)'s;
# the pod-manual step's health; the MoE model's depth and its tokens
# (batch, sequence), held against the dense reference within
# LMM_MOE_TOL (aux LMM_AUX_TOL) at capacity_factor LMM_MOE_CF
LMM_B, LMM_PROMPT, LMM_DECODE, LMM_MAX_LEN = 8, 16, 8, 32
LMM_LOGIT_TOL, LMM_LOSS_TOL = 1e-4, 1e-5
LMM_TRAIN_SEQ = 512
LMM_HEALTH = (1.0, 0.5)
LMM_MOE_LAYERS, LMM_MOE_X = 2, (4, 64)
LMM_MOE_TOL, LMM_AUX_TOL, LMM_MOE_CF = 2e-3, 1e-2, 8.0
# its families_mesh parts: (a) on the NCCL rank, FAM_ARCHS served at full
# width in bf16 through ServeEngine(mesh=), every token the families
# phase's; (b) on the four gloo ranks, each family at full width cut in
# depth to FAM_MESH_DEPTH (zamba2's 6 layers: one shared invocation): the
# f32 prefill + LMM_DECODE decode steps on (data 2, model 2) against the
# same weights without a mesh (run by (a)), and a train step on
# TRAIN_BATCH x FAM_MESH_SEQ tokens (at most 128: the SSD hazard) under
# the cell's deployment against the unmeshed step's loss
FAM_MESH_DEPTH = {"mamba2-2.7b": dict(n_layers=2),
                  "zamba2-2.7b": dict(n_layers=6),
                  "whisper-medium": dict(n_layers=2, n_encoder_layers=2)}
FAM_MESH_SEQ = 64
# what one phase hands a later one (the lm phase's tokens, the train
# phase's first loss)
CARRIED = {}


# the cuda tests of the paths that had not run on the card before (the
# engine shim, autotune's cache, cuda-auto in a Session, a cuda-sparse
# fleet at B = 4), TF32's refusal by the windowed search, the grid's
# own answer on a dense pool, a served poisoned job on the card, and the
# LM smoke configs on the card against the CPU (ServeEngine's device paths,
# the SSM, hybrid and enc-dec families among them)
C2_TESTS = ("c2_", "tf32", "grid_on_card", "serve_on_card", "lm_serve",
            "c4_", "lm_train", "families_on_card", "lm_mesh")


def phase_c2():
    """Those tests of ``tests/test_torch_kernels_cuda.py``, run by pytest
    in a child process; they must all pass."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "cuda", "-k", " or ".join(C2_TESTS),
         str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    tail = out.stdout.strip().splitlines()[-1:] or [out.stderr[-300:]]
    log(f"c2: pytest {' or '.join(C2_TESTS)}: {tail[0]}")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]


def lm_prompts(n: int, vocab: int, seed: int = 0, lo: int = 4, hi: int = 17):
    """Prompts drawn as ``repro_torch.launch.serve`` draws them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(lo, hi)))
            for _ in range(n)]


def lm_path_check(bundle, params, device, steps: int = LM_DECODE,
                  prompt_len: int = LM_PROMPT_LEN,
                  forward_len: int | None = None):
    """Prefill of ``LM_PROMPTS`` prompts of ``prompt_len`` tokens (an
    enc-dec model over ``encoder_ctx`` frames of 0.02 * N(0, 1)), then
    ``steps`` decode steps, beside the teacher-forced forward over
    ``forward_len`` tokens (``prompt_len + steps`` by default; 0: no
    forward): (the logits of each step, (steps + 1, B, V) in f32; the
    forward's logits at those positions, or None)."""
    import numpy as np
    import torch
    cfg = bundle.cfg
    forward_len = prompt_len + steps if forward_len is None else forward_len
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        2, cfg.vocab, (LM_PROMPTS, max(forward_len, prompt_len + steps))
    ).astype(np.int32)).to(device)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy((0.02 * rng.standard_normal(
            (LM_PROMPTS, cfg.encoder_ctx, cfg.d_model))).astype(
                np.float32)).to(device)
    cache, logits = bundle.prefill(
        params, {"tokens": toks[:, :prompt_len], **extra},
        max_len=prompt_len + steps)
    out = [logits.float()]
    for j in range(steps):
        at = prompt_len + j
        cache, logits = bundle.decode_step(params, cache, toks[:, at:at + 1])
        out.append(logits.float())
    if not forward_len:
        return torch.stack(out), None
    ref, _ = bundle.forward(params, {"tokens": toks[:, :forward_len],
                                     **extra})
    ref = ref[:, prompt_len - 1:prompt_len + steps].float().transpose(0, 1)
    return torch.stack(out), ref


def lm_checks(bundle, master, tag: str) -> dict:
    """Prefill + decode against the forward on the card, at f32 compute
    (within ``LM_F32_TOL``) and at bf16 (within twice the distance of the
    bf16 forward from the f32 forward: each bf16 path lies within bf16's
    own rounding error of the exact values, so two of them lie within
    twice that of each other)."""
    import torch
    from repro_torch.models.common import cast_params
    from repro_torch.models.registry import get_bundle
    b32 = get_bundle(bundle.cfg.replace(compute_dtype=torch.float32))
    pd32, fwd32 = lm_path_check(b32, master, LM_DEVICE)
    err32 = float((pd32 - fwd32).abs().max())
    assert torch.isfinite(pd32).all() and torch.allclose(
        pd32, fwd32, rtol=LM_F32_TOL, atol=LM_F32_TOL), (
        f"{tag} f32: prefill + decode {err32} from the forward")
    bf = cast_params(master, bundle.cfg.compute_dtype)
    pd16, fwd16 = lm_path_check(bundle, bf, LM_DEVICE)
    err16 = float((pd16 - fwd16).abs().max())
    yardstick = float((fwd16 - fwd32).abs().max())
    assert torch.isfinite(pd16).all() and err16 <= 2 * yardstick, (
        f"{tag} bf16: prefill + decode {err16} from the forward, bound "
        f"2 x {yardstick}")
    same = float((pd16.argmax(-1) == fwd16.argmax(-1)).float().mean())
    log(f"lm {tag}: prefill + {LM_DECODE} decode steps against the forward "
        f"({LM_PROMPTS} prompts of {LM_PROMPT_LEN}): f32 max |err| "
        f"{err32:.3g} (rtol = atol = {LM_F32_TOL}); bf16 max |err| {err16:.4g} "
        f"(bound 2 x {yardstick:.4g}, the bf16 forward's distance from the "
        f"f32 forward), greedy tokens equal on {100 * same:.1f}%")
    del bf
    return {"f32": err32, "bf16": err16, "bf16_yardstick": yardstick,
            "b32": b32}


def lm_serve(bundle, params, requests, max_tokens, tag, batch=LM_BATCH,
             max_len=LM_MAX_LEN, mesh=None):
    """Serve ``requests`` through a ``ServeEngine`` (on ``mesh`` if given)
    whose prefill and decode calls are timed with CUDA events; (engine,
    wall s, prefill ms per wave, decode ms per step)."""
    import dataclasses

    import torch
    from repro_torch.serving import ServeConfig, ServeEngine
    timed = dataclasses.replace(bundle)
    events = {"prefill": [], "decode_step": []}
    # CUDA events on the card; the host clock where a CPU rehearsal runs
    # this in a spawned rank
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def stamp():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(name):
        fn = getattr(bundle, name)

        def call(*a, **kw):
            t0 = stamp()
            out = fn(*a, **kw)
            events[name].append((t0, stamp()))
            return out
        return call

    timed.prefill, timed.decode_step = wrap("prefill"), wrap("decode_step")
    eng = ServeEngine(timed, params, ServeConfig(batch=batch, max_len=max_len,
                                                 eos_id=-1, temperature=0.0),
                      mesh=mesh)
    for i, p in enumerate(requests):
        eng.submit(p, rid=i, max_tokens=max_tokens)
    sync()
    t0 = time.perf_counter()
    done = eng.run()
    sync()
    wall = time.perf_counter() - t0
    assert sorted(r.rid for r in done) == list(range(len(requests))), tag
    assert all(len(r.out) == max_tokens for r in done), tag
    assert all(0 <= t < bundle.cfg.vocab for r in done for t in r.out), tag
    ms = {k: sum(a.elapsed_time(b) if cuda else (b - a) * 1e3
                 for a, b in v) / max(len(v), 1)
          for k, v in events.items()}
    return eng, wall, ms["prefill"], ms["decode_step"]


def phase_lm() -> dict:
    """The LM substrate on the card: ``LM_ARCH`` at its published width
    served by ``ServeEngine`` (random weights from a seed), prefill +
    decode against the forward at f32 and bf16, the card against the CPU,
    and ``LM_GQA_ARCH`` (GQA) likewise. No GSON kernel runs on this path:
    every launch counter must read 0 after it. Returns the path's
    launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_bytes
    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1-2. LM_ARCH at full width, served
    cfg = get_config(LM_ARCH)
    bundle = get_bundle(cfg)
    t0 = time.perf_counter()
    master = bundle.init(0, device=LM_DEVICE)
    torch.cuda.synchronize()
    log(f"lm {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"qkv_bias {cfg.qkv_bias}: {sum(v.numel() for v in master.values())}"
        f" parameters ({tree_bytes(master) / 1e9:.3f} GB f32), drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    lm_serve(bundle, master, lm_prompts(2, cfg.vocab, seed=9), 2,
             "warm-up")                       # cuBLAS handles, allocator
    reqs = lm_prompts(LM_REQUESTS, cfg.vocab)
    eng, wall, pre_ms, dec_ms = lm_serve(bundle, master, reqs,
                                         LM_MAX_TOKENS, cfg.name)
    assert (eng.prefills, eng.decode_steps) == (2, 62), (
        eng.prefills, eng.decode_steps)
    CARRIED["lm_tokens"] = sorted((r.rid, list(r.out)) for r in eng.finished)
    toks = sum(len(r.out) for r in eng.finished)
    weights = sum(v.numel() * v.element_size()
                  for k, v in eng.compute_params.items()
                  if k != "embed" or cfg.tie_embeddings)
    cache_b = tree_bytes(bundle.cache_shapes(LM_BATCH, LM_MAX_LEN))
    bound, _ = bound_ms(weights + cache_b, 0)
    log(f"lm serve {cfg.name}: {LM_REQUESTS} requests (prompts 4-16) x "
        f"{LM_MAX_TOKENS} tokens, batch {LM_BATCH}, max_len {LM_MAX_LEN}: "
        f"{eng.prefills} prefill waves, {eng.decode_steps} decode steps, "
        f"{toks} tokens in {wall:.3f} s = {toks / wall:.1f} tokens/s; "
        f"prefill {pre_ms:.3f} ms per wave, decode {dec_ms:.3f} ms per step "
        f"(CUDA events); the decode step's bound {bound:.4f} ms (bf16 "
        f"weights {weights / 1e6:.1f} MB without the embedding rows + the "
        f"cache {cache_b / 1e6:.1f} MB, at {HBM_BPS / 1e12} TB/s)  [{card}]")

    # the device's share over LM_PROFILE_STEPS decode steps of a new wave
    peng, _, _, _ = lm_serve(bundle, master, [], 1, "profile")
    for i, p in enumerate(reqs[:LM_BATCH]):
        peng.submit(p, rid=100 + i, max_tokens=LM_PROFILE_STEPS + 2)
    peng.step()                                   # drain, admit, prefill
    peng.step()                                   # one decode step, warm
    pwall, busy, n_ops, kernels, _ = profile_window(
        lambda: [peng.step() for _ in range(LM_PROFILE_STEPS)])
    if busy <= 0:
        log("lm profile: not measured (no device time recorded)")
    else:
        log(f"lm profile ({LM_PROFILE_STEPS} decode steps, batch "
            f"{LM_BATCH}): wall {pwall * 1e3 / LM_PROFILE_STEPS:.3f} ms per "
            f"step, device busy {busy * 1e3 / LM_PROFILE_STEPS:.3f} ms per "
            f"step = {100 * busy / pwall:.1f}% ({100 - 100 * busy / pwall:.1f}"
            f"% idle), {n_ops / LM_PROFILE_STEPS:.0f} device ops per step; "
            f"against the unprofiled decode step ({dec_ms:.3f} ms) the device "
            f"is busy {100 * busy * 1e3 / LM_PROFILE_STEPS / dec_ms:.1f}%")
        for name, (cnt, us) in sorted(kernels.items(),
                                      key=lambda kv: -kv[1][1])[:6]:
            log(f"  {us / LM_PROFILE_STEPS:9.1f} us/step  "
                f"{cnt / LM_PROFILE_STEPS:5.0f} per step  {name[:80]}")
    del eng, peng
    CARRIED["lm_peak"] = torch.cuda.max_memory_allocated()
    log(f"lm {cfg.name}: peak device memory "
        f"{CARRIED['lm_peak'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    # 3. prefill + decode against the forward, f32 and bf16
    errs = lm_checks(bundle, master, cfg.name)

    # 4. the card against the CPU, from the same f32 weights
    b32 = errs["b32"]
    pd_card, _ = lm_path_check(b32, master, LM_DEVICE, LM_CARD_CPU_STEPS)
    host = {k: v.cpu() for k, v in master.items()}
    pd_cpu, _ = lm_path_check(b32, host, "cpu", LM_CARD_CPU_STEPS)
    diff = float((pd_card.cpu() - pd_cpu).abs().max())
    assert torch.allclose(pd_card.cpu(), pd_cpu, rtol=LM_CARD_CPU_TOL,
                          atol=LM_CARD_CPU_TOL), f"card against the CPU: {diff}"
    top2 = pd_cpu.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > LM_CARD_CPU_TOL
    same = pd_card.cpu().argmax(-1) == pd_cpu.argmax(-1)
    assert bool(same[clear].all()), "greedy tokens differ on a clear margin"
    log(f"lm {cfg.name} card against the CPU (f32, prefill + "
        f"{LM_CARD_CPU_STEPS} decode steps): max |diff| {diff:.3g} (rtol = "
        f"atol = {LM_CARD_CPU_TOL}); greedy tokens equal on {int(clear.sum())} of "
        f"{clear.numel()} rows with a top-2 margin over {LM_CARD_CPU_TOL} "
        f"({int(same.sum())} of {same.numel()} in all)")
    del host, master, b32, errs
    torch.cuda.empty_cache()
    mem_qwen = torch.cuda.max_memory_allocated()

    # 5. LM_GQA_ARCH at full width: the same checks, then one wave
    torch.cuda.reset_peak_memory_stats()
    gcfg = get_config(LM_GQA_ARCH)
    gbundle = get_bundle(gcfg)
    gmaster = gbundle.init(0, device=LM_DEVICE)
    gerrs = lm_checks(gbundle, gmaster, gcfg.name)
    del gerrs
    geng, gwall, gpre, gdec = lm_serve(
        gbundle, gmaster, lm_prompts(LM_GQA_WAVE, gcfg.vocab, seed=3),
        LM_GQA_TOKENS, gcfg.name, batch=LM_GQA_WAVE, max_len=64)
    gtoks = sum(len(r.out) for r in geng.finished)
    log(f"lm serve {gcfg.name} ({gcfg.n_layers} layers, GQA "
        f"{gcfg.n_heads}/{gcfg.n_kv}, no bias): one wave of {LM_GQA_WAVE} "
        f"requests x {LM_GQA_TOKENS} tokens, {gtoks} tokens in {gwall:.3f} s"
        f" = {gtoks / gwall:.1f} tokens/s; prefill {gpre:.3f} ms, decode "
        f"{gdec:.3f} ms per step; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    del geng, gmaster
    torch.cuda.empty_cache()

    # 6. LM_MOE_ARCH at full width in bf16, its f32 checks, a train step
    lm_moe(card)

    # 7. no GSON kernel on this path
    launches = read_counters("lm path", ())
    assert all(n == 0 for n in launches.values()), (
        f"GSON kernels launched on the LM path: {launches}")
    log(f"lm path launches: {launches} (none of the GSON kernels); phase "
        f"{time.perf_counter() - t_phase:.1f} s; {LM_ARCH} peak "
        f"{mem_qwen / 2**30:.2f} GiB  [{card}]")
    return {"lm": launches}


def lm_moe(card: str) -> None:
    """``LM_MOE_ARCH`` at its published width with bf16 parameters (the
    deployment table's ``serve_bf16``: an f32 master would not fit beside
    the engine's copy) served by ``ServeEngine`` on the requests of the
    dense case: tokens/s, decode ms per step, peak memory and the decode
    step's bytes bound (every padded expert is read: the reference path
    is dense), beside the bytes a routed design would read. Then prefill
    + decode against the forward at f32 on a 2-layer full-width model,
    and one smoke-size train step on the card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import padded_experts
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_bytes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_MOE_ARCH).replace(param_dtype=torch.bfloat16)
    bundle = get_bundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, device=LM_DEVICE)
    torch.cuda.synchronize()
    e_pad = padded_experts(cfg, 16)
    log(f"lm {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} routed experts (padded to {e_pad}) top-{cfg.top_k} "
        f"+ {cfg.n_shared_experts} shared, expert d_ff {cfg.d_ff_expert}, "
        f"vocab {cfg.vocab}: {sum(v.numel() for v in params.values())} "
        f"parameters ({tree_bytes(params) / 1e9:.3f} GB bf16), drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    lm_serve(bundle, params, lm_prompts(2, cfg.vocab, seed=9), 2,
             "moe warm-up")
    eng, wall, pre_ms, dec_ms = lm_serve(
        bundle, params, lm_prompts(LM_REQUESTS, cfg.vocab), LM_MAX_TOKENS,
        cfg.name)
    assert (eng.prefills, eng.decode_steps) == (2, 62), (
        eng.prefills, eng.decode_steps)
    assert all(eng.compute_params[k] is params[k] for k in params), (
        "the engine copied bf16 parameters")
    toks = sum(len(r.out) for r in eng.finished)
    weights = sum(v.numel() * v.element_size() for k, v in params.items()
                  if k != "embed" or cfg.tie_embeddings)
    expert_b = sum(params[k].numel() * params[k].element_size()
                   for k in ("layers/we_gate", "layers/we_up",
                             "layers/we_down"))
    touched = min(cfg.n_experts, LM_BATCH * cfg.top_k)
    routed = weights - expert_b + expert_b * touched // e_pad
    cache_b = tree_bytes(bundle.cache_shapes(LM_BATCH, LM_MAX_LEN))
    bound, _ = bound_ms(weights + cache_b, 0)
    routed_ms, _ = bound_ms(routed + cache_b, 0)
    log(f"lm serve {cfg.name} (bf16): {LM_REQUESTS} requests x "
        f"{LM_MAX_TOKENS} tokens, batch {LM_BATCH}: {eng.prefills} prefill "
        f"waves, {eng.decode_steps} decode steps, {toks} tokens in "
        f"{wall:.3f} s = {toks / wall:.1f} tokens/s; prefill {pre_ms:.3f} ms "
        f"per wave, decode {dec_ms:.3f} ms per step (CUDA events); the "
        f"decode step's bound {bound:.4f} ms (every padded expert read: "
        f"weights {weights / 1e9:.3f} GB without the embedding rows + the "
        f"cache {cache_b / 1e6:.1f} MB, at {HBM_BPS / 1e12} TB/s); a routed "
        f"design reading at most {touched} of {e_pad} experts per layer: "
        f"{routed_ms:.4f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    del eng, params
    torch.cuda.empty_cache()

    # prefill + decode against the forward at f32, 2 layers, full width
    c32 = get_config(LM_MOE_ARCH).replace(n_layers=2,
                                          compute_dtype=torch.float32)
    b32 = get_bundle(c32)
    m32 = b32.init(0, device=LM_DEVICE)
    pd, fwd = lm_path_check(b32, m32, LM_DEVICE)
    err = float((pd - fwd).abs().max())
    assert torch.isfinite(pd).all() and torch.allclose(
        pd, fwd, rtol=LM_F32_TOL, atol=LM_F32_TOL), (
        f"{c32.name} f32: prefill + decode {err} from the forward")
    log(f"lm {c32.name} (2 layers, full width, f32): prefill + {LM_DECODE} "
        f"decode steps against the forward ({LM_PROMPTS} prompts of "
        f"{LM_PROMPT_LEN}): max |err| {err:.3g} (rtol = atol = {LM_F32_TOL})")
    del m32, pd, fwd
    torch.cuda.empty_cache()
    smoke_train_step_card_vs_cpu(LM_MOE_ARCH)


def fam_decode_bytes(bundle, compute_params) -> tuple:
    """(weight bytes, cache bytes) one decode step moves at ``LM_BATCH``
    x ``LM_MAX_LEN``: the compute-dtype weights it reads (no embedding
    table, only its rows; no encoder and no cross K/V projections, whose
    output is cached; the hybrid's shared block once per invocation),
    and the cache: each SSM state and conv tail read and written, each
    K/V read."""
    from repro_torch.models.hybrid import n_shared_invocations
    from repro_torch.utils import tree_bytes
    cfg = bundle.cfg
    skip = ("embed", "enc_final_norm", "layers/wk_c", "layers/wv_c")
    weights = 0
    for k, v in compute_params.items():
        if k in skip or k.startswith("enc/"):
            continue
        reads = n_shared_invocations(cfg) if k.startswith("shared/") else 1
        weights += reads * v.numel() * v.element_size()
    cache = bundle.cache_shapes(LM_BATCH, LM_MAX_LEN)
    state = tree_bytes({k: v for k, v in cache.items()
                        if k in ("ssm", "hx", "hb", "hc")})
    return weights, tree_bytes(cache) + state


def phase_families() -> dict:
    """The SSM, hybrid and enc-dec families on the card, one model at a
    time with its memory freed before the next: each of ``FAM_ARCHS`` at
    its published width (random weights from ``SEED``, f32 master, bf16
    compute) served by ``ServeEngine`` on the lm phase's requests
    (whisper on the engine's zero frames): tokens/s, prefill ms per wave
    and decode ms per step (CUDA events), the device's share over
    ``LM_PROFILE_STEPS`` decode steps, peak memory and the decode step's
    bytes bound. Then prefill + decode against the forward at f32 on the
    full-width model cut to ``FAM_DEPTH`` (rtol = atol = ``LM_F32_TOL``),
    over ``FAM_PROMPT_LEN`` tokens (four SSD chunks) or, for whisper,
    ``encoder_ctx`` frames; and the card against the CPU from the same
    f32 weights (rtol = atol = ``LM_CARD_CPU_TOL``). No GSON kernel runs
    on this path: every launch counter must read 0 after it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_bytes
    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    zero_counters()
    for arch in FAM_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        bundle = get_bundle(cfg)
        t0 = time.perf_counter()
        master = bundle.init(SEED, device=LM_DEVICE)
        torch.cuda.synchronize()
        log(f"families {cfg.name} ({cfg.family}): {cfg.n_layers} layers"
            + (f" + {cfg.n_encoder_layers} encoder layers"
               if cfg.family == "encdec" else "")
            + f", d_model {cfg.d_model}, vocab {cfg.vocab}: "
            f"{sum(v.numel() for v in master.values())} parameters "
            f"({tree_bytes(master) / 1e9:.3f} GB f32), drawn in "
            f"{time.perf_counter() - t0:.2f} s")
        lm_serve(bundle, master, lm_prompts(2, cfg.vocab, seed=9), 2,
                 f"{cfg.name} warm-up")
        reqs = lm_prompts(LM_REQUESTS, cfg.vocab)
        eng, wall, pre_ms, dec_ms = lm_serve(bundle, master, reqs,
                                             LM_MAX_TOKENS, cfg.name)
        assert (eng.prefills, eng.decode_steps) == (2, 62), (
            cfg.name, eng.prefills, eng.decode_steps)
        CARRIED.setdefault("fam_tokens", {})[arch] = sorted(
            (r.rid, list(r.out)) for r in eng.finished)
        toks = sum(len(r.out) for r in eng.finished)
        weights, cache_b = fam_decode_bytes(bundle, eng.compute_params)
        bound, _ = bound_ms(weights + cache_b, 0)
        log(f"families serve {cfg.name}: {LM_REQUESTS} requests (prompts "
            f"4-16) x {LM_MAX_TOKENS} tokens, batch {LM_BATCH}, max_len "
            f"{LM_MAX_LEN}: {eng.prefills} prefill waves, {eng.decode_steps} "
            f"decode steps, {toks} tokens in {wall:.3f} s = "
            f"{toks / wall:.1f} tokens/s; prefill {pre_ms:.3f} ms per wave, "
            f"decode {dec_ms:.3f} ms per step (CUDA events); the decode "
            f"step's bound {bound:.4f} ms (bf16 weights read {weights / 1e9:.3f}"
            f" GB + cache/state {cache_b / 1e9:.3f} GB, at "
            f"{HBM_BPS / 1e12} TB/s); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        peng, _, _, _ = lm_serve(bundle, master, [], 1, "profile")
        for i, p in enumerate(reqs[:LM_BATCH]):
            peng.submit(p, rid=100 + i, max_tokens=LM_PROFILE_STEPS + 2)
        peng.step()                               # drain, admit, prefill
        peng.step()                               # one decode step, warm
        pwall, busy, n_ops, kernels, _ = profile_window(
            lambda: [peng.step() for _ in range(LM_PROFILE_STEPS)])
        if busy <= 0:
            log(f"families profile {cfg.name}: not measured (no device time "
                f"recorded)")
        else:
            log(f"families profile {cfg.name} ({LM_PROFILE_STEPS} decode "
                f"steps, batch {LM_BATCH}): wall "
                f"{pwall * 1e3 / LM_PROFILE_STEPS:.3f} ms per step, device "
                f"busy {busy * 1e3 / LM_PROFILE_STEPS:.3f} ms per step = "
                f"{100 * busy / pwall:.1f}% ({100 - 100 * busy / pwall:.1f}% "
                f"idle), {n_ops / LM_PROFILE_STEPS:.0f} device ops per step")
            for name, (cnt, us) in sorted(kernels.items(),
                                          key=lambda kv: -kv[1][1])[:4]:
                log(f"  {us / LM_PROFILE_STEPS:9.1f} us/step  "
                    f"{cnt / LM_PROFILE_STEPS:5.0f} per step  {name[:80]}")
        del eng, peng, master
        torch.cuda.empty_cache()

        # prefill + decode against the forward at f32, reduced depth
        c32 = cfg.replace(compute_dtype=torch.float32, **FAM_DEPTH[arch])
        b32 = get_bundle(c32)
        m32 = b32.init(SEED, device=LM_DEVICE)
        ssm = cfg.family in ("ssm", "hybrid")
        plen = FAM_PROMPT_LEN if ssm else LM_PROMPT_LEN
        flen = FAM_FORWARD_LEN if ssm else LM_PROMPT_LEN + LM_DECODE
        pd, fwd = lm_path_check(b32, m32, LM_DEVICE, LM_DECODE, plen, flen)
        err = float((pd - fwd).abs().max())
        assert torch.isfinite(pd).all() and torch.allclose(
            pd, fwd, rtol=LM_F32_TOL, atol=LM_F32_TOL), (
            f"{cfg.name} f32: prefill + decode {err} from the forward")
        depth = ", ".join(f"{k} {v}" for k, v in FAM_DEPTH[arch].items())
        what = (f"{plen} tokens = {plen // cfg.ssm_chunk} SSD chunks" if ssm
                else f"{plen} tokens over {cfg.encoder_ctx} frames")
        log(f"families {cfg.name} ({depth}, full width, f32): prefill of "
            f"{LM_PROMPTS} prompts of {what} + {LM_DECODE} decode steps "
            f"against the forward over {flen} tokens: max |err| {err:.3g} "
            f"(rtol = atol = {LM_F32_TOL})")
        del pd, fwd

        # the card against the CPU, from the same f32 weights
        plen = FAM_CARD_CPU_LEN if ssm else LM_PROMPT_LEN
        pd_card, _ = lm_path_check(b32, m32, LM_DEVICE, LM_CARD_CPU_STEPS,
                                   plen, 0)
        host = {k: v.cpu() for k, v in m32.items()}
        pd_cpu, _ = lm_path_check(b32, host, "cpu", LM_CARD_CPU_STEPS, plen, 0)
        diff = float((pd_card.cpu() - pd_cpu).abs().max())
        assert torch.allclose(pd_card.cpu(), pd_cpu, rtol=LM_CARD_CPU_TOL,
                              atol=LM_CARD_CPU_TOL), (
            f"{cfg.name} card against the CPU: {diff}")
        log(f"families {cfg.name} card against the CPU (f32, {depth}, "
            f"prefill of {plen} tokens + {LM_CARD_CPU_STEPS} decode steps): "
            f"max |diff| {diff:.3g} (rtol = atol = {LM_CARD_CPU_TOL})")
        del m32, host, pd_card, pd_cpu
        torch.cuda.empty_cache()

    launches = read_counters("families path", ())
    assert all(n == 0 for n in launches.values()), (
        f"GSON kernels launched on the families path: {launches}")
    log(f"families path launches: {launches} (none of the GSON kernels); "
        f"phase {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"families": launches}


def smoke_train_step_card_vs_cpu(arch: str, lr: float = 1e-3) -> None:
    """One train step of ``arch``'s smoke config (f32, AdamW, two
    microbatches) on the card and on the CPU from one set of weights: the
    loss within 1e-5 relative, the gradient norm within 1e-4, each
    parameter within 2 lr + 1e-6 (AdamW's first step is about lr
    sign(g), and a gradient whose sign is rounding noise may flip)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.common import ShapeCfg
    from repro_torch.models.registry import get_bundle, smoke_config
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.trainer import TrainConfig, make_train_step
    cfg = smoke_config(get_config(arch))
    bundle = get_bundle(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=lr), microbatches=2)
    step = make_train_step(bundle, tcfg=tcfg)
    batch = synthetic_batch(cfg, ShapeCfg("t", 32, 4, "train"), device="cpu")
    host = bundle.init(0, device="cpu")
    out = {}
    for dev in ("cpu", LM_DEVICE):
        params = {k: v.to(dev, copy=True) for k, v in host.items()}
        p, _, m = step(params, init_opt_state(tcfg.opt, params),
                       {k: v.to(dev) for k, v in batch.items()})
        out[dev] = ({k: v.cpu() for k, v in p.items()}, float(m["loss"]),
                    float(m["gnorm"]))
    (pc, lc, gc), (pd, ld, gd) = out["cpu"], out[LM_DEVICE]
    diff = max(float((pd[k] - pc[k]).abs().max()) for k in pc)
    moved = sum(int(((pd[k] - pc[k]).abs() > 1e-5).sum()) for k in pc)
    n = sum(v.numel() for v in pc.values())
    assert math.isclose(ld, lc, rel_tol=1e-5), (ld, lc)
    assert math.isclose(gd, gc, rel_tol=1e-4), (gd, gc)
    assert diff <= 2 * lr + 1e-6, diff
    log(f"train {cfg.name} (smoke, f32, 2 microbatches) card against the "
        f"CPU: loss {ld:.7f} / {lc:.7f}, gnorm {gd:.6f} / {gc:.6f}; params "
        f"max |diff| {diff:.3g} (bound 2 lr + 1e-6 = {2 * lr + 1e-6:.3g}), "
        f"{moved} of {n} beyond 1e-5")


def train_flops(cfg, n_seq: int, seq: int) -> tuple:
    """(matrix-product flops in the compute dtype, attention flops in f32)
    of one train step under full remat: the forward, the layers' forward
    again in the backward pass, and the backward (twice a forward). The
    attention counts its causal half: QK^T and PV, 2 S^2 H Dh per layer
    and sequence."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    H, KV, Dh, F = cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_ff
    tokens = n_seq * seq
    layer = D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F
    mm_layers = 2.0 * tokens * L * layer
    mm_head = 2.0 * tokens * D * V
    attn = 2.0 * L * n_seq * seq * seq * H * Dh
    return 4 * mm_layers + 3 * mm_head, 4 * attn


def phase_train() -> dict:
    """Dense training on the card: ``TRAIN_ARCH`` at its published width
    (f32 master, bf16 compute, remat full) at ``train_4k``'s sequence
    length, the global batch cut from 256 to ``TRAIN_BATCH`` sequences,
    through ``launch.steps.build_train_step`` with the cell's deployment
    (``resolve_deploy``: one sequence per microbatch, AdamW, a bf16
    gradient accumulator), ``TRAIN_STEPS`` steps: ms per step (CUDA
    events), tokens/s, peak memory and the step's FLOP bound. The loss and
    gnorm finite, every parameter changed; a checkpoint after
    ``TRAIN_SAVE_AT`` steps, restored into a fresh tree, takes the
    remaining steps as the uninterrupted run did (bitwise or within the
    AdamW rule, as printed). Then the card against the CPU at f32 on a
    ``TRAIN_CHECK_LAYERS``-layer full-width model over ``TRAIN_CHECK_SEQ``
    tokens. No GSON kernel runs on this path. Returns its launches."""
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import steps
    from repro_torch.models.common import SHAPES, ShapeCfg
    from repro_torch.models.registry import get_bundle
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.trainer import grad_fn
    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    assert (cfg.remat, cfg.param_dtype, cfg.compute_dtype) == (
        "full", torch.float32, torch.bfloat16)
    seq = SHAPES["train_4k"].seq_len
    shape = ShapeCfg("train_4k", seq, TRAIN_BATCH, "train")
    dep = steps.resolve_deploy(steps.deploy_for(cfg.name, "train_4k"), shape)
    assert (dep.microbatches, dep.optimizer) == (TRAIN_BATCH, "adamw"), dep
    bundle = get_bundle(cfg)
    step, _, tcfg = steps.build_train_step(bundle, None, None, dep)
    params = bundle.init(0, device=LM_DEVICE)
    opt = init_opt_state(tcfg.opt, params)
    first = {k: v.clone() for k, v in params.items()}
    batches = [synthetic_batch(cfg, shape, step=i, seed=0, device=LM_DEVICE)
               for i in range(TRAIN_STEPS)]
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(str(ckpt_dir), keep=1)
    ms, losses, gnorms = [], [], []
    for i, batch in enumerate(batches):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        params, opt, m = step(params, opt, batch)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        if i + 1 == TRAIN_SAVE_AT:    # the host copy now, the write on
            t0 = time.perf_counter()   # a thread beside the next steps
            ckpt.save_async((params, opt), i + 1)
            save_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    CARRIED["train_loss0"] = losses[0]
    CARRIED["train_peak"], CARRIED["train_ms"] = peak, ms[1:]
    # where a microbatch's time goes: one sequence's gradient, profiled
    gfn = grad_fn(bundle)
    one = {k: v[:1] for k, v in batches[0].items()}
    gfn(params, one)
    pwall, busy, n_ops, kernels, _ = profile_window(lambda: gfn(params, one))
    same = [k for k in params if torch.equal(first[k], params[k])]
    assert not same, f"parameters unchanged by {TRAIN_STEPS} steps: {same}"
    del first
    mm, attn = train_flops(cfg, TRAIN_BATCH, seq)
    step_ms = sum(ms[1:]) / len(ms[1:])
    bf16_ms = (mm + attn) / BF16_FLOPS * 1e3
    typed_ms = (mm / BF16_FLOPS + attn / FP32_FLOPS) * 1e3
    log(f"train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {sum(v.numel() for v in params.values())} "
        f"parameters (f32 master, bf16 compute, remat {cfg.remat}); "
        f"{TRAIN_BATCH} sequences of {seq} tokens per step (train_4k's "
        f"global batch of 256 cut to {TRAIN_BATCH}), {dep.microbatches} "
        f"microbatches, {tcfg.opt.name}, {tcfg.accum_dtype} accumulator")
    log(f"train {cfg.name}: losses {[round(x, 4) for x in losses]}, gnorms "
        f"{[round(x, 3) for x in gnorms]}; step ms (CUDA events) "
        f"{[round(x, 1) for x in ms]}: {step_ms:.1f} ms per step after the "
        f"first = {TRAIN_BATCH * seq / step_ms * 1e3:.0f} tokens/s; peak "
        f"device memory {peak / 2**30:.2f} GiB; the step's FLOP bound "
        f"{bf16_ms:.1f} ms at the dense bf16 peak ({(mm + attn) / 1e12:.1f} "
        f"TFLOP: {mm / 1e12:.1f} in matrix products, {attn / 1e12:.1f} in "
        f"attention, remat forward counted) = {100 * bf16_ms / step_ms:.1f}% "
        f"of the step; with the attention at the f32 peak (the port computes "
        f"it in f32, as JAX does) {typed_ms:.1f} ms = "
        f"{100 * typed_ms / step_ms:.1f}%  [{card}]")

    if busy <= 0:
        log("train profile: not measured (no device time recorded)")
    else:
        log(f"train profile (the gradient of one {seq}-token microbatch: "
            f"forward, remat forward, backward): wall {pwall * 1e3:.1f} ms, "
            f"device busy {busy * 1e3:.1f} ms = {100 * busy / pwall:.1f}%, "
            f"{n_ops} device ops")
        for name, (cnt, us) in sorted(kernels.items(),
                                      key=lambda kv: -kv[1][1])[:8]:
            log(f"  {us / 1e3:9.1f} ms  {cnt:6d} launches  {name[:80]}")

    # resume from the checkpoint: the remaining steps as the run above
    fresh = bundle.init(1, device=LM_DEVICE)
    t0 = time.perf_counter()
    (p2, o2), at, _ = ckpt.restore((fresh, init_opt_state(tcfg.opt, fresh)))
    restore_s = time.perf_counter() - t0
    assert at == TRAIN_SAVE_AT and int(o2["step"]) == TRAIN_SAVE_AT
    resumed = []
    for batch in batches[TRAIN_SAVE_AT:]:
        p2, o2, m = step(p2, o2, batch)
        resumed.append(float(m["loss"]))
    bitwise = all(torch.equal(p2[k], params[k]) for k in params) and all(
        torch.equal(o2[s][k], opt[s][k]) for s in ("m", "v") for k in params)
    diff = max(float((p2[k] - params[k]).abs().max()) for k in params)
    rule = 2 * tcfg.opt.lr * (TRAIN_STEPS - TRAIN_SAVE_AT) + 1e-6
    assert diff <= rule, f"resumed params {diff} from the run's, bound {rule}"
    assert all(math.isclose(a, b, rel_tol=1e-5) for a, b in
               zip(resumed, losses[TRAIN_SAVE_AT:])), (resumed, losses)
    log(f"train resume: checkpoint of (params, opt_state) at step "
        f"{TRAIN_SAVE_AT}: its host copy {save_s:.1f} s (the write ran "
        f"beside the next steps), restored in {restore_s:.1f} s; steps {TRAIN_SAVE_AT + 1}-{TRAIN_STEPS} losses "
        f"{[round(x, 6) for x in resumed]} against "
        f"{[round(x, 6) for x in losses[TRAIN_SAVE_AT:]]}; parameters and "
        f"moments {'bitwise equal' if bitwise else 'not bitwise equal'} "
        f"to the uninterrupted run's (max |diff| {diff:.3g}, bound "
        f"{rule:.3g})")
    del p2, o2, params, opt, fresh, batches
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # the card against the CPU at f32, TRAIN_CHECK_LAYERS layers
    c32 = cfg.replace(n_layers=TRAIN_CHECK_LAYERS, compute_dtype=torch.float32)
    b32 = get_bundle(c32)
    host = b32.init(0, device="cpu")
    batch = synthetic_batch(c32, ShapeCfg("t", TRAIN_CHECK_SEQ, 1, "train"),
                            seed=1, device="cpu")
    gfn = grad_fn(b32)
    (lc, _), gc = gfn(host, batch)
    (ld, _), gd = gfn({k: v.to(LM_DEVICE) for k, v in host.items()},
                      {k: v.to(LM_DEVICE) for k, v in batch.items()})
    rel = {k: float((gd[k].cpu() - gc[k]).abs().max() / gc[k].abs().max()
                    .clamp_min(1e-30)) for k in gc}
    worst = max(rel, key=rel.get)
    assert math.isclose(float(ld), float(lc), rel_tol=TRAIN_LOSS_TOL), (
        float(ld), float(lc))
    assert rel[worst] <= TRAIN_GRAD_TOL, (worst, rel[worst])
    log(f"train {c32.name} ({TRAIN_CHECK_LAYERS} layers, full width, f32, "
        f"{TRAIN_CHECK_SEQ} tokens) card against the CPU: loss "
        f"{float(ld):.7f} / {float(lc):.7f} (rel tol {TRAIN_LOSS_TOL}); "
        f"gradients within {rel[worst]:.3g} of each parameter's largest "
        f"(worst {worst}; tol {TRAIN_GRAD_TOL})")
    del host, gc, gd
    torch.cuda.empty_cache()

    launches = read_counters("train path", ())
    assert all(n == 0 for n in launches.values()), (
        f"GSON kernels launched on the train path: {launches}")
    log(f"train path launches: {launches} (none of the GSON kernels); phase "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"train": launches}


def lmm_setup(rank: int, opts: dict):
    """A rank of the lm_mesh phase: TF32 off, its device, the GSON
    counters at 0, its peak memory reset."""
    import torch
    _mesh_rank_setup()
    torch.set_num_threads(2)
    zero_counters()
    if opts["device"] != "cpu":
        torch.cuda.reset_peak_memory_stats()
    return opts["device"]


def lmm_cfg(arch: str, opts: dict, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import smoke_config
    cfg = get_config(arch)
    return (smoke_config(cfg) if opts.get("smoke") else cfg).replace(**kw)


def lmm_depth(opts: dict) -> dict:
    """The depth of the lm_mesh phase's dense model: ``TRAIN_LAYERS``."""
    return {} if opts.get("smoke") else {"n_layers": TRAIN_LAYERS}


def lmm_part(name: str, parts: dict, device: str):
    """A context timing one part of a rank's work (wall s, peak GiB)."""
    import torch

    @contextlib.contextmanager
    def part():
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        if device != "cpu":
            torch.cuda.synchronize()
        parts[name] = (round(time.perf_counter() - t0, 2), round(
            torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else 0.0, 2))
        if device != "cpu":   # the ranks share one card: give it back
            torch.cuda.empty_cache()
    return part()


def lmm_prefill_decode(mesh, opts: dict, device: str, arch: str = LM_ARCH,
                       depth: dict | None = None):
    """``arch`` (cut to ``depth``) at f32 from seed 0 under its decode
    deployment's rules: prefill of ``LMM_B`` prompts (over random frames
    for the enc-dec family) and ``LMM_DECODE`` decode steps through
    ``build_prefill_step`` / ``build_decode_step``, on ``mesh`` or, with
    None, on one device; this rank's rows of the logits, (steps + 1, rows,
    V) on the host, their first row, and the shape of the cache's first
    leaf block (k, or an SSM's state)."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import placement
    from repro_torch.models.common import ShapeCfg
    from repro_torch.models.registry import get_bundle
    cfg = lmm_cfg(arch, opts, compute_dtype=torch.float32, **(depth or {}))
    bundle = get_bundle(cfg)
    dep = steps.deploy_for(arch, "decode_32k")
    rules = steps.rules_for_deploy(mesh, dep) if mesh is not None else None
    params = bundle.init(0, device=device)
    if mesh is not None:
        params = placement.shard_params(params, bundle.param_specs(rules),
                                        mesh)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(
        2, cfg.vocab, (LMM_B, LMM_PROMPT + LMM_DECODE)).astype(
            np.int32)).to(device)
    batch = {"tokens": toks[:, :LMM_PROMPT]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy((0.5 * rng.standard_normal(
            (LMM_B, cfg.encoder_ctx, cfg.d_model))).astype(np.float32)).to(
                device)
    pstep, _ = steps.build_prefill_step(
        bundle, mesh, rules, ShapeCfg("p", LMM_MAX_LEN, LMM_B, "prefill"), dep)
    dstep, _ = steps.build_decode_step(
        bundle, mesh, rules, ShapeCfg("d", LMM_MAX_LEN, LMM_B, "decode"), dep)
    cache, logits = pstep(params, batch)
    out = [logits.float()]
    for j in range(LMM_DECODE):
        at = LMM_PROMPT + j
        cache, logits = dstep(params, cache, toks[:, at:at + 1])
        out.append(logits.float())
    lead = "k" if "k" in cache else "ssm"
    if mesh is None:
        return torch.stack(out).cpu(), 0, tuple(cache[lead].shape)
    rows = placement.axes_of(cache.spec("length")[0])
    return (torch.stack(out).cpu(), mesh.index(rows) * out[0].shape[0],
            tuple(cache[lead].shape))


def lmm_train(mesh, opts: dict, device: str, seq: int, pod_manual=False,
              health=None, arch: str | None = None):
    """One ``build_train_step`` step of ``TRAIN_ARCH`` (f32 master, bf16
    compute, ``TRAIN_LAYERS`` layers, seed 0) on ``TRAIN_BATCH`` x ``seq``
    tokens (synthetic_batch step 0, seed 0) with the cell's deployment on
    ``mesh`` and the rules of ``launch.train``: (loss, params after the
    step, ef or None, the deployment). With ``arch``: that family's model
    cut to ``FAM_MESH_DEPTH`` under the rules of the cell's deployment
    (``steps.rules_for_deploy``), on ``mesh`` or, with None, on one
    device."""
    import dataclasses

    import torch
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import steps
    from repro_torch.models.common import ShapeCfg, rules_for_mesh
    from repro_torch.models.registry import get_bundle
    from repro_torch.training.compression import init_ef_state
    from repro_torch.training.trainer import init_train_state
    cfg = lmm_cfg(arch or TRAIN_ARCH, opts)
    if not opts.get("smoke"):
        cfg = cfg.replace(**(FAM_MESH_DEPTH[arch] if arch
                             else {"n_layers": TRAIN_LAYERS}))
    bundle = get_bundle(cfg)
    shape = ShapeCfg("train_4k", seq, TRAIN_BATCH, "train")
    dep = steps.resolve_deploy(steps.deploy_for(cfg.name, "train_4k"), shape,
                               mesh)
    if pod_manual:
        dep = dataclasses.replace(dep, compress_pods=True,
                                  straggler_masking=True)
    if arch is None:
        rules = rules_for_mesh(mesh)
    else:
        rules = (steps.rules_for_deploy(mesh, dep) if mesh is not None
                 else None)
    step, _, tcfg = steps.build_train_step(bundle, mesh, rules, dep)
    params, opt, _ = init_train_state(bundle, mesh, rules, tcfg, rng=0,
                                      device=device)
    batch = synthetic_batch(cfg, shape, step=0, seed=0, device=device)
    if pod_manual:
        ef = init_ef_state(params)
        params, opt, ef, m = step(params, opt, batch, ef,
                                  torch.tensor(health, device=device))
    else:
        params, opt, m = step(params, opt, batch)
        ef = None
    return float(m["loss"]), params, ef, dep


def lm_mesh_nccl_world(rank: int, carried: dict, opts: dict) -> dict:
    """(a) One NCCL rank on ``make_mesh_for_env``'s (data 1, model 1) mesh:
    ``LM_ARCH`` at full width served in bf16 (its decode deployment) by
    ``ServeEngine(mesh=)`` on the lm phase's requests, tokens equal to the
    lm phase's; the f32 prefill + decode that (b) is held against; a
    full-width train step on ``TRAIN_BATCH`` x 4096 tokens, its loss
    within ``LMM_LOSS_TOL`` of the train phase's first (unmeshed) step;
    the same step on ``LMM_TRAIN_SEQ``-token sequences for (b)."""
    import dataclasses

    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_mesh_for_env
    from repro_torch.models import placement
    from repro_torch.models.registry import get_bundle
    from repro_torch.serving import ServeConfig, ServeEngine
    device = lmm_setup(rank, opts)
    mesh = make_mesh_for_env()
    out, parts = {"mesh": dict(mesh.shape)}, {}

    with lmm_part("serve", parts, device):
        cfg = lmm_cfg(LM_ARCH, opts)
        dep = steps.deploy_for(LM_ARCH, "decode_32k")
        assert dep.serve_bf16 and not dep.fsdp, dep
        bundle = get_bundle(dataclasses.replace(cfg,
                                                param_dtype=torch.bfloat16))
        master = get_bundle(cfg).init(0, device=device)
        params = placement.shard_params(
            {k: v.to(torch.bfloat16) for k, v in master.items()},
            bundle.param_specs(steps.rules_for_deploy(mesh, dep)), mesh)
        del master

        def engine(reqs, n):
            eng = ServeEngine(bundle, params, ServeConfig(
                batch=LM_BATCH, max_len=LM_MAX_LEN, eos_id=-1), mesh=mesh)
            for i, p in enumerate(reqs):
                eng.submit(p, rid=i, max_tokens=n)
            return eng
        # a warm-up wave first (cuBLAS handles, the allocator)
        engine(lm_prompts(2, cfg.vocab, seed=9), 2).run()
        eng = engine(lm_prompts(LM_REQUESTS, cfg.vocab), LM_MAX_TOKENS)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = sorted((r.rid, list(r.out)) for r in done)
        out["serve"] = (wall, sum(len(o) for _, o in got), eng.prefills,
                        eng.decode_steps)
        want = carried.get("lm_tokens")
        if want is not None:
            diff = [(a[0], next(i for i, (x, y) in enumerate(zip(a[1], b[1]))
                                if x != y))
                    for a, b in zip(got, want) if a != b]
            assert not diff, (
                f"the meshed engine's tokens differ from the lm phase's "
                f"(request, first token): {diff}")
        del eng, params

    with lmm_part("prefill_decode", parts, device):
        out["logits"], _, out["cache_k"] = lmm_prefill_decode(
            mesh, opts, device, depth=lmm_depth(opts))
    with lmm_part("train_4096", parts, device):
        seq = 64 if opts.get("smoke") else 4096
        loss, params, _, dep = lmm_train(mesh, opts, device, seq)
        out["train_4096"] = (loss, dep.microbatches)
        want = carried.get("train_loss0")
        if want is not None:
            assert math.isclose(loss, want, rel_tol=LMM_LOSS_TOL), (loss,
                                                                    want)
        del params
    with lmm_part("train_short", parts, device):
        loss, params, _, dep = lmm_train(mesh, opts, device, LMM_TRAIN_SEQ
                                         if not opts.get("smoke") else 32)
        out["train_short"] = (loss, dep.microbatches)
        del params
    out["parts"] = parts
    out["launches"] = read_counters("lm_mesh path (nccl rank)", ())
    out["backend"] = torch.distributed.get_backend()
    zero_counters()
    out["fam"] = fam_mesh_one_rank(mesh, carried, opts, device)
    out["fam_launches"] = read_counters("families_mesh path (nccl rank)", ())
    return out


def fam_depth(arch: str, opts: dict) -> dict:
    return {} if opts.get("smoke") else FAM_MESH_DEPTH[arch]


def fam_mesh_one_rank(mesh, carried: dict, opts: dict, device: str) -> dict:
    """families_mesh (a), on the NCCL rank's (data 1, model 1) mesh: each
    of ``FAM_ARCHS`` at full width served in bf16 (its decode deployment)
    by ``ServeEngine(mesh=)`` on the families phase's requests, every
    token equal to that phase's (unmeshed) tokens; tokens/s, decode ms
    per step (CUDA events) and peak memory. Then what (b) is held
    against, without a mesh: each family cut to ``FAM_MESH_DEPTH``, the
    f32 prefill + decode logits and a train step's loss."""
    import dataclasses

    import torch
    from repro_torch.launch import steps
    from repro_torch.models import placement
    from repro_torch.models.registry import get_bundle
    out = {}
    for arch in FAM_ARCHS:
        parts = {}
        with lmm_part("serve", parts, device):
            cfg = lmm_cfg(arch, opts)
            dep = steps.deploy_for(arch, "decode_32k")
            assert dep.serve_bf16 and not dep.fsdp, dep
            bundle = get_bundle(dataclasses.replace(
                cfg, param_dtype=torch.bfloat16))
            master = get_bundle(cfg).init(SEED, device=device)
            params = placement.shard_params(
                {k: v.to(torch.bfloat16) for k, v in master.items()},
                bundle.param_specs(steps.rules_for_deploy(mesh, dep)), mesh)
            del master
            lm_serve(bundle, params, lm_prompts(2, cfg.vocab, seed=9), 2,
                     f"{arch} warm-up", mesh=mesh)
            eng, wall, pre_ms, dec_ms = lm_serve(
                bundle, params, lm_prompts(LM_REQUESTS, cfg.vocab),
                LM_MAX_TOKENS, arch, mesh=mesh)
            got = sorted((r.rid, list(r.out)) for r in eng.finished)
            want = carried.get("fam_tokens", {}).get(arch)
            if want is not None:
                diff = [(a[0], next(i for i, (x, y) in enumerate(
                    zip(a[1], b[1])) if x != y))
                    for a, b in zip(got, want) if a != b]
                assert not diff, (
                    f"{arch}: the meshed engine's tokens differ from the "
                    f"families phase's (request, first token): {diff}")
            del eng, params
        with lmm_part("reference", parts, device):
            logits, _, _ = lmm_prefill_decode(None, opts, device, arch,
                                              fam_depth(arch, opts))
            loss, params, _, dep = lmm_train(
                None, opts, device, FAM_MESH_SEQ, arch=arch)
            del params
        out[arch] = {"serve": (wall, sum(len(o) for _, o in got), pre_ms,
                               dec_ms, want is not None),
                     "logits": logits, "loss": (loss, dep.microbatches),
                     "parts": parts}
    return out


def lm_mesh_gloo_world(rank: int, opts: dict) -> dict:
    """(b) Four gloo ranks that all name one card: the dense f32 prefill +
    decode on (data 2, model 2), a train step on (data 2, model 2), the
    pod-manual step (int8 error feedback, straggler masking) on (pod 2,
    model 2), and the MoE layer through expert parallelism on (data 2,
    model 2) against the dense reference; each part timed, with this
    rank's peak memory."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.launch.mesh import build_mesh, make_debug_mesh
    from repro_torch.models import placement
    from repro_torch.models.moe import (EXPERT_LEAVES, moe_ffn_ep,
                                        moe_ffn_reference)
    from repro_torch.models.registry import get_bundle
    from repro_torch.training import trainer
    device = lmm_setup(rank, opts)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    pods = build_mesh((2, 2), ("pod", "model"))
    out, parts = {}, {}

    with lmm_part("prefill_decode", parts, device):
        out["logits"], out["row0"], out["cache_k"] = lmm_prefill_decode(
            mesh, opts, device, depth=lmm_depth(opts))

    with lmm_part("train", parts, device):
        seq = LMM_TRAIN_SEQ if not opts.get("smoke") else 32
        loss, params, _, dep = lmm_train(mesh, opts, device, seq)
        out["train"] = (loss, dep.microbatches)
        del params

    with lmm_part("pod_manual", parts, device):
        worst = []
        real = trainer.compressed_psum

        def checked(grads, ef, group, n, **kw):
            """The step's own compressed_psum, then ef = g - deq: (g -
            ef) / scale is this pod's int8 payload, and the payloads' sum
            over the pods times the scale, over the pods, is the mean the
            step uses (one leaf at a time: collective)."""
            mean, ef_out = real(grads, ef, group, n, **kw)
            err = 0.0
            for k in sorted(grads):
                g = grads[k].float() + ef[k]
                scale = placement.reduce(
                    g.abs().max().clamp_min(1e-12) / 127.0, pods,
                    pods.axis_names, torch.distributed.ReduceOp.MAX)
                q = (g - ef_out[k]) / scale
                assert bool(((q - q.round()).abs() < 1e-3).all()) and bool(
                    (q.round().abs() <= 127).all()), k
                deq = placement.reduce(q.round().to(torch.int32), pods, "pod")
                want = deq.float() * scale / n
                err = max(err, float((mean[k] - want).abs().max()
                                     / want.abs().max().clamp_min(1e-30)))
            worst.append(err)
            return mean, ef_out
        trainer.compressed_psum = checked
        try:
            loss, params, ef, _ = lmm_train(pods, opts, device, seq, True,
                                            LMM_HEALTH)
        finally:
            trainer.compressed_psum = real
        assert len(worst) == 1 and worst[0] <= 1e-6, worst
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        digest = hashlib.sha256()
        for k, v in sorted(placement.gather_params(params).items()):
            digest.update(v.cpu().numpy().tobytes())
        out["pod"] = (loss, digest.hexdigest(), worst[0])
        del params, ef

    with lmm_part("moe", parts, device):
        cfg = lmm_cfg(LM_MOE_ARCH, opts, n_layers=LMM_MOE_LAYERS,
                      compute_dtype=torch.float32)
        full = get_bundle(cfg).init(0, device=device)
        lp = {k[len("layers/"):]: v[0] for k, v in full.items()
              if k.startswith("layers/")}
        del full
        n_ep, m = mesh.size("model"), mesh.index("model")
        e_local = lp["router"].shape[-1] // n_ep
        local = {k: v.narrow(0, m * e_local, e_local)
                 if k in EXPERT_LEAVES else v for k, v in lp.items()}
        x = torch.from_numpy((0.5 * np.random.default_rng(6).standard_normal(
            LMM_MOE_X + (cfg.d_model,))).astype(np.float32)).to(device)
        b_l = x.shape[0] // mesh.size("data")
        rows = slice(mesh.index("data") * b_l, (mesh.index("data") + 1) * b_l)
        c8 = cfg.replace(capacity_factor=LMM_MOE_CF)
        with torch.no_grad():
            y, aux = moe_ffn_ep(local, x[rows], c8, mesh, bat=("data",))
            y_ref, aux_ref = moe_ffn_reference(lp, x, c8)
            err = float((y - y_ref[rows]).abs().max())
            assert torch.allclose(y, y_ref[rows], rtol=LMM_MOE_TOL,
                                  atol=LMM_MOE_TOL), err
            assert math.isclose(float(aux), float(aux_ref),
                                rel_tol=LMM_AUX_TOL), (float(aux),
                                                       float(aux_ref))
            drops = {}
            moe_ffn_ep(local, x[rows], cfg, mesh, bat=("data",), drops=drops)
        out["moe"] = (err, float(aux), float(aux_ref), e_local, drops,
                      cfg.n_experts, lp["router"].shape[-1])
        del lp, local
    out["parts"] = parts
    out["launches"] = read_counters(f"lm_mesh path (gloo rank {rank})", ())
    zero_counters()
    out["fam"] = {}
    for arch in FAM_ARCHS:
        fparts = {}
        with lmm_part("prefill_decode", fparts, device):
            logits, row0, lead = lmm_prefill_decode(
                mesh, opts, device, arch, fam_depth(arch, opts))
        with lmm_part("train", fparts, device):
            loss, params, _, dep = lmm_train(mesh, opts, device,
                                             FAM_MESH_SEQ, arch=arch)
            del params
        out["fam"][arch] = {"logits": logits, "row0": row0, "lead": lead,
                            "loss": (loss, dep.microbatches),
                            "parts": fparts}
    out["fam_launches"] = read_counters(
        f"families_mesh path (gloo rank {rank})", ())
    return out


def phase_lm_mesh(opts: dict | None = None) -> dict:
    """The LM on a mesh (ROADMAP A15f): (a) one NCCL rank, (b) four gloo
    ranks on the one card (NCCL cannot put two ranks on one card). Four
    ranks on one card check correctness and host overhead, not scaling:
    every collective of (b) stages through the host. No GSON kernel runs
    on this path: every counter of every rank reads 0. Returns the path's
    launches."""
    from repro_torch.core.gson.distributed import run_world
    opts = opts or {"device": LM_DEVICE}
    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    backend = "gloo" if opts["device"] == "cpu" else "nccl"
    t0 = time.perf_counter()
    (a,) = run_world(lm_mesh_nccl_world, 1, (CARRIED, opts), backend=backend,
                     timeout_s=600)
    t_a = time.perf_counter() - t0
    wall, toks, waves, dsteps = a["serve"]
    log(f"lm_mesh (a): 1 {a['backend']} rank, make_mesh_for_env's mesh "
        f"{a['mesh']}, world {t_a:.1f} s: {LM_ARCH} served in bf16 by "
        f"ServeEngine(mesh=) on the lm phase's {LM_REQUESTS} requests x "
        f"{LM_MAX_TOKENS} tokens ({waves} waves, {dsteps} decode steps): "
        f"{toks} tokens in {wall:.3f} s = {toks / wall:.1f} tokens/s, every "
        f"token equal to the lm phase's (unmeshed) "
        f"{'(asserted)' if 'lm_tokens' in CARRIED else '(not run)'}; a train "
        f"step on {TRAIN_BATCH} x 4096 tokens ({TRAIN_LAYERS} layers, "
        f"{a['train_4096'][1]} microbatches): loss {a['train_4096'][0]:.7f} against the train "
        f"phase's {CARRIED.get('train_loss0', float('nan')):.7f} (rel tol "
        f"{LMM_LOSS_TOL}); parts (wall s, peak GiB) {a['parts']}  [{card}]")
    t0 = time.perf_counter()
    ranks = run_world(lm_mesh_gloo_world, 4, (opts,), timeout_s=900)
    t_b = time.perf_counter() - t0
    # the f32 prefill + decode: each rank's rows against (a)'s
    ref = a["logits"]
    worst, clear, same = 0.0, 0, 0
    for r, x in enumerate(ranks):
        want = ref[:, x["row0"]:x["row0"] + x["logits"].shape[1]]
        worst = max(worst, float((x["logits"] - want).abs().max()))
        top2 = want.topk(2, dim=-1).values
        ok = (top2[..., 0] - top2[..., 1]) > 2 * LMM_LOGIT_TOL
        eq = x["logits"].argmax(-1) == want.argmax(-1)
        assert bool(eq[ok].all()), f"rank {r}: greedy tokens differ"
        clear += int(ok.sum())
        same += int(eq.sum())
    assert worst <= LMM_LOGIT_TOL, f"(b) prefill + decode {worst} from (a)"
    n_rows = sum(int(x["logits"][..., 0].numel()) for x in ranks)
    loss_a, loss_b = a["train_short"][0], ranks[0]["train"][0]
    assert all(x["train"][0] == loss_b for x in ranks)
    assert math.isclose(loss_b, loss_a, rel_tol=LMM_LOSS_TOL), (loss_b,
                                                                loss_a)
    pods = {x["pod"][1] for x in ranks}
    assert len(pods) == 1, "the pod-manual step's parameters differ"
    err, aux, aux_ref, e_local, _, n_exp, e_pad = ranks[0]["moe"]
    drops = {k: sum(x["moe"][4][k] for x in ranks)
             for k in ("routed", "dropped_send", "dropped_expert")}
    log(f"lm_mesh (b): 4 gloo ranks on {opts['device']}, world {t_b:.1f} s "
        f"(collectives staged through the host: correctness and host "
        f"overhead, not scaling); {LM_ARCH} ({TRAIN_LAYERS} layers at full "
        f"width) f32 prefill + {LMM_DECODE} decode "
        f"steps, B = {LMM_B}, on (data 2, model 2), the cache's k block "
        f"{ranks[0]['cache_k']} (seq over model; (a): {a['cache_k']}): max "
        f"|diff| from (a) {worst:.3g} (tol {LMM_LOGIT_TOL}), greedy tokens "
        f"equal on {same} of {n_rows} rows ({clear} with a top-2 margin over "
        f"{2 * LMM_LOGIT_TOL}, all equal)  [{card}]")
    log(f"lm_mesh (b): {TRAIN_ARCH} ({TRAIN_LAYERS} layers at full width, "
        f"as the train phase's) train step on (data 2, model 2), "
        f"{TRAIN_BATCH} x {LMM_TRAIN_SEQ} tokens (sequences cut from 4096), "
        f"{ranks[0]['train'][1]} microbatches: loss {loss_b:.7f} against (a)'s "
        f"{loss_a:.7f} ({a['train_short'][1]} microbatches; rel tol "
        f"{LMM_LOSS_TOL}); pod-manual step on (pod 2, model 2), "
        f"int8 error feedback and straggler masking, "
        f"health {list(LMM_HEALTH)}: loss "
        f"{ranks[0]['pod'][0]:.7f}, parameters finite and bitwise alike on "
        f"all 4 ranks, ef = g - deq on every rank (the payload sum within "
        f"{max(x['pod'][2] for x in ranks):.3g} of the step's mean)")
    log(f"lm_mesh (b): {LM_MOE_ARCH} at full width, {LMM_MOE_LAYERS} layers, "
        f"f32, expert parallelism over model = 2 ({e_local} of {e_pad} padded "
        f"experts per rank, {n_exp} real): layer 0 on x {LMM_MOE_X} within "
        f"{err:.3g} of the dense reference at capacity_factor {LMM_MOE_CF} "
        f"(tol {LMM_MOE_TOL}), aux {aux:.6f} / {aux_ref:.6f} (rel tol "
        f"{LMM_AUX_TOL}); at the config's capacity_factor: {drops['routed']} "
        f"assignments, {drops['dropped_send']} dropped at dispatch, "
        f"{drops['dropped_expert']} at the experts")
    for r, x in enumerate(ranks):
        log(f"  gloo rank {r}: parts (wall s, peak GiB) {x['parts']}")
    launches = Counter(a["launches"])
    for x in ranks:
        launches.update(x["launches"])
    assert all(n == 0 for n in launches.values()), (
        f"GSON kernels launched on the lm_mesh path: {dict(launches)}")
    log(f"lm_mesh path launches: {dict(launches)} (none of the GSON "
        f"kernels, on any rank)  [{card}]")
    fam = families_mesh_report(a, ranks, opts, card)
    log(f"lm_mesh phase (with families_mesh) "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"lm_mesh": {k: launches[k] for k in a["launches"]},
            "families_mesh": fam}


def families_mesh_report(a: dict, ranks: list, opts: dict, card: str) -> dict:
    """The families_mesh checks and lines: (a)'s serving; (b)'s logits
    against (a)'s unmeshed ones (within ``LMM_LOGIT_TOL``, greedy tokens
    equal) and its train losses against (a)'s (``LMM_LOSS_TOL``); every
    counter of every rank 0; (c) the dry run's residency of the cells
    this script ran beside their measured peaks. Returns the path's
    launches."""
    for arch in FAM_ARCHS:
        wall, toks, pre_ms, dec_ms, asserted = a["fam"][arch]["serve"]
        log(f"families_mesh (a): {arch} at full width served in bf16 by "
            f"ServeEngine(mesh=) on make_mesh_for_env's {a['mesh']} "
            f"({a['backend']}), the families phase's {LM_REQUESTS} requests "
            f"x {LM_MAX_TOKENS} tokens: {toks} tokens in {wall:.3f} s = "
            f"{toks / wall:.1f} tokens/s, prefill {pre_ms:.3f} ms per wave, "
            f"decode {dec_ms:.3f} ms per step (CUDA events), every token "
            f"equal to the families phase's "
            f"{'(asserted)' if asserted else '(not run)'}; parts (wall s, "
            f"peak GiB) {a['fam'][arch]['parts']}  [{card}]")
    for arch in FAM_ARCHS:
        ref = a["fam"][arch]["logits"]
        worst, clear, same, n_rows = 0.0, 0, 0, 0
        for r, x in enumerate(ranks):
            f = x["fam"][arch]
            want = ref[:, f["row0"]:f["row0"] + f["logits"].shape[1]]
            worst = max(worst, float((f["logits"] - want).abs().max()))
            top2 = want.topk(2, dim=-1).values
            ok = (top2[..., 0] - top2[..., 1]) > 2 * LMM_LOGIT_TOL
            eq = f["logits"].argmax(-1) == want.argmax(-1)
            assert bool(eq[ok].all()), f"{arch} rank {r}: greedy tokens differ"
            clear += int(ok.sum())
            same += int(eq.sum())
            n_rows += int(eq.numel())
        assert worst <= LMM_LOGIT_TOL, (
            f"families_mesh (b) {arch}: prefill + decode {worst} from the "
            "unmeshed run")
        loss_a, mb_a = a["fam"][arch]["loss"]
        loss_b, mb_b = ranks[0]["fam"][arch]["loss"]
        assert all(x["fam"][arch]["loss"][0] == loss_b for x in ranks)
        assert math.isfinite(loss_b) and math.isclose(
            loss_b, loss_a, rel_tol=LMM_LOSS_TOL), (arch, loss_b, loss_a)
        depth = ", ".join(f"{k} {v}" for k, v in fam_depth(
            arch, opts).items()) or "smoke"
        log(f"families_mesh (b): {arch} ({depth}, full width) on 4 gloo "
            f"ranks, (data 2, model 2): f32 prefill of {LMM_B} x "
            f"{LMM_PROMPT} tokens + {LMM_DECODE} decode steps, the cache's "
            f"{'ssm' if arch == 'mamba2-2.7b' else 'k'} "
            f"block {ranks[0]['fam'][arch]['lead']}: max |diff| from the "
            f"unmeshed run {worst:.3g} (tol {LMM_LOGIT_TOL}), greedy tokens "
            f"equal on {same} of {n_rows} rows ({clear} with a top-2 margin "
            f"over {2 * LMM_LOGIT_TOL}, all equal); train step on "
            f"{TRAIN_BATCH} x {FAM_MESH_SEQ} tokens ({mb_b} microbatches): "
            f"loss {loss_b:.7f} against the unmeshed step's {loss_a:.7f} "
            f"({mb_a} microbatches; rel tol {LMM_LOSS_TOL})  [{card}]")
    for r, x in enumerate(ranks):
        log(f"  gloo rank {r} families: " + "; ".join(
            f"{arch} {x['fam'][arch]['parts']}" for arch in FAM_ARCHS))
    launches = Counter(a["fam_launches"])
    for x in ranks:
        launches.update(x["fam_launches"])
    assert all(n == 0 for n in launches.values()), (
        f"GSON kernels launched on the families_mesh path: {dict(launches)}")
    log(f"families_mesh path launches: {dict(launches)} (none of the GSON "
        f"kernels, on any rank)")
    dryrun_report(opts, card)
    return {k: launches[k] for k in a["fam_launches"]}


def dryrun_report(opts: dict, card: str) -> None:
    """families_mesh (c): ``launch.dryrun``'s per-rank residency, step
    FLOPs and roofline terms for the cells this script ran on one card
    (the train phase's ``TRAIN_BATCH`` x 4096 step and the lm phase's
    decode step at B = ``LM_BATCH``, f32 master), beside their measured
    peaks and times, and the card's memory beside ``HBM_PER_CARD``."""
    import torch
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import HBM_PER_CARD
    from repro_torch.models.common import ShapeCfg
    train_cfg = lmm_cfg(TRAIN_ARCH, opts)
    lm_cfg = lmm_cfg(LM_ARCH, opts)
    seq = 64 if opts.get("smoke") else 4096
    if not opts.get("smoke"):
        train_cfg = train_cfg.replace(n_layers=TRAIN_LAYERS)
    cells = (
        ("train", train_cfg, ShapeCfg("train_4k", seq, TRAIN_BATCH, "train"),
         None, CARRIED.get("train_peak"), CARRIED.get("train_ms")),
        ("lm decode", lm_cfg, ShapeCfg("decode", LM_MAX_LEN, LM_BATCH,
                                       "decode"),
         steps.DeployCfg(fsdp=False), CARRIED.get("lm_peak"), None))
    for tag, cfg, shape, dep, peak, ms in cells:
        t0 = time.perf_counter()
        row = dryrun.run_cell(cfg, shape.name, None,
                              shapes={shape.name: shape}, dep=dep)
        res = row["residency"]
        parts = ", ".join(f"{k} {v / 2**30:.2f}" for k, v in res.items()
                          if k != "total")
        measured = (f"{peak / 2**30:.2f} GiB measured" if peak
                    else "not run")
        timing = ""
        if ms:
            step_ms = sum(ms) / len(ms)
            timing = (f"; t_compute {row['t_compute'] * 1e3:.1f} ms, "
                      f"t_memory {row['t_memory'] * 1e3:.1f} ms against "
                      f"{step_ms:.1f} ms measured per step")
        log(f"dryrun {tag}: {cfg.name} ({cfg.n_layers} layers), "
            f"{shape.global_batch} x {shape.seq_len}, one card: residency "
            f"{res['total'] / 2**30:.2f} GiB ({parts}) against the phase's "
            f"peak {measured}; step FLOPs {row['step_flops']:.4g} "
            f"(FlopCounterMode on meta, counted in "
            f"{time.perf_counter() - t0:.1f} s){timing}; HBM_PER_CARD "
            f"{HBM_PER_CARD} against the card's "
            f"{torch.cuda.get_device_properties(0).total_memory if opts['device'] != 'cpu' else 'not measured'}"
            f"  [{card}]")


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
        if wrapper in PER_REFRESH:
            continue
        assert all(per_it[o] == 1 for o in names), (
            f"{wrapper} at B={FLEET_B}: {[per_it[o] for o in names]} "
            f"launches of {names} per fleet iteration, expected 1 each")
    log(f"  the port's device launches per fleet iteration at "
        f"B={FLEET_B}: {per_it} (one of each for the whole batch; the "
        f"ladder kernel's one per refresh)")
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
    seconds = {}

    def timed(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[fn.__name__[len("phase_"):]] = round(
            time.perf_counter() - t, 1)
        return out

    try:
        timed(phase_environment)
        timed(phase_build)
        results = timed(phase_kernels)
        refresh = timed(phase_refresh)
        launches, multi_rate = timed(phase_main_path)
        timed(phase_paired_timing)
        timed(phase_fleet_kernels)
        fleet = timed(phase_fleet)
        timed(phase_checkpoint)
        timed(phase_slab_kernels)
        paths = {"main": launches,
                 "fleet": {k: sum(f[2][SHARED.get(k, k)]
                                  for f in fleet.values()) for k in launches},
                 "sparse": timed(phase_sparse_session),
                 "auto": timed(phase_auto),
                 "single": timed(phase_single, multi_rate),
                 "ann": timed(phase_ann)}
        paths["paper"], paper, paper_capacity = timed(phase_paper)
        paths["serve"] = timed(phase_serve,
                               {v: f[:2] for v, f in fleet.items()})
        paths.update(timed(phase_mesh))
        timed(phase_c2)
        paths.update(timed(phase_lm))
        paths.update(timed(phase_families))
        paths.update(timed(phase_train))
        paths.update(timed(phase_lm_mesh))
        timed(phase_profile)
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
        "paths": {path: n.get(name, 0) for path, n in paths.items()},
        **({"shapes": r["shapes"]} if "shapes" in r else {}),
        "paper": {"capacity": paper_capacity, "launches": paths["paper"][name],
                  "ms": paper[name]["ms"], "plain_ms": paper[name]["plain_ms"],
                  "bound_ms": paper[name]["bound"],
                  "max_abs_err": paper[name]["err"]},
    } for name, r in results.items()]
    kernels.append({
        "name": "topo_states", "route": "cuda",
        "source": str(_build.SOURCES["topo_states"].relative_to(ROOT)),
        "replaces": None, "launches": launches["topo_states"],
        "paths": {path: n.get("topo_states", 0) for path, n in paths.items()},
        "shapes": refresh,
    })
    log(f"phase seconds: {seconds}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
