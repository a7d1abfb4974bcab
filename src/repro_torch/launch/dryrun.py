"""Dry run of every (arch x shape x mesh) cell of the port, on the CPU
with no process group (``repro.launch.dryrun``'s counterpart).

For each cell it reports, for rank 0 of the production layouts (data 16,
model 16) and (pod 2, data 16, model 16), as ``launch/roofline.py``
computes them on the card's numbers:

* the bytes a rank holds (parameters, moments, gradient accumulator,
  cache, what it gathers and its activations), from the specs through
  ``placement.block``, against the card's memory; beside it JAX's
  analytic budget;
* the step's FLOPs (``roofline.step_flops``: the unsharded step on the
  ``meta`` device under ``FlopCounterMode``) and a rank's share of them,
  which under the port's realization is the step's over the batch
  shards (the compute is replicated over the other axes), not over the
  chips;
* the collective bytes of a rank's step from the specs
  (``roofline.mesh_collectives``);
* ``RooflineCell.row()``.

The mesh is an ``LMMesh`` built from the axis sizes and rank 0's
coordinates, with no groups: nothing runs on it, its blocks are read.
The JAX dry run lowers and compiles each cell through XLA; the port has
no compiler to ask, so a cell here proves that its specs divide its
tensors and that the unsharded step runs at its shapes on ``meta``.

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  python -m repro_torch.launch.dryrun --mesh single    # (data 16, model 16)
  python -m repro_torch.launch.dryrun --gson           # the paper's engine
  python -m repro_torch.launch.dryrun --out .runs/dryrun   # JSON per cell

The exit code is non-zero if any attempted cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import HBM_PER_CARD, LMMesh
from repro_torch.models.common import SHAPES
from repro_torch.models.registry import get_bundle
from repro_torch.utils import tree_bytes, tree_param_count

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {"single_pod_16x16": ((16, 16), ("data", "model")),
          "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def sized_mesh(shape, axes, rank: int = 0) -> LMMesh:
    """An ``LMMesh`` of ``shape`` over ``axes`` seen from ``rank``, with no
    process group: for reading blocks, not for running collectives."""
    import numpy as np
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    return LMMesh(tuple(axes), dict(zip(axes, shape)), coords, {})


def mesh_name(mesh) -> str:
    if mesh is None:
        return "one_device"
    return "_".join(f"{a}{n}" for a, n in mesh.shape.items())


_FLOPS: dict = {}


def _step_flops(bundle, shape) -> int:
    """``roofline.step_flops``, once per (config, shape) in a process."""
    key = (repr(bundle.cfg), shape)
    if key not in _FLOPS:
        _FLOPS[key] = rl.step_flops(bundle, shape)
    return _FLOPS[key]


def run_cell(cfg, shape_name: str, mesh, name: str | None = None,
             shapes: dict | None = None, dep=None,
             quiet: bool = True) -> dict:
    """One cell's row: ``cfg`` at ``shapes[shape_name]`` on ``mesh`` (an
    ``LMMesh``, or None for one device) under the cell's deployment (or
    ``dep``), seen from the mesh's rank."""
    shapes = shapes or SHAPES
    shape = shapes[shape_name]
    name = name or mesh_name(mesh)
    dep0 = dep or steps.deploy_for(cfg.name, shape_name)
    if dep0.serve_bf16 and shape.kind in ("prefill", "decode"):
        cfg = cfg.replace(param_dtype=torch.bfloat16)
    ok, why = steps.applicable(cfg, shape_name)
    if not ok:
        return {"arch": cfg.name, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": why}
    t0 = time.time()
    dep = steps.resolve_deploy(dep0, shape, mesh)
    rules = steps.rules_for_deploy(mesh, dep) if mesh is not None else None
    bundle = get_bundle(cfg)
    pshapes = bundle.param_shapes()
    n_params = tree_param_count(pshapes)
    n_active = rl.active_param_count(cfg, pshapes)
    chips = mesh.n if mesh is not None else 1

    flops = _step_flops(bundle, shape)
    b = shape.global_batch
    if shape.kind == "train":
        b_mb = b // max(dep.microbatches, 1)
        rows, bat = rl.rows_per_rank(mesh, rules.batch_axes if rules else (),
                                     b_mb)
        shards = b_mb // rows
    else:
        bat = steps.batch_axes_for(mesh, b) if mesh is not None else ()
        shards = mesh.size(bat) if mesh is not None else 1
    flops_rank = flops / shards

    cache_b = 0
    if shape.kind in ("prefill", "decode"):
        cache_b = tree_bytes(bundle.cache_shapes(b, shape.seq_len))
    mem_bytes = rl.analytic_memory_bytes(
        cfg, shape, n_params, chips, microbatches=dep.microbatches,
        param_bytes=tree_bytes(pshapes), cache_bytes=cache_b)
    sizes = steps.axis_sizes(mesh)
    bat_prod = 1
    for a in ("pod", "data") + (("model",) if dep.tp == "none" else ()):
        if a in sizes and (b * shape.seq_len) % (bat_prod * sizes[a]) == 0:
            bat_prod *= sizes[a]
    act_shards = bat_prod * (sizes.get("model", 1) if dep.seq_shard else 1)
    opt_b = 8 * n_params if dep.optimizer == "adamw" else n_params // 4
    analytic = rl.analytic_residency_bytes(
        cfg, shape, n_params, chips, param_bytes=tree_bytes(pshapes),
        opt_bytes=opt_b, cache_bytes=cache_b,
        microbatches=dep.microbatches, act_shards=max(act_shards, 1),
        accum_bytes_per_param=2 if dep.accum_dtype == "bf16" else 4)
    residency = rl.rank_residency(bundle, shape, mesh, rules, dep,
                                  dep.optimizer)
    coll = rl.mesh_collectives(bundle, shape, mesh, rules, dep)
    coll_rank = sum(v[0] for v in coll.values())

    cell = rl.RooflineCell(
        arch=cfg.name, shape=shape_name, mesh=name, chips=chips,
        flops=flops_rank * chips, hbm_bytes=mem_bytes,
        coll_bytes=coll_rank * chips,
        coll_detail={"bytes": {k: v[0] for k, v in coll.items()},
                     "counts": {k: v[1] for k, v in coll.items()}},
        model_flops=rl.model_flops(cfg, shape, n_active),
        bytes_per_device=residency["total"],
        notes=(f"flops per rank = the unsharded step's {flops:.4g} over "
               f"its {shards} batch shards {tuple(bat)} (compute "
               f"replicated over the other axes), not over the {chips} "
               "chips" + ("; MoE: the dense reference path's count"
                          if cfg.family == "moe" else "")))
    row = cell.row()
    row.update({
        "status": "ok", "n_params": n_params, "n_params_active": n_active,
        "step_flops": flops, "flops_per_rank": flops_rank,
        "batch_shards": shards, "residency": residency,
        "fits_hbm": residency["total"] <= HBM_PER_CARD,
        "residency_analytic": analytic,
        "fits_hbm_analytic": analytic["total"] <= HBM_PER_CARD,
        "hbm_per_card": HBM_PER_CARD,
        "coll_bytes_per_rank": coll_rank,
        "deploy": {"microbatches": dep.microbatches, "tp": dep.tp,
                   "fsdp": dep.fsdp, "seq_shard": dep.seq_shard,
                   "optimizer": dep.optimizer,
                   "accum_dtype": dep.accum_dtype},
        "t_count_s": round(time.time() - t0, 1),
    })
    if not quiet:
        print(f"    rank mem {residency['total'] / 2**30:7.2f} GiB "
              f"(fits {row['fits_hbm']})  flops/rank {flops_rank:.3e}  "
              f"coll/rank {coll_rank / 2**20:.1f} MiB  bottleneck "
              f"{cell.bottleneck}  roofline_frac {cell.roofline_frac:.3f}",
              flush=True)
    return row


def _state_bytes(capacity: int, dim: int, max_deg: int) -> int:
    """The bytes of one ``NetworkState``: w (C, d) f32, active (C,) bool,
    nbr (C, K) i32, age (C, K) f32, five (C,) f32/i32 fields and five
    i32 scalars."""
    return capacity * (4 * dim + 1 + 8 * max_deg + 5 * 4) + 5 * 4


def run_gson(mesh, name: str) -> dict:
    """The paper's distributed multi-signal step
    (``core.gson.distributed.make_distributed_step``, the world as its
    group) under both strategies on ``mesh``'s ranks: per-rank state and
    signal bytes and the step's collectives; and the network mesh's
    fleet (one network per rank) per tick and per health screen."""
    from repro_torch.configs.soam_paper import CAPACITY, DIM, MAX_DEG, config
    n = mesh.n
    m = config.max_parallel
    state = _state_bytes(CAPACITY, DIM, MAX_DEG)
    out = {}
    for strategy in ("data", "network"):
        if strategy == "data":
            # signals split, state and Update replicated; one all_gather
            # of the (4, m) int32 words (ids, distances) per step
            sig = m // n * DIM * 4
            coll = {"all-gather": (4 * m * 4, 1)}
            divides = m % n == 0
        else:
            # the unit pool cut in C/n slices, every rank all signals; one
            # all_gather of the (2, m, 2n) candidate words per step
            sig = m * DIM * 4
            coll = {"all-gather": (2 * m * 2 * n * 4, 1)}
            divides = CAPACITY % n == 0
        out[strategy] = {
            "status": "ok" if divides else "failed", "mesh": name,
            "ranks": n, "m": m, "capacity": CAPACITY,
            "state_bytes_per_rank": state, "signal_bytes_per_rank": sig,
            "collectives_per_step": {k: {"bytes": v[0], "count": v[1]}
                                     for k, v in coll.items()},
        }
        print(f"  gson[{strategy:7s}] {name}: state/rank "
              f"{state / 2**20:.2f} MiB, coll/step "
              f"{coll['all-gather'][0] / 2**10:.1f} KiB")
    out["network_mesh_fleet"] = {
        "status": "ok", "mesh": name, "networks": n,
        "state_bytes_per_rank": state,
        "collectives_per_iteration": {},
        "collectives_per_tick": {"all-gather": {"bytes": 6 * n * 8,
                                                "count": 1}},
        "collectives_per_screen": {"all-gather": {"bytes": 2 * n * 8,
                                                  "count": 1}},
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, choices=SHAPE_NAMES)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--gson", action="store_true",
                    help="dry-run the paper's GSON distributed step only")
    ap.add_argument("--out", default=".runs/dryrun")
    args = ap.parse_args(argv)

    meshes = [(k, sized_mesh(*v)) for k, v in MESHES.items()
              if args.mesh == "both" or k.startswith(args.mesh)]
    os.makedirs(args.out, exist_ok=True)
    failures = 0

    if args.gson:
        for name, mesh in meshes:
            res = run_gson(mesh, name)
            failures += sum(r["status"] != "ok" for r in res.values())
            with open(os.path.join(args.out, f"gson_{name}.json"), "w") as f:
                json.dump(res, f, indent=1)
        return 1 if failures else 0

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPE_NAMES)
    for name, mesh in meshes:
        for arch in archs:
            for shape in shapes:
                print(f"[dryrun] {arch} x {shape} x {name}", flush=True)
                try:
                    row = run_cell(get_config(arch), shape, mesh, name,
                                   quiet=False)
                except Exception:  # noqa: BLE001 — recorded, counted
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape, "mesh": name,
                           "status": "failed",
                           "error": traceback.format_exc(limit=3)}
                    failures += 1
                fn = f"{arch}__{shape}__{name}.json".replace("/", "_")
                with open(os.path.join(args.out, fn), "w") as f:
                    json.dump(row, f, indent=1, default=str)
                if row["status"] == "skipped":
                    print(f"    skipped: {row['reason']}")
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
