"""End-to-end surface reconstruction with the PyTorch/CUDA port.

  PYTHONPATH=src python examples/torch_surface_reconstruction.py \
      --surface eight --variant multi --iters 1500 --out eight.obj

  # on a host without a card, e.g. the approximate grid search:
  PYTHONPATH=src python examples/torch_surface_reconstruction.py \
      --device cpu --backend ann-grid --iters 50

  # N surfaces at once, one batched program, one mesh each:
  PYTHONPATH=src python examples/torch_surface_reconstruction.py \
      --fleet 4 --variant multi-fused --iters 800 --out meshes.obj

The twin of ``examples/surface_reconstruction.py`` (the JAX package),
built on ``repro_torch.gson``: the run is a ``RunSpec`` whose variant /
model / sampler / backend are names resolved through the registries
(``--variant`` and ``--backend`` list what is registered, the sequential
baselines ``single`` and ``indexed`` and the approximate searches
``ann-windowed`` / ``ann-grid`` / ``indexed`` included), driven by a
streaming ``gson.Session`` (or ``gson.FleetSession`` with ``--fleet``):

  * progress rows print as convergence checks complete;
  * ``--checkpoint-dir`` snapshots the run every ``--checkpoint-every``
    iterations; re-running with ``--resume`` continues from the newest
    snapshot with the same signal stream.

After the run each topology is checked (Euler characteristic against the
surface's genus) and optionally exported as a Wavefront .obj. Runs go on
the card unless ``--device cpu``. There is no ``--mesh``: sharding over
several devices is not ported yet.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch import gson
from repro_torch.core.gson import metrics

GENUS = {"sphere": 0, "torus": 1, "eight": 2, "trefoil": 1}
THRESH = {"sphere": 0.35, "torus": 0.25, "eight": 0.22, "trefoil": 0.12}


def export_obj(state, path: str):
    """The active units as vertices and the 3-cliques as faces."""
    nbr = state.nbr.cpu().numpy()
    active = state.active.cpu().numpy()
    w = state.w.cpu().numpy()
    ids = np.nonzero(active)[0]
    remap = {int(u): i + 1 for i, u in enumerate(ids)}   # obj is 1-based
    adj = {int(u): set(int(x) for x in nbr[u] if x >= 0) for u in ids}
    faces = set()
    for a in adj:
        for b in adj[a]:
            if b <= a:
                continue
            for c in adj[a] & adj[b]:
                if c > b:
                    faces.add((a, b, c))
    with open(path, "w") as f:
        f.write("# repro_torch multi-signal SOAM reconstruction\n")
        for u in ids:
            f.write(f"v {w[u, 0]:.6f} {w[u, 1]:.6f} {w[u, 2]:.6f}\n")
        for a, b, c in sorted(faces):
            f.write(f"f {remap[a]} {remap[b]} {remap[c]}\n")
    return len(ids), len(faces)


def soam_params(surface: str) -> gson.GSONParams:
    return gson.GSONParams(model="soam",
                           insertion_threshold=THRESH.get(surface, 0.25),
                           age_max=64.0, eps_b=0.1, eps_n=0.01,
                           stuck_window=60)


def build_spec(args) -> gson.RunSpec:
    backend = args.backend
    if args.recall_target is not None:
        if backend not in ("ann-windowed", "ann-grid"):
            raise SystemExit(
                "--recall-target tunes the approximate backends; pair it "
                "with --backend ann-windowed or ann-grid")
        backend = gson.ann_backend(backend, args.recall_target)
    vcfg = None
    if args.variant == "multi-fused":
        vcfg = gson.FusedConfig(
            superstep=gson.SuperstepConfig(length=args.superstep),
            refresh_every=2)
    elif args.variant == "multi":
        vcfg = gson.MultiConfig(refresh_every=2)
    return gson.RunSpec(
        variant=args.variant, model=soam_params(args.surface),
        sampler=args.surface, backend=backend, variant_config=vcfg,
        capacity=args.capacity, max_deg=16, check_every=25,
        max_iterations=args.iters, device=args.device)


def report(state, stats, surface: str, variant: str, out: str | None):
    v, e, f, chi = metrics.euler_characteristic(state)
    want = GENUS.get(surface, 0)
    print(f"\n{surface} via {variant}: converged={stats.converged} "
          f"units={stats.units} edges={e} faces={f}")
    print(f"Euler characteristic {chi} (target {2 - 2 * want}, genus "
          f"{want}; the network's genus {metrics.genus(state):g})  "
          f"signals={stats.signals} discarded={stats.discarded}  "
          f"step time {stats.time_step:.1f}s")
    if out:
        nv, nf = export_obj(state, out)
        print(f"wrote {out}: {nv} vertices, {nf} faces")


def print_row(row: dict) -> None:
    tag = f"[{row['network']}] " if "network" in row else ""
    print(f"  {tag}it={row['iteration']:6d} units={row['units']:6d} "
          f"signals={row['signals']:9d} qe={row['qe']:.5f}")


def run_fleet(args) -> None:
    """N surfaces, one fleet run, one mesh per network."""
    surfaces = sorted(gson.SAMPLERS.names())
    picks = [surfaces[i % len(surfaces)] for i in range(args.fleet)]
    base = build_spec(args)
    specs = tuple(base.replace(sampler=s, model=soam_params(s))
                  for s in picks)
    fspec = gson.FleetSpec(specs, tuple(range(args.seed,
                                              args.seed + args.fleet)))
    ckpt = dict(checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=(args.checkpoint_every
                                  if args.checkpoint_dir else 0))
    if args.resume:
        sess = gson.FleetSession.restore(fspec, **ckpt)
        print(f"resumed at iterations {list(sess.iterations)}")
    else:
        sess = gson.FleetSession(fspec, **ckpt)
    print(f"fleet of {args.fleet} networks ({', '.join(picks)}) in "
          f"{len(sess.cohorts)} cohort(s)")
    for row in sess.stream():
        print_row(row)
    if args.checkpoint_dir:
        sess.checkpoint()
    stem, ext = os.path.splitext(args.out) if args.out else (None, None)
    for i, surface in enumerate(picks):
        state, stats = sess.result(i)
        out = f"{stem}_{i}_{surface}{ext}" if args.out else None
        report(state, stats, surface, args.variant, out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Reconstruct a surface with the PyTorch/CUDA port "
                    "(no --mesh: sharding over devices is not ported "
                    "yet)")
    ap.add_argument("--surface", default="sphere",
                    choices=sorted(gson.SAMPLERS.names()))
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="reconstruct N surfaces (cycling through the "
                         "registered samplers) as one fleet run")
    ap.add_argument("--variant", default="multi",
                    choices=sorted(gson.VARIANTS.names()))
    ap.add_argument("--backend", default="cuda-full",
                    choices=sorted(gson.BACKENDS.names()),
                    help="per-phase implementations (Find Winners + dense "
                         "Update): the Hopper kernels, the references, "
                         "or the approximate searches")
    ap.add_argument("--recall-target", type=float, default=None,
                    metavar="R",
                    help="top-2 recall target of the ann-* backends (sizes "
                         "the shortlist by the birthday-collision model, "
                         "e.g. 0.95 -> 20 windows)")
    ap.add_argument("--superstep", type=int, default=64,
                    help="iterations per fused superstep (multi-fused)")
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--capacity", type=int, default=768)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="export .obj path")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot directory (enables --resume)")
    ap.add_argument("--checkpoint-every", type=int, default=200,
                    help="iterations between snapshots")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest snapshot")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")

    if args.fleet:
        run_fleet(args)
        return

    spec = build_spec(args)
    ckpt = dict(checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=(args.checkpoint_every
                                  if args.checkpoint_dir else 0))
    if args.resume:
        sess = gson.Session.restore(spec, **ckpt)
        print(f"resumed from iteration {sess.iteration}")
    else:
        sess = gson.Session(spec, seed=args.seed, **ckpt)
    for row in sess.stream():
        print_row(row)
    if args.checkpoint_dir:
        sess.checkpoint()
    state, stats = sess.result()
    report(state, stats, args.surface, args.variant, args.out)


if __name__ == "__main__":
    main()
