"""Training launcher of the port (``repro.launch.train``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --ckpt-dir .runs/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 10 --ckpt-dir .runs/ckpt --ckpt-every 5 [--resume]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke

The flags are those of ``repro.launch.train``, plus ``--device``: the
model trains on the card (``cuda``, the default; ``cuda:$LOCAL_RANK``
under torchrun, over NCCL) unless the caller asks for the CPU (gloo).
It trains on the world's mesh (``make_mesh_for_env``): the ranks that
torchrun started, or this one process as a 1 x 1 mesh, for which the
launcher starts a one-rank process group itself (a file store in a
temporary directory). The deployment is the cell's (``steps.deploy_for``),
made concrete by ``steps.resolve_deploy``. The weights are random, drawn
from ``--seed``; ``--resume`` continues from the newest checkpoint of
``(params, opt_state)`` under ``--ckpt-dir``. A checkpoint holds the whole
trees (gathered from every rank; rank 0 writes them), so a run resumes
on another mesh too.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import build_mesh, make_production_mesh
from repro_torch.models import placement
from repro_torch.models.common import SHAPES, SMOKE_SHAPES, rules_for_mesh
from repro_torch.models.registry import get_bundle, smoke_config
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.trainer import init_train_state
from repro_torch.utils import tree_param_count


def make_mesh_for_env(multi_pod: bool = False):
    """The world's mesh, keyed on its rank count (collective)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n >= 512 and multi_pod:
        return make_production_mesh(multi_pod=True)
    if n >= 256:
        return make_production_mesh()
    # debug meshes for small rank counts
    shape = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}.get(n, (n, 1))
    return build_mesh(shape, ("data", "model"))


@contextlib.contextmanager
def world(device: str):
    """The process group: torchrun's (``WORLD_SIZE`` set), an existing
    one, or a new one-rank group; NCCL on the card, gloo on the CPU.
    Yields this rank's device."""
    if dist.is_initialized():
        yield device
        return
    backend = "gloo" if device == "cpu" else "nccl"
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device (pass "
                               "--device cpu to run on the CPU)")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as root:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{root}/s",
                                    rank=0, world_size=1)
        try:
            yield device
        finally:
            dist.destroy_process_group()


def _whole(params, opt_state, ospecs) -> tuple:
    """Collective: (params, opt_state) as whole trees on every rank."""
    mesh = params.mesh
    opt = {k: v if k == "step" else placement.gather_params(v, ospecs[k],
                                                           mesh)
           for k, v in opt_state.items()}
    return placement.gather_params(params), opt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shapes = SHAPES
    if args.smoke:
        cfg = smoke_config(cfg)
        shapes = SMOKE_SHAPES
    shape = shapes[args.shape]
    with world(args.device) as device:
        mesh = make_mesh_for_env()
        lead = dist.get_rank() == 0
        dep = steps_lib.resolve_deploy(
            steps_lib.deploy_for(cfg.name, args.shape), shape, mesh)
        rules = rules_for_mesh(mesh)
        bundle = get_bundle(cfg)
        step, _abstract, tcfg = steps_lib.build_train_step(
            bundle, mesh, rules, dep)
        specs = bundle.param_specs(rules)
        ospecs = opt_lib.match_opt_specs(tcfg.opt, bundle.param_shapes(),
                                         specs)
        params, opt_state, _ = init_train_state(
            bundle, mesh, rules, tcfg, rng=args.seed, device=device)
        start = 0

        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        if ckpt and args.resume and ckpt.latest() is not None:
            (full, opt), start, _ = ckpt.restore(
                _whole(params, opt_state, ospecs))
            params = placement.shard_params(full, specs, mesh)
            opt_state = {k: v if k == "step" else placement.shard_params(
                v, ospecs[k], mesh) for k, v in opt.items()}
            if lead:
                print(f"[train] resumed from step {start}")

        if lead:
            print(f"[train] {cfg.name} shape={shape} device={device} "
                  f"mesh={mesh.shape} microbatches={tcfg.microbatches} "
                  f"params={tree_param_count(bundle.param_shapes()):,}")
        t0 = time.time()
        losses = []
        for i in range(start, start + args.steps):
            batch = synthetic_batch(cfg, shape, step=i, seed=args.seed,
                                    device=device)
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (i + 1) % args.log_every == 0 and lead:
                print(f"  step {i+1:5d}  loss {losses[-1]:8.4f}  "
                      f"({(time.time()-t0)/args.log_every:.2f}s/step)")
                t0 = time.time()
            if ckpt and (i + 1) % args.ckpt_every == 0:
                whole = _whole(params, opt_state, ospecs)
                if lead:
                    ckpt.save_async(whole, i + 1)
        if ckpt:
            ckpt.wait()
    return params, opt_state, losses


if __name__ == "__main__":
    main()
