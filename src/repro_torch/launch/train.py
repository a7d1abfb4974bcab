"""Training launcher of the port (``repro.launch.train``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --ckpt-dir .runs/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 10 --ckpt-dir .runs/ckpt --ckpt-every 5 [--resume]

The flags are those of ``repro.launch.train``, plus ``--device``: the
model trains on the card (``cuda``, the default) unless the caller asks
for the CPU. One process trains on one device, without a mesh (the
LM's meshes wait for ROADMAP A15f). The deployment is the cell's
(``steps.deploy_for``), made concrete by ``steps.resolve_deploy``. The
weights are random, drawn from ``--seed``; ``--resume`` continues from
the newest checkpoint of ``(params, opt_state)`` under ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import steps as steps_lib
from repro_torch.models.common import SHAPES, SMOKE_SHAPES
from repro_torch.models.registry import get_bundle, smoke_config
from repro_torch.training.optimizer import init_opt_state
from repro_torch.utils import tree_param_count


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
    dep = steps_lib.resolve_deploy(
        steps_lib.deploy_for(cfg.name, args.shape), shape)
    bundle = get_bundle(cfg)
    step, _abstract, tcfg = steps_lib.build_train_step(bundle, None, None,
                                                       dep)

    params = bundle.init(args.seed, device=args.device)
    opt_state = init_opt_state(tcfg.opt, params)
    start = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest() is not None:
        (params, opt_state), start, _ = ckpt.restore((params, opt_state))
        print(f"[train] resumed from step {start}")

    print(f"[train] {cfg.name} shape={shape} device={args.device} "
          f"microbatches={tcfg.microbatches} "
          f"params={tree_param_count(params):,}")
    t0 = time.time()
    losses = []
    for i in range(start, start + args.steps):
        batch = synthetic_batch(cfg, shape, step=i, seed=args.seed,
                                device=args.device)
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            print(f"  step {i+1:5d}  loss {losses[-1]:8.4f}  "
                  f"({(time.time()-t0)/args.log_every:.2f}s/step)")
            t0 = time.time()
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save_async((params, opt_state), i + 1)
    if ckpt:
        ckpt.wait()
    return params, opt_state, losses


if __name__ == "__main__":
    main()
