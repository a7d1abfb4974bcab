"""End-to-end LM training on the port, the twin of
``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200   # the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 40

  # the full published config: drop the preset
  PYTHONPATH=src python examples/torch_train_lm.py --arch qwen1.5-0.5b \\
      --full --seq 1024 --batch 4

Config -> model registry -> train step -> synthetic-but-learnable data
stream -> asynchronous checkpoints -> resume. The loss falling to the
Markov chain's conditional entropy (well below log V) is the end-to-end
correctness signal: the first-10 mean loss is printed beside the
last-10 mean. One process trains on one device (``--device``, the card
by default).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_batch
from repro_torch.launch import steps as steps_lib
from repro_torch.models.common import ShapeCfg
from repro_torch.models.registry import get_bundle
from repro_torch.training import optimizer as opt_lib
from repro_torch.utils import tree_param_count

PRESET = dict(n_layers=8, d_model=384, d_head=64, n_heads=6, n_kv=2,
              d_ff=1024, vocab=4096, remat="none", attn_chunk=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the exact published config")
    ap.add_argument("--ckpt-dir", default=".runs/train_lm_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.replace(param_dtype=torch.float32,
                          compute_dtype=torch.float32, **PRESET)
    bundle = get_bundle(cfg)
    dep = steps_lib.DeployCfg(microbatches=1, lr=args.lr)
    step, _, tcfg = steps_lib.build_train_step(bundle, None, None, dep)

    params = bundle.init(0, device=args.device)
    opt = opt_lib.init_opt_state(tcfg.opt, params)
    shape = ShapeCfg("train_lm", args.seq, args.batch, "train")
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest() is not None:
        (params, opt), start, _ = ckpt.restore((params, opt))
        print(f"resumed from step {start}")

    print(f"{cfg.name}: {tree_param_count(params) / 1e6:.1f}M params, "
          f"device {args.device}, seq {args.seq} batch {args.batch}")
    print(f"log(vocab) = {math.log(cfg.vocab):.3f} — loss must drop "
          f"well below this")
    t0, losses = time.time(), []
    for i in range(start, start + args.steps):
        batch = synthetic_batch(cfg, shape, step=i, seed=0,
                                device=args.device)
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            dt = (time.time() - t0) / 10
            print(f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                  f"({dt:.2f}s/step)")
            t0 = time.time()
        if (i + 1) % 50 == 0:
            ckpt.save_async((params, opt), i + 1)
    ckpt.wait()
    print(f"\nfirst-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
