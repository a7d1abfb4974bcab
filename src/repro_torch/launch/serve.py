"""Serving launcher: batched requests through the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 12 --max-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --smoke --device cpu

Every family of ``repro_torch.configs`` serves: the dense, vlm and MoE
transformers, mamba2-2.7b (SSM), zamba2-2.7b (hybrid) and whisper-medium
(enc-dec, on the engine's zero audio frames). The model runs at its
published width on the card (``--device cuda``, the default);
``--smoke`` takes the reduced config of the same family. The weights are
random, drawn from ``--seed``. The flags are those of
``repro.launch.serve``, plus ``--device``.

It serves on the world's mesh (``launch.train.make_mesh_for_env``): the
ranks that torchrun started (``torchrun --nproc-per-node 4 -m
repro_torch.launch.serve --smoke``), or this one process as a 1 x 1 mesh
in a one-rank process group of its own; every family runs there, with
the parameters held under the cell's decode deployment
(``steps.deploy_for(arch, "decode_32k")``) and ``--max-len`` divisible by
the mesh's ``model`` axis. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.train import make_mesh_for_env, world
from repro_torch.models import placement
from repro_torch.models.registry import get_bundle, smoke_config
from repro_torch.serving.engine import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    bundle = get_bundle(cfg)
    with world(args.device) as device:
        mesh = make_mesh_for_env()
        rules = steps.rules_for_deploy(mesh, steps.deploy_for(
            cfg.name, "decode_32k"))
        params = placement.shard_params(bundle.init(args.seed, device=device),
                                        bundle.param_specs(rules), mesh)
        engine = ServeEngine(
            bundle, params,
            ServeConfig(batch=args.batch, max_len=args.max_len,
                        temperature=args.temperature), mesh=mesh,
            rng=torch.Generator(device=device).manual_seed(args.seed + 1))

        rng = np.random.default_rng(args.seed)
        for i in range(args.requests):
            plen = int(rng.integers(4, 17))
            prompt = rng.integers(2, cfg.vocab, size=plen)
            engine.submit(prompt, rid=i, max_tokens=args.max_tokens)

        t0 = time.time()
        done = engine.run()
        dt = time.time() - t0
        if dist.get_rank() == 0:
            toks = sum(len(r.out) for r in done)
            print(f"[serve] {cfg.name}: {len(done)} requests, {toks} tokens, "
                  f"{engine.prefills} prefill waves, {engine.decode_steps} "
                  f"decode steps, {toks/max(dt,1e-9):.1f} tok/s, mesh "
                  f"{mesh.shape}")
            for r in done[:4]:
                print(f"  rid={r.rid} prompt_len={len(r.prompt)} "
                      f"out={r.out[:8]}…")
    return done

if __name__ == "__main__":
    main()
