"""Fault tolerance on the port: pod failure -> elastic restart -> exact
resume. The twin of ``examples/fault_tolerance.py``.

  PYTHONPATH=src python examples/torch_fault_tolerance.py          # the card
  PYTHONPATH=src python examples/torch_fault_tolerance.py --device cpu

Trains a toy LM under ``repro_torch.ft.elastic.ElasticRunner``, kills
"pod 1" at step 17, and shows the run restarting from the last
checkpoint with one fewer pod. The final parameters match the
failure-free run's (``allclose``), because the data stream is a pure
function of (seed, step). One process runs on one device: the pod count
only scales the health vector here, as in the JAX example's one-device
mesh.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_batch
from repro_torch.ft.elastic import ElasticRunner, FailureInjector
from repro_torch.launch import steps as steps_lib
from repro_torch.models.common import ShapeCfg
from repro_torch.models.registry import get_bundle, smoke_config
from repro_torch.training import optimizer as opt_lib

cfg = smoke_config(get_config("qwen1.5-0.5b"))
bundle = get_bundle(cfg)
shape = ShapeCfg("ft", 64, 8, "train")


def make_build(device: str):
    def build(n_pods, ckpt):
        """(Re)build the train state for the surviving pod count."""
        step_fn_inner, _, tcfg = steps_lib.build_train_step(
            bundle, None, None, steps_lib.DeployCfg(microbatches=1))
        params = bundle.init(0, device=device)
        opt = opt_lib.init_opt_state(tcfg.opt, params)
        state = {"params": params, "opt": opt}
        if ckpt is not None and ckpt.latest() is not None:
            state, step0, _ = ckpt.restore(state)
            print(f"  [build] restored checkpoint at step {step0}, "
                  f"pods={n_pods}")

        def step_fn(state, step, weights):
            batch = synthetic_batch(cfg, shape, step=step, seed=0,
                                    device=device)
            p, o, m = step_fn_inner(state["params"], state["opt"], batch)
            if step % 5 == 0:
                print(f"  step {step:3d} pods={n_pods} "
                      f"loss={float(m['loss']):.4f} weights={weights}")
            return {"params": p, "opt": o}

        return state, step_fn
    return build


def run(tag, injector, path, device):
    ckpt = CheckpointManager(path, keep=2)
    runner = ElasticRunner(make_build(device), ckpt, n_pods=2,
                           ckpt_every=10, injector=injector)
    final = runner.run(30)
    print(f"[{tag}] restarts={runner.restarts} "
          f"events={[e for e in runner.log if e['event'] == 'restart']}")
    return final, runner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--runs-dir", default=".runs",
                    help="where the two runs keep their checkpoints")
    args = ap.parse_args(argv)

    print("=== failure-free reference ===")
    ref, _ = run("reference", FailureInjector(),
                 os.path.join(args.runs_dir, "ft_demo_ref"), args.device)
    print("\n=== pod 1 dies at step 17 ===")
    out, runner = run("pod-loss", FailureInjector({17: "pod1_down"}),
                      os.path.join(args.runs_dir, "ft_demo_fail"),
                      args.device)

    same = all(torch.allclose(ref["params"][k], out["params"][k])
               for k in ref["params"])
    print(f"\nfinal params identical to failure-free run: {same}")
    assert same, "elastic resume must reproduce the failure-free run"
    return ref, out, runner


if __name__ == "__main__":
    main()
