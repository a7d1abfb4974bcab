"""The port's training entry points on the CPU: one train step of each
ported family (``tests/test_models_smoke.py::
test_one_train_step_updates_params``'s port, its loss held against JAX's
from the same weights within rtol 1e-5), ``python -m
repro_torch.launch.train --smoke --device cpu`` with a checkpoint and
``--resume``, and the two examples (``examples/torch_train_lm.py`` at a
few steps, ``examples/torch_fault_tolerance.py`` whole)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import lm_pair
from repro.data.tokens import synthetic_batch as jax_synthetic_batch
from repro.models.common import SMOKE_SHAPES as JSMOKE
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as launch_train
from repro_torch.training.optimizer import (OptConfig, apply_update,
                                            init_opt_state)
from repro_torch.training.trainer import grad_fn

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-76b",
                                  "qwen2-moe-a2.7b"])
def test_one_train_step_updates_params(arch):
    jcfg, jb, jp, cfg, tb, tp = lm_pair(arch)
    jbatch = jax_synthetic_batch(jcfg, JSMOKE["train_4k"], step=0, seed=0)
    batch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    ocfg = OptConfig(lr=1e-2)
    opt = init_opt_state(ocfg, tp)
    (loss, _), grads = grad_fn(tb)(tp, batch)
    jloss, _ = jax.jit(jb.loss)(jp, jbatch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    new_params, opt = apply_update(ocfg, tp, grads, opt)
    assert np.isfinite(float(loss))
    changed = any(not torch.allclose(tp[k], new_params[k]) for k in tp)
    assert changed, f"{arch}: step did not change params"
    for k, leaf in new_params.items():
        assert bool(torch.isfinite(leaf).all()), f"{arch}: NaN in {k}"


def test_launch_train_smoke_checkpoints_and_resumes(tmp_path, capsys):
    """Six steps with checkpoints at 3 and 6 equal three steps, a resume
    from step 3 and three more, bitwise; losses finite."""
    common = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
              "--log-every", "1", "--ckpt-every", "3"]
    p6, o6, losses = launch_train.main(
        common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert int(o6["step"]) == 6
    launch_train.main(common + ["--steps", "3", "--ckpt-dir",
                                str(tmp_path / "b")])
    p, o, rest = launch_train.main(common + ["--steps", "3", "--resume",
                                             "--ckpt-dir",
                                             str(tmp_path / "b")])
    assert "resumed from step 3" in capsys.readouterr().out
    assert rest == losses[3:]
    assert int(o["step"]) == 6
    for k in p6:
        assert torch.equal(p[k], p6[k]), k
    assert CheckpointManager(str(tmp_path / "b")).latest() == 6


def test_train_lm_example_learns(tmp_path, capsys):
    """The example's preset at a short sequence: the last-10 mean loss
    below the first-10 mean."""
    mod = _example("torch_train_lm")
    assert mod.PRESET["n_layers"] == 8 and mod.PRESET["vocab"] == 4096
    losses = mod.main(["--device", "cpu", "--steps", "20", "--seq", "32",
                       "--batch", "4", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "first-10 mean loss" in out
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_fault_tolerance_example_resumes_exactly(tmp_path):
    """Pod 1 dies at step 17: one restart from the step-10 checkpoint with
    one pod, and the final parameters equal the failure-free run's."""
    mod = _example("torch_fault_tolerance")
    ref, out, runner = mod.main(["--device", "cpu", "--runs-dir",
                                 str(tmp_path)])
    assert runner.restarts == 1
    assert [e for e in runner.log if e["event"] == "restart"] == [
        {"event": "restart", "step": 10, "pods": 1}]
    for k in ref["params"]:
        assert torch.equal(ref["params"][k], out["params"][k]), k
    assert int(out["opt"]["step"]) == 30
