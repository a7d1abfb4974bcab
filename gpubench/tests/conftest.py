"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with one
tiny cell added by files and entries alone, run on the CPU through the
program's plain PyTorch paths."""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CELL = "tiny.fleet3"


def make_tiny_root(dst: Path) -> Path:
    """``dst`` holding BENCHMARK.json, gpubench/ and a link to src/, with
    a configuration ``tiny`` (capacity 128), a traffic ``tiny`` (3
    networks, 40 iterations), a metric ``probe_ops.gson`` and their
    entries added; no file of the copy is edited but BENCHMARK.json."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "gpubench", dst / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "src", dst / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = bench["configs"][0]
    cfg = json.loads((REPO / base["file"]).read_text())
    cfg.update(name="tiny", capacity=128)
    cfg["model"]["max_parallel"] = 256
    (dst / "gpubench/configs/tiny.json").write_text(json.dumps(cfg))
    wl = bench["workloads"][0]
    traffic = json.loads(
        (REPO / f"gpubench/traffic/{wl['traffic']}.json").read_text())
    traffic.update(networks=3, iterations=40)
    traffic["check"].update(networks=2, trajectory_networks=1,
                            trajectory_iterations=10, steps=2)
    traffic["trace"]["iterations"] = 4
    (dst / "gpubench/traffic/tiny.json").write_text(json.dumps(traffic))
    (dst / "gpubench/metrics/probe_ops.gson.py").write_text(
        "def read(t):\n    return float(t.iterations)\n")
    bench["configs"].append(dict(base, name="tiny",
                                 file="gpubench/configs/tiny.json"))
    bench["workloads"].append(dict(wl, name=TINY_CELL, config="tiny",
                                   traffic="tiny"))
    for m in bench["per_layer"]:
        m["workloads"].append(TINY_CELL)
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="probe_ops.gson", unit="ops"))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("bench"))
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return root


@pytest.fixture
def card():
    """Skips a test where no CUDA card is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
