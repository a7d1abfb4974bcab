"""The harness finds configurations, traffic mixes and metrics by name:
a cell added as files and entries runs with no edit to any file the
benchmark already has."""
from __future__ import annotations

import hashlib

from gpubench.tests.conftest import REPO, TINY_CELL


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "gpubench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found_by_name(tiny_root):
    from gpubench import catalog
    bench = catalog.Bench(tiny_root)
    wl = bench.workload(TINY_CELL)
    assert bench.config(wl["config"])["capacity"] == 128
    assert bench.traffic(wl["traffic"])["networks"] == 3
    assert bench.reader("probe_ops.gson")(type("T", (), {
        "iterations": 7})()) == 7.0
    names = [m["name"] for m in bench.metrics("per_layer", TINY_CELL)]
    assert "probe_ops.gson" in names and "mfu_pct.gson" in names


def test_the_copy_edits_no_existing_file(tiny_root):
    mine, theirs = _digests(tiny_root), _digests(REPO)
    shared = {p for p in mine if p in theirs}
    assert shared and all(mine[p] == theirs[p] for p in shared)
    added = {str(p) for p in mine if p not in theirs}
    assert added == {"gpubench/configs/tiny.json",
                     "gpubench/traffic/tiny.json",
                     "gpubench/metrics/probe_ops.gson.py"}


def test_added_cell_runs_traced_with_its_new_metric(tiny_root):
    from gpubench import run
    res = run.run_cell(tiny_root, TINY_CELL, 2 ** 31 + 12345, 0.5, True,
                       device="cpu")
    assert res["correct"], res["check"]
    assert res["metrics"]["probe_ops.gson"]["value"] == 4.0
    # no device ran on the CPU: the device readers find nothing to read
    assert "mfu_pct.gson" not in res["metrics"]
