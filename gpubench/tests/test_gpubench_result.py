"""The shape of a run's result line, and a run without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gpubench.tests.conftest import REPO, TINY_CELL

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tiny_root, traced, capsys, monkeypatch):
    from gpubench import run
    orig = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda *a: orig(*a, device="cpu"))
    monkeypatch.setattr(run, "ROOT", tiny_root)
    rc = run.main(["--workload", TINY_CELL, "--seed", str(2 ** 33 + 7),
                   "--seconds", "0.3", "--trace", str(int(traced))])
    assert rc == 0
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert ("breakdown" in res) == traced
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "probe_ops.gson" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"network_it_per_s", "setup_s"}
        for m in res["metrics"].values():
            assert m["value"] > 0 and m["unit"]
    assert res["correct"] is True and res["attempted"] >= 3
    # the numbers compared, beside their limits, end standard error
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == ["step_gap", "checked_share",
                                            "worst"]
    assert res["check"]["step_gap"]["limit"] > res["check"]["step_gap"][
        "value"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "sphere4k.fleet64", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    import shutil
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); from gpubench import run; "
         "run.run_cell(run.ROOT, 'sphere4k.fleet64', 1, 1, False, "
         "device='cpu')"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the program is missing" in out.stderr
