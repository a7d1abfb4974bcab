"""The GNG cell: found by name, judged by its own reference, its work
counted without a refresh.

A copy of the benchmark with one tiny GNG cell added by files and
entries alone (capacity 128, 3 networks, lambda 10 so that the networks
grow within a short job), run on the CPU through the program's plain
PyTorch paths."""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from gpubench.tests.conftest import REPO

CELL = "gng4k.fleet256"
TINY = "tiny.gng3"
METRICS = ("gng_insert_device_ms.gng", "gng_insert_ops_per_it.gng")


@pytest.fixture(scope="module")
def gng_root(tmp_path_factory):
    dst = tmp_path_factory.mktemp("gng")
    shutil.copytree(REPO / "gpubench", dst / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "src", dst / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = next(c for c in bench["configs"] if c["name"] ==
                "gng-fritzke-c4096")
    wl = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg = json.loads((REPO / base["file"]).read_text())
    cfg.update(name="tiny-gng", capacity=128)
    cfg["model"].update(max_parallel=256, gng_lambda=10)
    (dst / "gpubench/configs/tiny-gng.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (REPO / f"gpubench/traffic/{wl['traffic']}.json").read_text())
    traffic.update(networks=3, iterations=60)
    traffic["check"].update(networks=3, trajectory_networks=2,
                            trajectory_iterations=30, steps=4,
                            steps_from=45)
    traffic["trace"]["iterations"] = 4
    (dst / "gpubench/traffic/tiny-gng.json").write_text(json.dumps(traffic))
    bench["configs"].append(dict(base, name="tiny-gng",
                                 file="gpubench/configs/tiny-gng.json"))
    bench["workloads"].append(dict(wl, name=TINY, config="tiny-gng",
                                   traffic="tiny-gng"))
    for m in bench["per_layer"]:
        if CELL in m["workloads"]:
            m["workloads"].append(TINY)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def _driver(root, seed):
    from gpubench import catalog, run
    run.import_program(root)
    bench = catalog.Bench(root)
    wl = bench.workload(TINY)
    cfg = bench.config(wl["config"])
    drv = catalog.driver(cfg["driver"])(cfg, bench.traffic(wl["traffic"]),
                                        seed, "cpu")
    drv.setup()
    drv.window(0.0)
    return drv


def test_the_catalog_finds_the_cell():
    from gpubench import catalog
    from gpubench.drivers import gng_fleet
    bench = catalog.Bench(REPO)
    wl = bench.workload(CELL)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    assert (wl["chips"], cfg["model"]["model"]) == (1, "gng")
    assert (traffic["networks"], traffic["iterations"]) == (256, 896)
    assert catalog.driver(cfg["driver"]) is gng_fleet.Driver
    names = {m["name"] for m in bench.metrics("per_layer", CELL)}
    assert set(METRICS) <= names and "mfu_pct.gson" in names
    assert "refresh_device_ms.gson" not in names
    for name in METRICS:
        assert bench.reader(name)(type("T", (), {"spans": None})()) is None
    # every departure from Fritzke 1995 is written in the configuration
    assert len(cfg["departures"]) == 8


def test_the_program_passes(gng_root):
    drv = _driver(gng_root, 2 ** 31 + 3)
    from gpubench.reference import gng_compare
    sound = drv.check()
    assert sound.correct, sound.numbers()
    assert sound.step_gap < gng_compare.STEP_GAP_LIMIT / 100


@pytest.mark.parametrize("control", ["tf32", "alpha", "second_worst"])
def test_the_control_and_each_planted_fault_read_1(gng_root, control):
    from gpubench.reference import gng_compare
    drv = _driver(gng_root, 987654321)
    step = (gng_compare.control_step(drv.params) if control == "tf32"
            else gng_compare.fault_step(drv.params, control))
    tally = drv.check(control=step)
    assert not tally.correct
    assert tally.step_gap == 1.0, tally.worst


def test_a_fault_of_the_program_fails_the_run(gng_root, monkeypatch):
    """The program's own alpha altered to 0.45 underneath a run."""
    import dataclasses

    from gpubench import run
    from repro_torch.core.gson import fleet as fleet_core
    orig = fleet_core.multi_signal_step

    def step(nets, signals, params, prio, **kw):
        return orig(nets, signals, dataclasses.replace(params,
                                                       gng_alpha=0.45),
                    prio, **kw)
    monkeypatch.setattr(fleet_core, "multi_signal_step", step)
    res = run.run_cell(gng_root, TINY, 41, 0.1, False, device="cpu")
    assert res["correct"] is False


def test_a_traced_run_on_the_cpu(gng_root):
    from gpubench import run
    res = run.run_cell(gng_root, TINY, 2 ** 33 + 1, 0.1, True,
                       device="cpu")
    assert res["correct"], res["check"]
    # no device ran: the device readers, the new ones among them, find
    # nothing to read
    assert not set(METRICS) & set(res["metrics"])


def test_the_work_count_holds_no_refresh(gng_root):
    from gpubench import work
    drv = _driver(gng_root, 5)
    C, d, K = 128, 3, 16
    # (active, signals, discarded, edges) per network, fleet order
    rows = {k: np.array([[10 + k, 11 + k, 12 + k],
                         [100 * k, 110 * k, 120 * k],
                         [30 * k, 31 * k, 32 * k],
                         [15, 16, 17]]) for k in (6, 7)}
    drv.N = 8
    (it,) = drv._work(rows, 6)["iteration"]
    want = [work.iteration(m, s, a, e, C, d, K, 0) for m, s, a, e in (
        (100, 70, 16, 15), (110, 79, 17, 16), (120, 88, 18, 17))]
    assert it == pytest.approx(tuple(map(sum, zip(*want))))
    with_refresh = work.iteration(100, 70, 16, 15, C, d, K, 1)
    assert with_refresh[1] > want[0][1]
