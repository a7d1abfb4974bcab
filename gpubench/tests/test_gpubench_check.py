"""The comparison that decides ``correct``: sound runs of the program
pass, and the control and every fault that a GSON cell can have fail.

The control is the reference with its distance product in TF32 (on the
CPU its inputs rounded to TF32), put in the program's place. The faults
are planted underneath a run that skips the look for a card: a step that
returns its state unchanged, half of the live signals left out, a
winner altered where Find Winners produces it. (A GSON cell runs on one
chip: no exchange between chips can be left out.)"""
from __future__ import annotations

import pytest
import torch

from gpubench.tests.conftest import TINY_CELL


def _driver(root, seed):
    from gpubench import catalog, run
    run.import_program(root)
    bench = catalog.Bench(root)
    wl = bench.workload(TINY_CELL)
    cfg = bench.config(wl["config"])
    drv = catalog.driver(cfg["driver"])(cfg, bench.traffic(wl["traffic"]),
                                        seed, "cpu")
    drv.setup()
    drv.window(0.0)
    return drv


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 987654321])
def test_program_passes_and_control_fails(tiny_root, seed):
    from gpubench.reference import compare
    drv = _driver(tiny_root, seed)
    sound = drv.check()
    assert sound.correct, sound.numbers()
    assert sound.step_gap < compare.STEP_GAP_LIMIT / 100
    ctl = drv.check(control=compare.control_step(drv.params))
    assert not ctl.correct
    assert ctl.step_gap >= 3 * sound.step_gap


def _unchanged(orig):
    def step(nets, *a, **kw):
        return nets
    return step


def _half_the_signals(orig):
    def step(nets, signals, params, prio, **kw):
        mask = kw["signal_mask"]
        live = mask.sum(-1, keepdim=True)
        rank = torch.cumsum(mask.to(torch.int64), -1)
        kw["signal_mask"] = mask & (rank <= (live + 1) // 2)
        return orig(nets, signals, params, prio, **kw)
    return step


def _altered_winner(orig):
    def step(nets, signals, params, prio, **kw):
        fw = kw["find_winners"]

        def altered(*a, **k):
            wid, sid, d2b, d2s = fw(*a, **k)
            wid = wid.clone()
            wid[:, 0] = sid[:, 0]
            return wid, sid, d2b, d2s
        kw["find_winners"] = altered
        return orig(nets, signals, params, prio, **kw)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_the_signals,
                                   _altered_winner])
def test_a_planted_fault_fails(tiny_root, monkeypatch, fault):
    from gpubench import run
    from repro_torch.core.gson import fleet as fleet_core
    monkeypatch.setattr(fleet_core, "multi_signal_step",
                        fault(fleet_core.multi_signal_step))
    res = run.run_cell(tiny_root, TINY_CELL, 41, 0.2, False, device="cpu")
    assert res["correct"] is False
    assert res["check"]["step_gap"]["value"] == 1.0


def test_own_trajectory_covers_its_iterations(tiny_root):
    """The reference's own trajectory judges every iteration up to the
    traffic's ``trajectory_iterations`` that held no near tie."""
    drv = _driver(tiny_root, 2 ** 32 + 5)
    T = drv.traffic["check"]["trajectory_iterations"]
    tally = drv.check()
    assert tally.trajectories
    for first_tie, judged in tally.trajectories:
        assert 0 < judged <= T and first_tie <= T
    assert tally.correct
