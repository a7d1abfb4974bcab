"""A run of the tiny cell on the card, traced: every per-layer metric is
read from the device trace, and no share passes 100%."""
from __future__ import annotations

import pytest

from gpubench.tests.conftest import TINY_CELL


@pytest.mark.cuda
def test_traced_run_on_the_card(tiny_root, card):
    from gpubench import run
    res = run.run_cell(tiny_root, TINY_CELL, 2 ** 32 + 5, 1.0, True)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    got = res["metrics"]
    for name in ("device_idle_pct.gson", "mfu_pct.gson",
                 "step_device_ms.gson", "device_ops_per_it.gson",
                 "find_winners_roofline_pct.gson",
                 "update_phase_roofline_pct.gson"):
        assert got[name]["value"] > 0, name
    for name in ("mfu_pct.gson", "find_winners_roofline_pct.gson",
                 "update_phase_roofline_pct.gson"):
        assert got[name]["value"] < 100, name
