"""Counted work against hand counts at tiny shapes, and a profiled stretch
that holds the program's work alone."""
from __future__ import annotations

import pytest

from gpubench import work


def test_find_winners_by_hand():
    # 4 signals x 5 active units x (3 diffs + 3 squares + 2 sums)
    flops, nbytes = work.find_winners(m=4, a=5, C=16, d=3)
    assert flops == 4 * 5 * 8
    # signals 4*12, active weights 5*12, flags 16, three outputs 4*12
    assert nbytes == 48 + 60 + 16 + 48


def test_update_phase_by_hand():
    # 2 survivors of 4 signals, 6 active units, 6 edges: degree 2
    flops, nbytes = work.update_phase(m=4, s=2, a=6, e=6, d=3, K=4)
    assert flops == 2 * (13 + 2 * 15)
    # inputs 4*28; survivors 2*(24+12+48); neighbors min(4, 6)=4 *36;
    # mirrored ages 8*2*2
    assert nbytes == 4 * 28 + 2 * 84 + 4 * 36 + 32


def test_iteration_by_hand():
    flops, nbytes = work.iteration(m=4, s=2, a=6, e=6, C=16, d=3, K=4,
                                   refreshes=1)
    assert flops == 4 * 6 * 8 + 2 * (13 + 2 * 15)
    # signals 48 + priorities 16 + state 2*6*(12+32+21) + flags 16
    # + one refresh 6 units * 2 neighbors * 16
    assert nbytes == 48 + 16 + 2 * 6 * 65 + 16 + 6 * 2 * 16


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(67e9, 3.35e12) == pytest.approx(1.0)


def test_empty_network_counts_no_neighbors():
    assert work.update_phase(m=4, s=0, a=0, e=0, d=3, K=16) == (0.0, 4 * 28.0)


def test_profiled_stretch_draws_nothing(tiny_root, monkeypatch):
    """The traced stretch's inputs are drawn before the profiler starts,
    so the per-layer readers see the program's operations alone."""
    from gpubench import run, trace
    from gpubench.traffic import draws
    profiling = []
    orig_profile, orig_draw = trace.profile, draws.JobInputs._draw

    def profile(fn, sync):
        profiling.append(True)
        try:
            return orig_profile(fn, sync)
        finally:
            profiling.pop()

    def draw(self, k, n):
        assert not profiling, f"iteration {k} drawn inside the profiler"
        return orig_draw(self, k, n)

    monkeypatch.setattr(trace, "profile", profile)
    monkeypatch.setattr(draws.JobInputs, "_draw", draw)
    res = run.run_cell(tiny_root, "tiny.fleet3", 17, 0.1, True, device="cpu")
    assert res["correct"] is True
