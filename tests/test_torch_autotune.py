"""The port's shape-aware Update-phase selection (``repro_torch.gson.autotune``).

Mirrors ``tests/test_autotune.py`` without a real clock: a fake
``TimerFn`` drives measurement, the JSON table round-trips and rejects
other schema versions, the env override wins, an unusable cache warns,
unmeasured shapes take the nearest measured cell exactly as the JAX
``SelectionTable.nearest`` does, and ``cuda-auto`` dispatches to what the
table names. Differences kept on purpose: the candidates are ``cuda``
and ``sparse`` (``sparse`` timed only where the slab engages), the
reference is timed beside them and never selected, a table selecting
anything else raises, and on a card ``neighbor_collision="last"``
raises instead of running the reference. The JAX file's wall-clock gate
(``test_units_1024_cliff_regression``) measures this CPU and has no
counterpart: the port's committed table is measured on the card.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.gson import autotune as jat  # noqa: E402
from repro_torch import gson  # noqa: E402
from repro_torch.core.gson.multi import update_phase_reference  # noqa: E402
from repro_torch.gson import autotune as at  # noqa: E402
from repro_torch.kernels.update_phase import sparse  # noqa: E402
from repro_torch.kernels.update_phase.kernel import (  # noqa: E402
    update_accum, winner_lock_min)

torch.set_num_threads(1)
FAKE_US = {"reference": 50.0, "cuda": 30.0, "sparse": 10.0}


def fake_timer(name, thunk):
    # never calls the thunk: selection must not depend on execution
    return FAKE_US[name] * 1e-6


def tiny_cells():
    # pools of 4 and 8 tiles of 256 against a 1-tile slab: sparse is timed
    return ((8, 1024, 16), (8, 2048, 16))


def hand_table(cells, best="sparse"):
    return at.SelectionTable(cells=tuple(
        at.Cell(units=u, capacity=c, m=m, best=best, t_us=dict(FAKE_US))
        for (u, c, m) in cells))


def build(cells=None):
    return at.build_table(cells or tiny_cells(), timer=fake_timer,
                          device="cpu")


# ---------------------------------------------------------------------------
# measurement


def test_measure_cell_is_deterministic_under_fake_timer():
    a = at.measure_cell(8, 1024, 16, timer=fake_timer, device="cpu")
    b = at.measure_cell(8, 1024, 16, timer=fake_timer, device="cpu")
    assert a == b
    assert a.best == "sparse"
    assert a.t_us == pytest.approx(FAKE_US)


def test_tied_timings_break_deterministically():
    cell = at.measure_cell(8, 1024, 16, timer=lambda name, thunk: 1.0,
                           device="cpu")
    assert cell.best == min(at.CANDIDATES) == "cuda"


@pytest.mark.parametrize("cell", [(8, 64, 16), (8, 256, 16),
                                  (384, 768, 768), (2048, 2048, 4096)])
def test_sparse_is_timed_only_where_the_slab_engages(cell):
    """Where the slab would be the whole pool it is the dense path: not
    timed, so the table never ranks the same code against itself. The
    reference is timed and never selected, however fast."""
    timer = lambda name, thunk: {"reference": 1, "cuda": 30,  # noqa: E731
                                 "sparse": 10}[name] * 1e-6
    got = at.measure_cell(*cell, timer=timer, device="cpu")
    assert set(got.t_us) == {"reference", "cuda"}
    assert got.best == "cuda"
    assert at.measure_cell(8, 1024, 16, timer=timer,
                           device="cpu").best == "sparse"


def test_build_table_reproducible_with_device_meta():
    t1, t2 = build(), build()
    assert t1 == t2
    assert [c.best for c in t1.cells] == ["sparse", "sparse"]
    assert t1.meta["device"] == "cpu"
    assert t1.meta["torch_version"] == torch.__version__


def test_default_cells_are_the_jax_grid():
    assert at.DEFAULT_CELLS == jat.DEFAULT_CELLS


def test_wall_timer_runs_the_thunk():
    calls = []
    secs = at.wall_timer(n=3, warmup=2, device="cpu")(
        "x", lambda: calls.append(1))
    assert len(calls) == 5 and secs >= 0.0


# ---------------------------------------------------------------------------
# persistence


def test_json_round_trip(tmp_path):
    table = build()
    path = at.save_table(table, str(tmp_path / "t.json"))
    assert at.load_table(path) == table


def test_schema_version_rejected(tmp_path):
    payload = build().to_json()
    payload["schema"] = at.SCHEMA_VERSION + 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(payload))
    with pytest.raises(at.TableSchemaError, match="regenerate"):
        at.load_table(str(bad))
    with pytest.raises(ValueError):
        at.SelectionTable.from_json({"schema": at.SCHEMA_VERSION,
                                     "cells": []})


def test_env_override_wins(tmp_path, monkeypatch):
    table = hand_table(((4, 32, 8),))
    path = at.save_table(table, str(tmp_path / "env.json"))
    monkeypatch.setenv(at.ENV_TABLE, path)
    assert at.load_table() == table
    # strictly: a broken override is an error, not a fallback
    (tmp_path / "broken.json").write_text("{")
    monkeypatch.setenv(at.ENV_TABLE, str(tmp_path / "broken.json"))
    with pytest.raises(json.JSONDecodeError):
        at.load_table()


def test_env_names_are_the_ports_own():
    assert (at.ENV_TABLE, at.ENV_CACHE) != (jat.ENV_TABLE, jat.ENV_CACHE)
    assert at.DEFAULT_CACHE != jat.DEFAULT_CACHE


def test_cache_is_preferred_and_a_corrupt_one_warns(tmp_path, monkeypatch):
    monkeypatch.delenv(at.ENV_TABLE, raising=False)
    cache = tmp_path / "cache.json"
    monkeypatch.setenv(at.ENV_CACHE, str(cache))
    table = hand_table(((4, 32, 8),))
    at.save_table(table, str(cache))
    assert at.load_table() == table
    cache.write_text("not json at all")
    with pytest.warns(RuntimeWarning, match="unusable autotune cache"):
        got = at.load_table()
    assert got == at.load_table(at.PACKAGED_TABLE)


def test_autotune_writes_the_cache(tmp_path, monkeypatch):
    real = at.build_table
    monkeypatch.setattr(at, "build_table", lambda cells, **kw: real(
        cells, timer=fake_timer, device="cpu"))
    cache = str(tmp_path / "c.json")
    table = at.autotune(tiny_cells(), cache=cache, device="cpu")
    assert at.load_table(cache) == table


# ---------------------------------------------------------------------------
# selection


def test_table_selecting_the_reference_raises():
    """cuda-auto runs kernels only: a table (e.g. an old local cache)
    whose best is the reference is refused, not run."""
    table = hand_table(((8, 128, 16),), "reference")
    with pytest.raises(ValueError, match="cuda-auto does not run"):
        at.select_update_phase(table, 128, 16)
    up = at.make_autotuned_update_phase(table)
    with pytest.raises(ValueError, match="regenerate"):
        up(*at._cell_inputs(8, 128, 16, device="cpu"))


def test_exact_cell_wins():
    table = at.SelectionTable(cells=(
        at.Cell(8, 256, 16, "cuda", {"cuda": 1.0, "reference": 2.0}),
        at.Cell(512, 4096, 1024, "reference",
                {"cuda": 9.0, "reference": 1.0}),
    ))
    assert table.select(256, 16, units=8) == "cuda"
    assert table.select(4096, 1024, units=512) == "reference"


def test_nearest_matches_the_jax_table():
    """The same cells in both packages pick the same nearest cell, with
    ``units`` given and defaulting to m // 2, ties included."""
    cells = ((8, 128, 16), (1024, 8192, 2048), (64, 768, 128),
             (256, 4096, 512), (384, 8192, 768), (64, 512, 128),
             (128, 768, 128))
    ours = at.SelectionTable(cells=tuple(
        at.Cell(u, c, m, f"b{i}", {f"b{i}": 1.0})
        for i, (u, c, m) in enumerate(cells)))
    theirs = jat.SelectionTable(cells=tuple(
        jat.Cell(u, c, m, f"b{i}", {f"b{i}": 1.0})
        for i, (u, c, m) in enumerate(cells)))
    for capacity in (32, 150, 512, 640, 768, 1000, 2048, 6000, 8192, 65536):
        for m in (1, 16, 20, 100, 128, 256, 700, 1500, 4096):
            for units in (None, 1, 8, 64, 300):
                assert (ours.nearest(capacity, m, units).best
                        == theirs.nearest(capacity, m, units).best), (
                    capacity, m, units)
    assert ours.select(150, 20) == "b0"
    assert ours.select(6000, 1500) == "b1"


def test_unknown_backend_in_table_raises():
    table = at.SelectionTable(cells=(
        at.Cell(8, 128, 16, "pallas", {"pallas": 1.0}),))
    with pytest.raises(ValueError, match="pallas"):
        at.select_update_phase(table, 128, 16)
    up = at.make_autotuned_update_phase(table)
    st, sig, wid, sid, d2b, prio, p = at._cell_inputs(8, 128, 16,
                                                      device="cpu")
    with pytest.raises(ValueError, match="regenerate"):
        up(st, sig, wid, sid, d2b, prio, p)


def test_committed_table_always_selects_measured_best():
    """The committed table was measured on the card over the JAX grid, and
    at every cell the selection returns the backend measured fastest."""
    table = at.load_table(at.PACKAGED_TABLE)
    assert {(c.units, c.capacity, c.m) for c in table.cells} == \
        set(at.DEFAULT_CELLS)
    assert "H100" in table.meta["nvidia_smi"]
    assert table.meta["device"].startswith("cuda")
    for cell in table.cells:
        _, n_tiles, slab_tiles = sparse.slab_shape(cell.capacity, cell.m)
        assert set(cell.t_us) == ({"reference", "cuda"} | (
            {"sparse"} if slab_tiles < n_tiles else set())), cell
        best = min(set(cell.t_us) & set(at.CANDIDATES),
                   key=lambda k: (cell.t_us[k], k))
        sel = at.select_update_phase(table, cell.capacity, cell.m,
                                     cell.units)
        assert sel == best == cell.best, cell
        assert at.select_update_phase(table, cell.capacity, cell.m) == best


# ---------------------------------------------------------------------------
# the cuda-auto adapter


@pytest.mark.parametrize("name", ["cuda", "sparse"])
def test_adapter_dispatch_matches_forced_candidate(name):
    """An adapter whose table names one backend is that backend: bitwise
    the same UpdateOut (a cell where the slab engages: 4 tiles of 256,
    a 1-tile budget)."""
    up = at.make_autotuned_update_phase(hand_table(((8, 1024, 16),), name))
    inputs = at._cell_inputs(8, 1024, 16, device="cpu")
    want = at.CANDIDATES[name](*inputs)
    got = up(*inputs)
    for field, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), field


def test_adapter_routes_last_collision_to_reference():
    up = at.make_autotuned_update_phase(hand_table(((8, 64, 16),)))
    st, sig, wid, sid, d2b, prio, p = at._cell_inputs(8, 64, 16,
                                                      device="cpu")
    p = dataclasses.replace(p, neighbor_collision="last")
    out = up(st, sig, wid, sid, d2b, prio, p)     # the kernels would raise
    ref = update_phase_reference(st, sig, wid, sid, d2b, prio, p)
    assert torch.equal(ref.w, out.w)
    # off the CPU it raises, as the kernel backends do, before any work
    with pytest.raises(NotImplementedError, match="reference backend"):
        up(st, sig.to("meta"), wid, sid, d2b, prio, p)


def test_adapter_loads_its_table_at_the_first_call(tmp_path, monkeypatch):
    monkeypatch.setenv(at.ENV_TABLE, str(tmp_path / "missing.json"))
    up = at.make_autotuned_update_phase()         # nothing read yet
    with pytest.raises(FileNotFoundError):
        up.resolve_table()


def test_registry_cuda_auto_is_shared_and_runs(tmp_path, monkeypatch):
    monkeypatch.delenv(at.ENV_TABLE, raising=False)
    be = gson.resolve_backend("cuda-auto")
    assert gson.resolve_backend("cuda-auto").update_phase is be.update_phase
    assert be.update_phase.select(768, 64) in at.CANDIDATES
    # the one adapter loads a table per override value
    path = at.save_table(hand_table(((8, 128, 16),), "cuda"),
                         str(tmp_path / "t.json"))
    monkeypatch.setenv(at.ENV_TABLE, path)
    assert be.update_phase.resolve_table() == at.load_table(path)
    assert be.update_phase.select(768, 64) == "cuda"
    monkeypatch.delenv(at.ENV_TABLE)
    assert be.update_phase.resolve_table() == at.load_table()
    # a short public-API run dispatches through it end to end
    spec = gson.RunSpec(variant="multi", model="gwr", sampler="sphere",
                        backend="cuda-auto", capacity=128, max_deg=12,
                        max_iterations=8, check_every=8, qe_threshold=1e-4,
                        n_probe=128, device="cpu")
    counts = (winner_lock_min.launches, update_accum.launches)
    st_a, _ = gson.run(spec, seed=0)
    st_r, _ = gson.run(spec.replace(backend="reference"), seed=0)
    assert (winner_lock_min.launches, update_accum.launches) == counts
    assert torch.equal(st_a.nbr, st_r.nbr)
    torch.testing.assert_close(st_a.w, st_r.w, rtol=1e-5, atol=1e-6)
