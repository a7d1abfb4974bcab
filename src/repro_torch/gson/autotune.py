"""Shape-aware Update-phase backend selection, measured on the card.

The port's counterpart of ``repro.gson.autotune``. No one Update-phase
implementation wins at every shape: the dense kernels
(``kernels/update_phase/ops.py``) and the winner-neighborhood slab
(``kernels/update_phase/sparse.py``) trade host ops, device launches and
gathers differently as the pool and the batch grow. This module times
both once per ``(units, capacity, m)`` cell (the slab only where it
engages, i.e. is smaller than the pool; elsewhere it runs the dense path
itself), with the plain reference timed beside them for information,
keeps the result as a versioned JSON selection table, and provides the
``cuda-auto`` backend: an ``UpdatePhaseFn`` that looks up the table with
the shapes of each call (``state.capacity``, the signal count m) and
runs the kernel backend measured fastest there. Shapes that were not measured
take the nearest measured cell in log-shape space; the live unit count
is not known from the shapes, so the lookup takes ``units = m // 2``,
the paper's m-schedule, which is how the grid is laid out.

Table resolution order (first hit wins):

1. an explicit ``table=`` argument (``SelectionTable`` or a path);
2. ``$REPRO_TORCH_AUTOTUNE_TABLE``, loaded strictly (a broken override
   raises);
3. the local cache ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
   ``.runs/torch_autotune_table.json``), written by :func:`autotune`,
   loaded leniently (an unusable cache warns and is skipped);
4. the committed ``autotune_table.json`` beside this module, measured on
   an H100 with ``python -m repro_torch.gson.autotune``.

The port reads its own variables, so a JAX table (whose cells name
``pallas``) never reaches it. A table that selects anything but ``cuda``
or ``sparse`` raises; the JAX package warns and runs the reference
instead. ``cuda-auto`` never runs the reference on a card tensor: there
``neighbor_collision="last"`` raises, as the kernel backends do.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.gson.multi import (find_winners_reference,
                                         update_phase_reference)
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams, init_state
from repro_torch.kernels.update_phase.ops import update_phase_op
from repro_torch.kernels.update_phase.sparse import (slab_shape,
                                                     update_phase_sparse)

SCHEMA_VERSION = 1
ENV_TABLE = "REPRO_TORCH_AUTOTUNE_TABLE"
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE = os.path.join(".runs", "torch_autotune_table.json")
PACKAGED_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "autotune_table.json")

# the JAX package's grid: the m-schedule (m = 2 units) across the
# production pool, the rows past the dense kernels' crossover there, and
# the big-pool, modest-batch cells the slab is for
DEFAULT_CELLS: tuple[tuple[int, int, int], ...] = (
    (32, 768, 64),
    (64, 768, 128),
    (128, 768, 256),
    (256, 768, 512),
    (384, 768, 768),
    (1024, 2048, 2048),
    (2048, 2048, 4096),
    (256, 4096, 512),
    (384, 8192, 768),
)

# TimerFn: (candidate name, zero-argument thunk) -> seconds per call.
# Injectable, so tests drive selection with a fake clock.
TimerFn = Callable[[str, Callable[[], Any]], float]


class TableSchemaError(ValueError):
    """A selection table whose ``schema`` is not SCHEMA_VERSION."""


@dataclass(frozen=True)
class Cell:
    """One measured grid point: µs per call of each backend, and the
    fastest."""

    units: int
    capacity: int
    m: int
    best: str
    t_us: Mapping[str, float]

    def to_json(self) -> dict:
        return {"units": self.units, "capacity": self.capacity,
                "m": self.m, "best": self.best, "t_us": dict(self.t_us)}

    @classmethod
    def from_json(cls, row: Mapping) -> "Cell":
        return cls(units=int(row["units"]), capacity=int(row["capacity"]),
                   m=int(row["m"]), best=str(row["best"]),
                   t_us={str(k): float(v)
                         for k, v in dict(row["t_us"]).items()})


@dataclass(frozen=True)
class SelectionTable:
    """The persisted measurement: shape cells -> fastest backend."""

    cells: tuple[Cell, ...]
    schema: int = SCHEMA_VERSION
    meta: Mapping[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"schema": self.schema, "meta": dict(self.meta),
                "cells": [c.to_json() for c in self.cells]}

    @classmethod
    def from_json(cls, payload: Mapping) -> "SelectionTable":
        schema = payload.get("schema")
        if schema != SCHEMA_VERSION:
            raise TableSchemaError(
                f"selection-table schema {schema!r} != supported "
                f"{SCHEMA_VERSION}; regenerate it with "
                f"`python -m repro_torch.gson.autotune`")
        cells = tuple(Cell.from_json(r) for r in payload.get("cells", ()))
        if not cells:
            raise ValueError("selection table has no cells")
        return cls(cells=cells, meta=dict(payload.get("meta", {})))

    def nearest(self, capacity: int, m: int,
                units: int | None = None) -> Cell:
        """Nearest measured cell in log-shape space.

        An exact ``(capacity, m)`` grid point is at distance 0 on those
        axes. ``units`` defaults to ``m // 2`` (the paper's m-schedule).
        Ties go to the smallest ``(capacity, m, units)``, so the choice is
        deterministic.
        """
        u = units if units is not None else max(1, m // 2)

        def dist(c: Cell):
            return (math.log2(c.capacity / capacity) ** 2
                    + math.log2(c.m / m) ** 2
                    + math.log2(c.units / max(1, u)) ** 2,
                    (c.capacity, c.m, c.units))

        return min(self.cells, key=dist)

    def select(self, capacity: int, m: int,
               units: int | None = None) -> str:
        """Backend name for a shape (the nearest cell's fastest)."""
        return self.nearest(capacity, m, units).best


# ---------------------------------------------------------------------------
# measurement


# the UpdatePhaseFn implementations the table chooses from, by table
# name: the instances the cuda-update and cuda-sparse backends run
CANDIDATES: Mapping[str, Any] = {
    "cuda": update_phase_op,
    "sparse": update_phase_sparse,
}
# timed beside them for information, never selected
BASELINES: Mapping[str, Any] = {"reference": update_phase_reference}


def _cell_inputs(units: int, capacity: int, m: int, *, device="cuda",
                 max_deg: int = 16, model: str = "soam", seed: int = 0):
    """One Update phase's inputs at the requested shape: ``units`` active
    pool rows drawn on the sphere, one batch of m signals, their winners
    from the plain Find Winners (outside any timer) and a lock
    permutation — the recipe of the JAX package's ``_cell_inputs``."""
    p = GSONParams(model=model)
    sampler = make_sampler("sphere")
    g = torch.Generator(device=device).manual_seed(seed)
    st = init_state(sampler(g, units), capacity=capacity, max_deg=max_deg)
    signals = sampler(g, m)
    wid, sid, d2b, _ = find_winners_reference(signals, st.w, st.active)
    prio = torch.randperm(m, generator=g, device=device, dtype=torch.int32)
    return st, signals, wid, sid, d2b, prio, p


def wall_timer(n: int = 20, warmup: int = 3, device="cuda") -> TimerFn:
    """The default timer: ``warmup`` calls, then the median host time of
    ``n`` calls, each ended by a device synchronisation (on a CUDA
    device). The host dispatches every op of these phases and the device
    waits on it, so this is the time a caller pays."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def t(_name: str, thunk: Callable[[], Any]) -> float:
        for _ in range(warmup):
            thunk()
        sync()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            thunk()
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    return t


def measure_cell(units: int, capacity: int, m: int, *,
                 candidates: Mapping[str, Any] | None = None,
                 timer: TimerFn | None = None, n: int = 20,
                 warmup: int = 3, device="cuda", **input_kw) -> Cell:
    """Time the candidates and the baselines at one shape; returns the
    measured Cell. ``sparse`` is timed only where the slab engages (it
    is the dense path elsewhere, and timing the same code twice would
    rank noise). The best is the candidates' (time, name) minimum, so
    equal readings always pick the same backend."""
    cands = dict(candidates if candidates is not None else CANDIDATES)
    _, n_tiles, slab_tiles = slab_shape(capacity, m)
    if slab_tiles >= n_tiles:
        cands.pop("sparse", None)
    timer = (timer if timer is not None
             else wall_timer(n=n, warmup=warmup, device=device))
    st, signals, wid, sid, d2b, prio, p = _cell_inputs(
        units, capacity, m, device=device, **input_kw)
    t_us: dict[str, float] = {}
    for name, fn in sorted({**BASELINES, **cands}.items()):
        t_us[name] = timer(name, functools.partial(
            fn, st, signals, wid, sid, d2b, prio, p)) * 1e6
    best = min(cands, key=lambda k: (t_us[k], k))
    return Cell(units=units, capacity=capacity, m=m, best=best, t_us=t_us)


def device_meta(device) -> dict:
    """torch and CUDA versions, and on a card its name and power limit as
    ``nvidia-smi`` reports them."""
    info = {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": str(device)}
    if torch.device(device).type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(device)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        info["nvidia_smi"] = (out.stdout.strip().splitlines() or [""])[0]
    return info


def build_table(cells: tuple[tuple[int, int, int], ...] = DEFAULT_CELLS,
                *, candidates: Mapping[str, Any] | None = None,
                timer: TimerFn | None = None, n: int = 20,
                warmup: int = 3, meta: Mapping[str, Any] | None = None,
                device="cuda") -> SelectionTable:
    """Measure a shape grid into a SelectionTable; ``meta`` defaults to
    :func:`device_meta`."""
    measured = tuple(
        measure_cell(u, c, m, candidates=candidates, timer=timer, n=n,
                     warmup=warmup, device=device)
        for (u, c, m) in cells)
    info = dict(device_meta(device) if meta is None else meta)
    return SelectionTable(cells=measured, meta=info)


# ---------------------------------------------------------------------------
# persistence


def save_table(table: SelectionTable, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table.to_json(), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _read_table(path: str) -> SelectionTable:
    with open(path) as f:
        return SelectionTable.from_json(json.load(f))


def load_table(source: str | SelectionTable | None = None,
               ) -> SelectionTable:
    """Resolve a selection table (see the module docstring's order).

    ``source``: a ready table (returned as is), a path (loaded strictly),
    or ``None`` for the env -> cache -> committed chain. Only the cache
    step is lenient (a RuntimeWarning, then the committed table).
    """
    if isinstance(source, SelectionTable):
        return source
    if source is not None:
        return _read_table(source)
    env = os.environ.get(ENV_TABLE)
    if env:
        return _read_table(env)
    cache = os.environ.get(ENV_CACHE, DEFAULT_CACHE)
    if os.path.exists(cache):
        try:
            return _read_table(cache)
        except (ValueError, OSError, KeyError) as e:
            warnings.warn(
                f"ignoring unusable autotune cache {cache!r} "
                f"({type(e).__name__}: {e}); using the committed "
                "default table", RuntimeWarning, stacklevel=2)
    return _read_table(PACKAGED_TABLE)


def autotune(cells: tuple[tuple[int, int, int], ...] = DEFAULT_CELLS,
             *, cache: str | None = None, n: int = 20, warmup: int = 3,
             device="cuda") -> SelectionTable:
    """Measure on THIS machine and write the local cache, which
    :func:`load_table` prefers to the committed table."""
    table = build_table(cells, n=n, warmup=warmup, device=device)
    save_table(table, cache or os.environ.get(ENV_CACHE, DEFAULT_CACHE))
    return table


# ---------------------------------------------------------------------------
# the cuda-auto UpdatePhaseFn


def select_update_phase(table: SelectionTable, capacity: int, m: int,
                        units: int | None = None) -> str:
    """The table's backend for a shape; a name that is not one of
    :data:`CANDIDATES` raises."""
    name = table.select(capacity, m, units)
    if name not in CANDIDATES:
        raise ValueError(
            f"autotune table selects update-phase backend {name!r}, which "
            f"cuda-auto does not run (it runs "
            f"{', '.join(sorted(CANDIDATES))}); regenerate "
            "the table with `python -m repro_torch.gson.autotune`")
    return name


def make_autotuned_update_phase(table: str | SelectionTable | None = None):
    """An ``UpdatePhaseFn`` that picks its backend per call from the
    table, by ``state.capacity`` and the signal count.

    One callable for every shape, so cohorts group on it as on any other
    backend. The table is loaded at the first call, not when the backend
    is made; with ``table=None`` once per value of
    ``$REPRO_TORCH_AUTOTUNE_TABLE``. ``neighbor_collision="last"`` takes
    the reference on CPU tensors, as in the JAX package, and raises on a
    card's, as the kernel backends do.
    """
    box: dict[str | None, SelectionTable] = {}

    def resolve_table() -> SelectionTable:
        key = os.environ.get(ENV_TABLE) if table is None else None
        if key not in box:
            box[key] = load_table(table)
        return box[key]

    def select(capacity: int, m: int, units: int | None = None) -> str:
        return select_update_phase(resolve_table(), capacity, m, units)

    def auto_update_phase(state, signals, wid, sid, d2b, prio, params,
                          signal_mask=None):
        args = (state, signals, wid, sid, d2b, prio, params, signal_mask)
        if params.neighbor_collision != "sum":
            if signals.device.type != "cpu":
                raise NotImplementedError(
                    "cuda-auto runs the Update-phase kernels, which "
                    'implement the "sum" neighbor-collision mode only; use '
                    'the reference backend for neighbor_collision="last"')
            return update_phase_reference(*args)
        return CANDIDATES[select(state.capacity, signals.shape[-2])](*args)

    auto_update_phase.resolve_table = resolve_table
    auto_update_phase.select = select
    return auto_update_phase


# ---------------------------------------------------------------------------
# CLI: measure the committed table (or a local one)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="time the port's update-phase backends per shape cell "
                    "and write a selection table")
    ap.add_argument("--out", default=PACKAGED_TABLE,
                    help="table path (default: the committed package "
                         "table)")
    ap.add_argument("--cells", default=None,
                    help="comma list of units:capacity:m triples "
                         "(default: the JAX package's grid)")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error(f"--device {args.device} but no CUDA device is available")
    cells = DEFAULT_CELLS
    if args.cells:
        cells = tuple(tuple(int(x) for x in spec.split(":"))
                      for spec in args.cells.split(",") if spec)
        if any(len(c) != 3 for c in cells):
            ap.error("--cells wants units:capacity:m triples")
    table = build_table(cells, n=args.n, warmup=args.warmup,
                        device=args.device)
    save_table(table, args.out)
    for c in table.cells:
        times = "  ".join(f"{k}={v / 1e3:.4f}ms"
                          for k, v in sorted(c.t_us.items()))
        print(f"({c.units:>5}, {c.capacity:>5}, {c.m:>5}) -> "
              f"{c.best:<9} {times}")
    print(f"[autotune] {table.meta}")
    print(f"[autotune] wrote {len(table.cells)} cells to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
