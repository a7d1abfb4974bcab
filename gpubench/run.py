"""Run one benchmark cell once, on the CUDA card this process is given.

    python3 -m gpubench.run --workload sphere4k.fleet64 --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. The cell, its configuration, its traffic
and its metrics are found by name (``gpubench.catalog``); the program
under test is the checkout's ``src/repro_torch``.

A run: set-up (imports, the kernels built or loaded, one short warm-up
job at the cell's shapes: ``setup_s``, from the start of this module),
then the measured window of ``--seconds``, then with ``--trace 1`` a
profiled stretch, then the check against the plain reference, which
runs once the window has closed, the peak memory has been read and the
program's memory has been released. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared beside its limit, which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits with code 2 and prints no result; it exits with code 3 if a module
of JAX or of the JAX package was loaded. Kernel builds go to
``build/kernels`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    pass


def forbidden_modules(names=None) -> list:
    """Module names (default: the loaded ones) whose top-level name, the
    part before the first dot, is one of ``FORBIDDEN``, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def import_program(root: Path):
    """``repro_torch`` from ``root/src``, and from nowhere else."""
    src = (Path(root) / "src").resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise FileNotFoundError(f"the program is missing: {src}/repro_torch")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise ImportError(f"repro_torch came from {repro_torch.__file__}, "
                          f"not {src}")
    return repro_torch


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi: {e}"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device: str | None = None) -> dict:
    """One run of one cell; returns the result object. ``device=None``
    takes the card (and raises ``NoCard`` without enough of them); a
    test passes ``"cpu"`` to drive the rest of a run without one."""
    import torch

    from gpubench import catalog

    bench = catalog.Bench(root)
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device: this benchmark runs on the card")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise NoCard(f"the cell asks for {wl['chips']} cards, this "
                         f"host has {torch.cuda.device_count()}")
        device = "cuda:0"
        build = Path(root) / "build"
        os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
        os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    on_card = device.startswith("cuda")
    import_program(root)
    # the configuration states float32: no TF32 anywhere in the process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    drv = catalog.driver(cfg["driver"])(cfg, traffic, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - T_START
    e2e = drv.window(seconds)
    e2e["setup_s"] = setup_s
    ctx = drv.traced() if traced else None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.free()
    t_check = time.perf_counter()
    tally = drv.check()
    check_s = time.perf_counter() - t_check
    print(f"gpubench: setup {setup_s:.3f} s, check {check_s:.3f} s, "
          f"{drv.attempted} networks in {drv.jobs} jobs; the reference's "
          f"own trajectories (iterations before the first near tie, "
          f"iterations judged): {tally.trajectories}", file=sys.stderr)

    metrics = {}
    if traced:
        for m in bench.metrics("per_layer", workload):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in bench.metrics("end_to_end", workload):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(wl["chips"]) if on_card else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": tally.correct, "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": dev}
    if traced:
        from gpubench import trace
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(ctx.device),
            "idle_gaps": trace.idle_gaps(ctx.device, ctx.host)}
    result["card"] = card_line() if on_card else "cpu"
    result["check"] = {name: {"value": v, "limit": lim, "holds": sense}
                       for name, v, lim, sense in tally.numbers()}
    result["check"]["worst"] = tally.worst
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    loaded = forbidden_modules()
    if loaded:
        print(f"gpubench: modules of JAX or the JAX package were loaded: "
              f"{loaded}", file=sys.stderr)
        return 3
    print(f"card: {result['card']}", file=sys.stderr)
    for name, c in result["check"].items():
        if isinstance(c, dict):
            rel = "<=" if c["holds"] == "max" else ">="
            print(f"check {name} {c['value']!r} {rel} {c['limit']!r}",
                  file=sys.stderr)
        else:
            print(f"check {name} {c}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
