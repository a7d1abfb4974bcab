"""The readings that the limits of ``gpubench/reference/gng_compare.py``
are set from: the program's, the control's and each planted fault's,
seed by seed, in one process.

    python3 -m gpubench.gng_control --workload gng4k.fleet256 \
        --seeds 11,12,13 [--control-seeds 1] [--jobs 1]

For each seed it runs ``--jobs`` jobs of the cell as a run's window does
(the same driver, entry and sizes, capturing the same states), then
judges the program's states against the float32 reference and, for the
first ``--control-seeds`` seeds, puts in the program's place the control
(the reference with its distance product in TF32) and each planted fault
of ``gng_compare.FAULTS``, from the same states. One JSON line per seed.
The benchmark's own runs never run these.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from gpubench import catalog
from gpubench.reference import gng_compare
from gpubench.run import ROOT, NoCard, import_program


def _numbers(tally) -> dict:
    return {"numbers": {k: v for k, v, _, _ in tally.numbers()},
            "worst": tally.worst, "ties": tally.ties,
            "compared": tally.compared, "trajectories": tally.trajectories}


def readings(root, workload: str, seeds, control_seeds: int, jobs: int = 1,
             device: str | None = None):
    """Yields one dict per seed."""
    import torch
    bench = catalog.Bench(root)
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device")
        device = "cuda:0"
    import_program(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Driver = catalog.driver(cfg["driver"])
    for n, seed in enumerate(seeds):
        drv = Driver(cfg, traffic, seed, device)
        if n == 0:
            drv.setup()
        t0 = time.perf_counter()
        for _ in range(jobs):
            drv.window(0.0)
        run_s = time.perf_counter() - t0
        drv.free()
        t0 = time.perf_counter()
        row = {"seed": seed, "program": _numbers(drv.check())}
        row["run_s"], row["check_s"] = run_s, time.perf_counter() - t0
        if n < control_seeds:
            row["control"] = _numbers(drv.check(
                control=gng_compare.control_step(drv.params)))
            for fault in gng_compare.FAULTS:
                row[fault] = _numbers(drv.check(
                    control=gng_compare.fault_step(drv.params, fault)))
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    try:
        for row in readings(ROOT, args.workload, seeds, args.control_seeds,
                            args.jobs):
            print(json.dumps(row), flush=True)
    except NoCard as e:
        print(f"gpubench.gng_control: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
