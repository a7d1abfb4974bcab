"""Tracing's host cost in the GSON loop, on the card.

    python3 tools/tracing_cost.py --workload sphere4k.fleet64 --seed 7 \
        [--blocks 32]      # a multiple of 4: whole off-on-on-off rounds

Runs the first job of a benchmark cell (``gpubench``'s driver, inputs
and sizes) to ``N - blocks * P`` (P: the cell's ``trace.iterations``),
with the inputs of the rest drawn before, then ``--blocks`` stretches of
P iterations with the program's tracing (``repro_torch.utils.timing``)
off and on in turn, off-on-on-off, so that a drift along the job cancels
in each pair; each stretch is timed on the host clock to a synchronise.
Prints one JSON line: the walls of both sides, each pair's cost of
tracing on as a share of off, their median, and the span summary.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import catalog
    from gpubench.run import import_program
    import_program(ROOT)
    import torch
    from repro_torch.utils import timing
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    bench = catalog.Bench(ROOT)
    wl = bench.workload(args.workload)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    drv = catalog.driver(cfg["driver"])(cfg, traffic, args.seed, "cuda:0")
    drv.setup()
    P = int(traffic["trace"]["iterations"])
    start = drv.N - args.blocks * P
    if start < 1:     # the inputs are drawn at the rows a run has seen
        ap.error(f"--blocks {args.blocks} of {P} leave no iteration of "
                 f"the job's {drv.N} to lead with")
    sess, inputs = drv._session(0)
    sess.run(budget=start)
    inputs.prefetch(range(start, drv.N))
    drv.sync()
    walls = {False: [], True: []}
    timing.clear()
    for b in range(args.blocks):
        on = b % 4 in (1, 2)
        with timing.tracing(on):
            t0 = time.perf_counter()
            sess.run(budget=P)
            drv.sync()
            walls[on].append(time.perf_counter() - t0)
    cost = [(on - off) / off for on, off in zip(walls[True], walls[False])]
    row = {"workload": args.workload, "seed": args.seed, "iterations": P,
           "start": start, "off_s": walls[False], "on_s": walls[True],
           "off_median_s": statistics.median(walls[False]),
           "on_median_s": statistics.median(walls[True]),
           "pair_cost": cost, "cost_median": statistics.median(cost),
           "summary": timing.summary()}
    timing.clear()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
