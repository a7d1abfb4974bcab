#!/usr/bin/env python3
"""Time the port's Find Winners kernel (B1) on the card at the shapes of
PERF.md's kernel table, and the sweep that sets its regime threshold.

    python tools/bench_find_winners.py [--src DIR] [--tag NAME] [--save DIR]
                                       [--inputs FILE]
    python tools/bench_find_winners.py --sweep [--inputs FILE]
    python tools/bench_find_winners.py --compare DIR_A DIR_B

``--src`` names the tree whose ``repro_torch`` is imported (default: this
checkout's ``src``), so the script times an earlier commit too: unpack
its ``git archive`` under ``build/`` and run both trees in one call, in
turns (earlier, this, this, earlier). The shapes (d = 3):

- ``main``: M = 8192 sphere signals on a pool of C = 4096 grown by 128
  plain multi-fused iterations (seed 7, as ``chip_smoke.py``'s phase 3);
- ``b8``: B = 8 such pools (seeds 7-14), grown as one fleet;
- ``c32768``: ``main``'s pool in C = 32768 slots, the extra slots free;
- ``m1``: ``main``'s pool and its first signal alone (the ``single``
  path's shape);
- ``dense``: C = 32768 sphere points, a seeded random half of them
  active, M = 8192.

For each: device ms per call (CUDA events around 50 calls), the bound
(the larger of the bytes the function needs over 3.35 TB/s and 8 flops
per (signal, active unit) pair over 67 TFLOP/s), and the check against
the plain version (ids on rows whose three nearest distances are more
than 1e-4 apart, distances within rtol=2e-4, atol=1e-5, two calls
bitwise equal). ``--save`` keeps each shape's outputs; ``--compare``
says whether two saved runs are bitwise equal (give both runs the same
``--inputs``). ``--sweep`` times both scan regimes of this tree at
B * M from 1 to 512 and up to B = 8 networks of 8192 signals on the
pools of ``main``, ``c32768`` and ``dense``. Results go to stdout as
JSON lines, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402  (the card's helpers, no torch yet)
    device_ms, near_tie_free, nvidia_smi_line)

SEED = 7
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
D_TOL = dict(rtol=2e-4, atol=1e-5)


def bound_ms(M: int, n_act: int, C: int, D: int, B: int = 1) -> float:
    """chip_smoke.py's B1 bound, for B networks."""
    nbytes = B * ((M * D + n_act * D) * 4 + C + M * 2 * 8)
    return max(nbytes / HBM_BPS, B * M * n_act * (2 * D + 2) / FP32_FLOPS
               ) * 1e3


def grown(seeds):
    """(w (B, C, d), active (B, C)) of pools grown by a plain fleet."""
    from repro_torch import gson
    spec = gson.RunSpec(variant="multi-fused", backend="reference",
                        max_iterations=128)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=seeds))
    fleet.run()
    nets = fleet.cohorts[0].fstate.nets
    return nets.w.contiguous(), nets.active.contiguous()


def shapes(inputs: Path | None = None):
    """name -> (signals, w, active), all on the card. With ``inputs``,
    loaded from that file if it exists, else made and saved there: the
    plain backend that grows the pools adds with atomics, so two
    processes grow slightly different pools."""
    import torch
    if inputs is not None and inputs.exists():
        return {k: tuple(t.cuda() for t in v)
                for k, v in torch.load(inputs).items()}
    out = _make_shapes()
    if inputs is not None:
        inputs.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: [t.cpu() for t in v] for k, v in out.items()}, inputs)
    return out


def _make_shapes():
    import torch
    from repro_torch.core.gson.sampling import make_sampler
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sphere = make_sampler("sphere")
    w1, a1 = grown([SEED])
    w8, a8 = grown(list(range(SEED, SEED + 8)))
    sig = sphere(g, 8192)[None].contiguous()
    sig8 = torch.stack([sphere(g, 8192) for _ in range(8)])
    wide = 32768 - w1.shape[1]
    w32 = torch.cat([w1, w1.new_zeros((1, wide, 3))], 1)
    a32 = torch.cat([a1, a1.new_zeros((1, wide))], 1)
    wd = sphere(g, 32768)[None].contiguous()
    ad = torch.zeros((1, 32768), dtype=torch.bool, device=dev)
    ad[0, torch.randperm(32768, generator=g, device=dev)[:16384]] = True
    return {"main": (sig, w1, a1), "b8": (sig8, w8, a8),
            "c32768": (sig, w32, a32), "m1": (sig[:, :1].contiguous(), w1, a1),
            "dense": (sig, wd, ad)}


def check(fwk, args) -> dict:
    import torch
    sig, w, act = args
    d2k, idk = fwk.find_winners_top2(*args)
    d2k2, idk2 = fwk.find_winners_top2(*args)
    d2p, idp = fwk.find_winners_top2_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(d2k, d2k2) and torch.equal(idk, idk2), "not repeatable"
    torch.testing.assert_close(d2k, d2p, **D_TOL)
    tie_free = 0
    for b in range(sig.shape[0]):
        ok = near_tie_free(sig[b], w[b], act[b])
        assert torch.equal(idk[b][ok], idp[b][ok]), "ids differ"
        tie_free += int(ok.sum())
    return dict(out=(d2k, idk), tie_free=tie_free,
                err=float((d2k - d2p).abs().max()))


def bench(fwk, save: Path | None, tag: str, inputs: Path | None):
    import torch
    for name, args in shapes(inputs).items():
        sig, w, act = args
        B, M, D = sig.shape
        C = w.shape[1]
        got = check(fwk, args)
        n_act = int(act.sum()) // B
        row = dict(tag=tag, shape=name, B=B, M=M, C=C, n_active=n_act,
                   ms=device_ms(lambda: fwk.find_winners_top2(*args), 50),
                   bound_ms=bound_ms(M, n_act, C, D, B),
                   max_abs_err=got["err"], tie_free=got["tie_free"],
                   rows=B * M)
        if hasattr(fwk, "compact_active"):   # the first launch alone
            row["compact_ms"] = device_ms(
                lambda: fwk.compact_active(w, act), 50)
        print(json.dumps(row), flush=True)
        if save is not None:
            save.mkdir(parents=True, exist_ok=True)
            torch.save([t.cpu() for t in got["out"]], save / f"{name}.pt")


def sweep(fwk, inputs: Path | None):
    import torch
    pools = shapes(inputs)
    for pool in ("main", "c32768", "dense"):
        sig, w, act = pools[pool]
        for B, M in [(1, m) for m in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                      2048, 8192)
                     ] + [(8, m) for m in (1, 2, 4, 8, 16, 32)] + [
                (2, 8192), (4, 8192), (8, 8192)]:
            args = (sig[0, :M][None].expand(B, M, 3).contiguous(),
                    w.expand(B, -1, -1).contiguous(),
                    act.expand(B, -1).contiguous())
            ref = fwk.find_winners_top2(*args, scan="many")
            row = dict(pool=pool, C=w.shape[1], B=B, M=M,
                       chosen=fwk.regime(B, M))
            for scan in fwk.REGIMES:
                out = fwk.find_winners_top2(*args, scan=scan)
                assert all(torch.equal(a, b) for a, b in zip(out, ref)), \
                    f"regime {scan} differs at B={B} M={M}"
                row[scan] = device_ms(
                    lambda s=scan: fwk.find_winners_top2(*args, scan=s), 50)
            print(json.dumps(row), flush=True)


def compare(a: Path, b: Path) -> int:
    import torch
    bad = 0
    for f in sorted(a.glob("*.pt")):
        x, y = torch.load(f), torch.load(b / f.name)
        same = all(torch.equal(p, q) for p, q in zip(x, y))
        bad += not same
        print(json.dumps(dict(shape=f.stem, bitwise_equal=same)))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--save", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--compare", nargs=2, type=Path)
    ap.add_argument("--inputs", type=Path, help="the shapes' inputs: "
                    "loaded if the file exists, else made and saved")
    a = ap.parse_args()
    if a.compare:
        return compare(*a.compare)
    import torch
    if not torch.cuda.is_available():
        print("bench_find_winners: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, a.src)
    from repro_torch.kernels.find_winners import kernel as fwk
    print(json.dumps(dict(card=nvidia_smi_line(), src=a.src, tag=a.tag)),
          flush=True)
    if a.sweep:
        sweep(fwk, a.inputs)
    else:
        bench(fwk, a.save, a.tag, a.inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
