"""The port's spans (``repro_torch.utils.timing``) inside the GSON loop.

A B = 2 ``FleetSession`` (``multi``, SOAM, capacity 64) on the CPU:

  * tracing off: ``span`` hands out one shared no-op context, the log
    stays empty and a profiler window holds no ``gson.*`` event;
  * tracing on, 12 iterations: the log and the profiler hold each span
    with the counts the cadences give, nested as the loop nests them,
    and every span of a tick carries that tick's number;
  * the fleet's states are bitwise equal with tracing on and off.

On the card (``-m cuda``): every device operation of one profiled tick
is attributed to a program span, and the spans' own ranges on the device
are not counted as operations.
"""
from __future__ import annotations

import contextlib
import sys
import tracemalloc
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import gson
from repro_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
ITERS = 12
FIELDS = ("w", "active", "nbr", "age", "error", "firing", "threshold",
          "topo_state", "inconsistent_for", "n_active", "signal_count",
          "discarded")
NAMES = ("gson.tick", "gson.draws", "gson.find_winners", "gson.update",
         "gson.tail", "gson.refresh", "gson.screen", "gson.check",
         "gson.wait")
# the cadences of 12 iterations of ``multi`` (refresh every 5, check and
# screen every 10): refreshes before iterations 0, 5, 10 and in the
# check after iteration 9; screens before iterations 0 and 10; one count
# read per tick, one per screen, one per check
COUNTS = {"gson.tick": ITERS, "gson.draws": ITERS,
          "gson.find_winners": ITERS, "gson.update": ITERS,
          "gson.tail": ITERS, "gson.refresh": 3 + 1, "gson.screen": 2,
          "gson.check": 1, "gson.wait": ITERS + 2 + 1}
# (span, the span it opens in)
PARENTS = {("gson.draws", "gson.tick"), ("gson.find_winners", "gson.tick"),
           ("gson.update", "gson.tick"), ("gson.tail", "gson.tick"),
           ("gson.refresh", "gson.tick"), ("gson.refresh", "gson.check"),
           ("gson.screen", "gson.tick"), ("gson.check", "gson.tick"),
           ("gson.wait", "gson.tick"), ("gson.wait", "gson.screen"),
           ("gson.wait", "gson.check")}


def fleet(device="cpu"):
    spec = gson.RunSpec(variant="multi", capacity=64, n_probe=128,
                        device=device)
    sess = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=(3, 4)))
    sess.active                    # starts it: its first count read
    return sess


def parents(log) -> set:
    """(span, innermost span holding it) of a span log."""
    out, stack = set(), []
    for name, s, e, depth, _ in sorted(log, key=lambda x: (x[1], x[3])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        assert depth == len(stack), (name, depth, stack)
        if stack:
            out.add((name, stack[-1][0]))
        stack.append((name, e))
    return out


def profiled_names(fn) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events()
                   if e.name.startswith("gson."))


def test_off_is_one_shared_noop_and_records_nothing():
    timing.clear()
    a, b = timing.span("gson.tick"), timing.span("gson.tail", tick=3)
    assert a is b
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(1000):
        with timing.span("gson.tail"):
            pass
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.count_diff > 0
             and d.traceback[0].filename in (timing.__file__,
                                             contextlib.__file__)]
    assert grown == []
    sess = fleet()
    got = profiled_names(lambda: sess.run(budget=ITERS))
    assert got == Counter() and timing.spans() == []


def test_on_counts_nesting_and_ticks():
    sess = fleet()
    timing.clear()
    with timing.tracing(True):
        assert timing.span("gson.tick") is not timing.span("gson.tick")
        got = profiled_names(lambda: sess.run(budget=ITERS))
    log, text = timing.spans(), timing.summary()
    timing.clear()
    assert timing.span("gson.tick") is timing.span("gson.wait")
    by_name = Counter(x[0] for x in log)
    # the stream's last tick finds no work left: a tick span, no step
    assert by_name == dict(COUNTS, **{"gson.tick": ITERS + 1})
    assert got == by_name
    assert parents(log) == PARENTS
    ticks = [x for x in log if x[0] == "gson.tick"]
    assert [x[4] for x in ticks] == list(range(ITERS + 1))
    for name, s, e, _, tick in log:
        assert s <= e
        holder = [t for t in ticks if t[1] <= s and e <= t[2]]
        assert len(holder) == 1 and holder[0][4] == tick, name
    for name in NAMES:
        assert name in text


def test_states_bitwise_equal_on_and_off():
    off, on = fleet(), fleet()
    off.run(budget=ITERS)
    with timing.tracing(True):
        on.run(budget=ITERS)
    timing.clear()
    for i in range(2):
        a, b = off.network(i), on.network(i)
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (i, f)
    assert (off.iterations == on.iterations).all()


@pytest.mark.cuda
def test_on_the_card_every_operation_is_a_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gpubench import spans
    sess = fleet("cuda:0")
    sess.run(budget=9)
    torch.cuda.synchronize()
    with timing.tracing(True):
        # ticks 10 (a check after it) and 11 (a screen and a refresh)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sess.run(budget=2)
            torch.cuda.synchronize()
    timing.clear()
    host, device = spans.collect(prof)
    assert device
    assert not [d for d in device if d[0].startswith("gson.")]
    notes = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name.startswith("gson.")]
    assert notes, "the spans' ranges on the device"
    by_span = spans.device_us(host, device)
    assert None not in by_span, by_span
    assert sum(by_span.values()) == pytest.approx(
        sum(t - s for _, s, t, _ in device))
    assert {"gson.tail", "gson.refresh", "gson.find_winners",
            "gson.update", "gson.screen", "gson.check",
            "gson.wait"} <= set(by_span)
    # the ticks' count reads, the screen's and the check's
    assert spans.syncs(host) >= 4
