"""The span pass (``gpubench.spans``) and its readers, on a synthetic
trace: two ticks of program spans, kernels tied to their launches by
correlation id, a span's range on the device, and synchronising runtime
calls; then the pass itself in a traced run of the tiny cell."""
from __future__ import annotations

import types

import pytest

from gpubench import catalog, spans
from gpubench.drivers.gson_fleet import TraceContext
from gpubench.tests.conftest import REPO, TINY_CELL

NEW = ("tail_device_ms.gson", "refresh_device_ms.gson", "dispatch_ms.gson",
       "syncs_per_it.gson")
OLD = ("device_idle_pct.gson", "mfu_pct.gson", "step_device_ms.gson",
       "device_ops_per_it.gson", "find_winners_roofline_pct.gson",
       "update_phase_roofline_pct.gson")

# host: (name, start us, end us, correlation id); operators and spans
# number from 1, CUPTI's runtime calls from 1000
HOST = [
    ("gson.tick", 0, 100, 1),
    ("gson.draws", 2, 8, 2),
    ("aten::cat", 3, 7, 3),
    ("cudaLaunchKernel", 4, 5, 1001),
    ("gson.tail", 10, 40, 4),
    ("aten::argsort", 11, 20, 5),
    ("cudaLaunchKernel", 12, 13, 1002),
    ("cudaLaunchKernel", 14, 15, 1003),
    ("gson.check", 50, 90, 6),
    ("gson.refresh", 51, 60, 7),
    ("cudaLaunchKernel", 52, 53, 1004),
    ("gson.wait", 70, 88, 8),
    ("cudaMemcpyAsync", 71, 72, 1005),
    ("cudaStreamSynchronize", 72, 87, 1006),
    ("gson.tick", 100, 200, 9),
    ("gson.tail", 110, 130, 10),
    ("aten::gather", 111, 119, 11),
    ("cudaLaunchKernel", 112, 113, 1009),
    ("gson.wait", 150, 190, 12),
    ("cudaStreamSynchronize", 151, 189, 1007),
    ("cudaDeviceSynchronize", 250, 260, 1008),   # after the ticks
]
# device: (name, start us, end us, correlation id)
DEVICE = [
    ("cat_kernel", 20, 22, 1001),          # gson.draws: 2
    ("radixSort", 30, 40, 1002),           # gson.tail: 10
    ("gather_kernel", 40, 44, 1003),       # gson.tail: 4
    ("reduce_bool", 60, 80, 1004),         # gson.refresh: 20
    ("Memcpy DtoH", 80, 81, 1005),         # gson.wait: 1
    ("gather_kernel", 140, 146, 1009),     # gson.tail: 6
]
# (a)'s log: (name, start ns, end ns, depth, tick)
LOG = [
    ("gson.tail", 10, 40, 1, 0), ("gson.wait", 70, 88, 1, 0),
    ("gson.tick", 0, 100, 0, 0),
    ("gson.wait", 150, 190, 1, 1), ("gson.tick", 100, 200, 0, 1),
]


class Event:
    """A raw profiler event, as ``kineto_results.events()`` has them."""

    def __init__(self, name, s, e, corr, cuda=False, note=False):
        import torch
        self._v = dict(name=name, start_ns=int(s * 1e3),
                       duration_ns=int((e - s) * 1e3), correlation_id=corr,
                       is_user_annotation=note,
                       device_type=torch.autograd.DeviceType.CUDA if cuda
                       else torch.autograd.DeviceType.CPU)

    def __getattr__(self, k):
        return lambda: self._v[k]


def fake_profile():
    events = [Event(n, s, e, c, note=n.startswith("gson."))
              for n, s, e, c in HOST]
    events += [Event(*d, cuda=True) for d in DEVICE]
    # the spans' own ranges on the device: not operations
    events.append(Event("gson.tail", 30, 44, 4, cuda=True, note=True))
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def context(with_spans: bool):
    t = TraceContext(device=[(n, s, e) for n, s, e, _ in DEVICE],
                     host=[("aten::cat", 3, 7)], window_s=300e-6,
                     busy_s=40e-6, iterations=2, unprofiled_s=250e-6,
                     work={"iteration": [(1e6, 1e6)] * 2,
                           "find_winners": [(1e3, 1e3)],
                           "update_phase": [(1e3, 1e3)]})
    if with_spans:
        host, device = spans.collect(fake_profile())
        t.spans = spans.SpanTrace(iterations=2, log=LOG, host=host,
                                  device=device)
    return t


@pytest.fixture(scope="module")
def bench():
    return catalog.Bench(REPO)


def test_collect_keeps_host_events_and_drops_annotations():
    host, device = spans.collect(fake_profile())
    assert [h[0] for h in host] == [h[0] for h in HOST]
    assert host[0] == pytest.approx(("gson.tick", 0.0, 100.0, 1))
    assert [d[0] for d in device] == [d[0] for d in DEVICE]


def test_attribution_by_correlation_id():
    host, device = spans.collect(fake_profile())
    assert spans.launches(host, device) == pytest.approx(
        [4, 12, 14, 52, 71, 112])
    got = spans.device_us(host, device)
    assert got == pytest.approx({"gson.draws": 2, "gson.tail": 20,
                                 "gson.refresh": 20, "gson.wait": 1})
    # a launch outside every span, and one with no runtime call
    extra = [("k", 300, 301, 1008), ("k", 302, 305, 4242)]
    assert spans.device_us(host, device + extra)[None] == pytest.approx(4)


def test_innermost_span_and_idle_gaps():
    sp = spans.Spans(HOST)
    assert [sp.innermost(x) for x in (1, 12, 45, 55, 75, 95, 205)] == [
        "gson.tick", "gson.tail", "gson.tick", "gson.refresh",
        "gson.wait", "gson.tick", None]
    # busy [20, 22], [30, 44], [60, 81], [140, 146]: gaps of 8, 16 and
    # 59 us around 26 (a tail), 52 (a refresh) and 110.5 (a tail)
    assert spans.idle_by_span(HOST, DEVICE) == pytest.approx(
        {"gson.tail": 8 + 59, "gson.refresh": 16})


def test_syncs_and_dispatch():
    assert spans.syncs(HOST) == 2          # the one after the ticks: no
    assert spans.dispatch_ns(LOG) == (100 - 18) + (100 - 40)


def test_readers_give_their_known_values(bench):
    t = context(True)
    got = {m: bench.reader(m)(t) for m in NEW}
    assert got == pytest.approx({
        "tail_device_ms.gson": 20e-3 / 2, "refresh_device_ms.gson": 20e-3 / 2,
        "dispatch_ms.gson": 142e-6 / 2, "syncs_per_it.gson": 1.0})


def test_readers_without_the_span_pass_read_nothing(bench):
    t = context(False)
    assert {m: bench.reader(m)(t) for m in NEW} == dict.fromkeys(NEW)
    assert t.spans is None


def test_old_readers_read_the_same_with_the_new_fields(bench):
    plain, spanned = context(False), context(True)
    for m in OLD:
        assert bench.reader(m)(plain) == bench.reader(m)(spanned), m
    assert bench.reader("step_device_ms.gson")(spanned) == pytest.approx(
        43e-3 / 2)


def test_a_program_without_spans_gives_no_pass(monkeypatch):
    from repro_torch.utils import timing
    monkeypatch.delattr(timing, "tracing")
    assert spans.run(object()) is None


def test_the_pass_runs_in_a_traced_run(tiny_root):
    from gpubench import run
    res = run.run_cell(tiny_root, TINY_CELL, 2 ** 32 + 77, 0.2, True,
                       device="cpu")
    assert res["correct"], res["check"]
    # host time is read on the CPU too; no device ran, so nothing else
    assert res["metrics"]["dispatch_ms.gson"]["value"] > 0
    assert not {"tail_device_ms.gson", "refresh_device_ms.gson",
                "syncs_per_it.gson"} & set(res["metrics"])
