"""The span pass of a traced run: the program's own spans
(``repro_torch.utils.timing``), read on the profiler's clock.

After the traced run's passes (``Driver.traced``), the first reader of
a span metric runs one more pass on the window's first job, with the
program's tracing on. It leads the job to ``N - 2P`` (P: the traffic's
``trace.iterations``) with the inputs of ``[N - 2P, N)`` drawn before
it starts, then runs

  (a) P iterations unprofiled, keeping the program's span log (host
      clock, ``time.perf_counter_ns``): the host time of each tick;
  (b) the next P iterations, the ones the profiled pass of
      ``Driver.traced`` saw, under ``torch.profiler``: every host event
      (the spans as ``record_function`` ranges, the operators, the CUDA
      runtime calls) and every device operation.

In (b) a device operation is the span's when the innermost program span
whose host interval holds the operation's launch is that span. The
launch is the runtime call that carries the operation's correlation id
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...). The spans' own ranges
on the device (user annotations, ``device_type == CUDA`` in the
profiler's events) are not operations.

The pass is kept on the readers' context (``TraceContext``) as
``spans``: ``None`` where the program records no spans (a program
without ``timing.tracing``) or no run is found. It is run from a reader
because the harness calls readers with the context alone: the run that
made the context is the caller's, found on the stack (``_driver_of``).
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
import time
from collections import defaultdict

PREFIX = "gson."
TICK = "gson.tick"
WAIT = "gson.wait"
# runtime calls that block the host until the device has caught up; a
# blocking copy (``.cpu()``, ``.to(device)`` of a host tensor) shows as a
# ``cudaMemcpyAsync`` followed by a ``cudaStreamSynchronize``
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


@dataclasses.dataclass
class SpanTrace:
    """What the span pass saw."""

    iterations: int   # fleet iterations in each of (a) and (b)
    log: list         # (a): (name, start ns, end ns, depth, tick)
    host: list        # (b): (name, start us, end us, correlation id)
    device: list      # (b): (name, start us, end us, correlation id)
    wall_a_s: float = 0.0   # host wall of (a)
    wall_b_s: float = 0.0   # host wall of (b), profiled


# ---------------------------------------------------------------------------
# from the profiler


def _times(e):
    s = e.start_ns()
    return s / 1e3, (s + e.duration_ns()) / 1e3


def collect(prof) -> tuple:
    """(host, device) records of a finished ``torch.profiler`` window,
    on its clock (us). Device records leave out user annotations."""
    import torch
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = _times(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            note = getattr(e, "is_user_annotation", lambda: False)()
            if not note and not name.startswith(PREFIX):
                device.append((name, s, t, e.correlation_id()))
        else:
            host.append((name, s, t, e.correlation_id()))
    return host, device


# ---------------------------------------------------------------------------
# reductions (plain records: testable without a profiler)


def _runtime(name: str) -> bool:
    """A CUDA runtime or driver call (``cuda*``, ``cu*``), not an
    operator or a span."""
    return name.startswith("cu")


class Spans:
    """The program spans among host records, for innermost lookups."""

    def __init__(self, host):
        self.spans = sorted((s, t, n) for n, s, t, _ in host
                            if n.startswith(PREFIX))
        self.starts = [s for s, _, _ in self.spans]

    def innermost(self, at: float):
        """The name of the innermost span open at ``at``, or None: of the
        spans that hold it, the one that opened last."""
        i = bisect.bisect_right(self.starts, at) - 1
        while i >= 0:
            s, t, n = self.spans[i]
            if t >= at:
                return n
            i -= 1
        return None

    def of(self, name: str) -> list:
        return [(s, t) for s, t, n in self.spans if n == name]


def launches(host, device) -> list:
    """The launch time of each device record (us): the start of the
    runtime call of its correlation id; None where there is none."""
    runtime = {c: s for n, s, _, c in host if _runtime(n)}
    return [runtime.get(c) for _, _, _, c in device]


def device_us(host, device) -> dict:
    """{innermost span (None: none): device us} over the device records."""
    spans = Spans(host)
    out = defaultdict(float)
    for (_, s, t, _), at in zip(device, launches(host, device)):
        out[None if at is None else spans.innermost(at)] += t - s
    return dict(out)


def _inside(at: float, intervals) -> bool:
    return any(s <= at <= t for s, t in intervals)


def syncs(host) -> int:
    """Synchronising runtime calls (``SYNCS``) that began inside a
    ``gson.tick`` span."""
    return sum(syncs_by_span(host).values())


def syncs_by_span(host) -> dict:
    """{innermost span: synchronising runtime calls} inside ``gson.tick``
    spans."""
    spans = Spans(host)
    ticks = spans.of(TICK)
    out = defaultdict(int)
    for n, s, _, _ in host:
        if n in SYNCS and _inside(s, ticks):
            out[spans.innermost(s)] += 1
    return dict(out)


def dispatch_ns(log) -> int:
    """Host ns inside ``gson.tick`` spans but outside the ``gson.wait``
    spans of the same tick, from a span log."""
    ticks = defaultdict(int)
    for name, s, t, _, tick in log:
        if name == TICK:
            ticks[tick] += t - s
    for name, s, t, _, tick in log:
        if name == WAIT and tick in ticks:
            ticks[tick] -= t - s
    return sum(ticks.values())


def idle_by_span(host, device) -> dict:
    """{innermost span at the middle of each idle gap of the device
    (None: no span): idle us}, between its first and last operation."""
    spans = Spans(host)
    busy = []
    for _, s, t, _ in sorted(device, key=lambda x: x[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        out[spans.innermost(0.5 * (e0 + s1))] += s1 - e0
    return dict(out)


# ---------------------------------------------------------------------------
# the pass


def _driver_of(t):
    """The driver of the run whose readers are reading ``t``: an object
    with ``traced`` and ``_session`` in a calling frame that holds
    ``t``."""
    f = sys._getframe(1)
    while f is not None:
        local = f.f_locals
        if any(v is t for v in local.values()):
            for v in local.values():
                if hasattr(v, "traced") and hasattr(v, "_session"):
                    return v
        f = f.f_back
    return None


def of(t):
    """The span pass of ``t``'s run (a ``SpanTrace``), run on the first
    call and kept on ``t`` as ``spans``; None where there is none."""
    if not hasattr(t, "spans"):
        drv = _driver_of(t)
        t.spans = run(drv) if drv is not None else None
    return t.spans


def run(drv):
    """(a) and (b) on ``drv``'s first job (see the module's docstring);
    None where the program records no spans."""
    try:
        from repro_torch.utils.timing import clear, spans, tracing
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    P = int(drv.traffic["trace"]["iterations"])
    lead = drv.N - 2 * P
    if lead < 0:
        return None
    sess, inputs = drv._session(0)
    sess.run(budget=lead)
    inputs.prefetch(range(lead, drv.N))
    drv.sync()
    clear()
    try:
        with tracing(True):
            t0 = time.perf_counter()
            sess.run(budget=P)
            drv.sync()
            wall_a = time.perf_counter() - t0
            log = spans()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sess.run(budget=P)
                drv.sync()
                wall_b = time.perf_counter() - t0
    finally:
        clear()
    host, device = collect(prof)
    del sess, inputs
    if drv.device.type == "cuda":
        torch.cuda.empty_cache()
    out = SpanTrace(iterations=P, log=log, host=host, device=device,
                    wall_a_s=wall_a, wall_b_s=wall_b)
    report(out)
    return out


def report(st: SpanTrace) -> None:
    """Per fleet iteration, to standard error: device ms by innermost
    span, their sum, idle ms by span, syncs and host ms in (a)."""
    P = st.iterations

    def per_it(d):
        return {str(k): round(v / 1e3 / P, 4) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])}
    dev = device_us(st.host, st.device)
    print(f"gpubench.spans: device ms/it by span {per_it(dev)}; sum "
          f"{sum(dev.values()) / 1e3 / P:.4f}; idle ms/it by span "
          f"{per_it(idle_by_span(st.host, st.device))}; syncs/it "
          f"{syncs(st.host) / P:.4f} {syncs_by_span(st.host)}; waits/it "
          f"{len(Spans(st.host).of(WAIT)) / P:.4f}; (a) host ms/it "
          f"{st.wall_a_s * 1e3 / P:.4f}, dispatch "
          f"{dispatch_ns(st.log) / 1e6 / P:.4f}; (b) host ms/it "
          f"{st.wall_b_s * 1e3 / P:.4f}", file=sys.stderr)
