"""From a ``torch.profiler`` window to device intervals and breakdowns.

``profile(fn)`` runs ``fn`` under the profiler (CPU and CUDA activity)
and returns the host wall of the window, every device operation
(kernels, copies, fills) as ``(name, start_us, end_us)`` and the host's
top-level operations the same way. The reductions below read those
lists: the time in which any device operation ran (intervals merged, so
operations that overlap count once), the operations that took most
device time, and the idle gaps of the device named by the host
operation that was running in them.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict


def profile(fn, sync):
    """(wall s, device events, host events) of one profiled ``fn()``;
    ``sync()`` waits for the device before the window and at its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
        elif e.cpu_parent is None:
            host.append(span)
    return wall, device, host


def merged(events) -> list:
    """The union of the events' intervals, as sorted (start, end) us."""
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_seconds(events) -> float:
    return sum(e - s for s, e in merged(events)) / 1e6


def named(events, names) -> list:
    """The events whose name contains one of ``names``."""
    return [ev for ev in events if any(n in ev[0] for n in names)]


def top_device_ops(events, n: int = 10) -> list:
    """[[name, seconds], ...]: device time by operation name, largest
    first."""
    tot = defaultdict(float)
    for name, s, e in events:
        tot[name[:160]] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device, host, n: int = 10) -> list:
    """[[host operation, seconds], ...]: the device's idle time between
    its first and last operation, by the top-level host operation that
    was running at the middle of each gap ("python" between operations),
    largest first."""
    spans = merged(device)
    ops = sorted(host, key=lambda x: x[1])
    starts = [s for _, s, _ in ops]
    tot = defaultdict(float)
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        # top-level host operations of one thread do not overlap
        name = ops[i][0][:160] if i >= 0 and ops[i][2] >= mid else "python"
        tot[name] += (s1 - e0) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
