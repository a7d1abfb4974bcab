"""find_winners_roofline_pct.gson: kernel B1's share of its roofline:
the least time Find Winners' counted work needs (``gpubench.work``)
over the time in which its two launches ran in the profiled window."""
from gpubench import trace, work

KERNELS = ("fw_compact_kernel", "fw_scan_kernel")


def read(t):
    ran = trace.busy_seconds(trace.named(t.device, KERNELS))
    rows = t.work.get("find_winners", [])
    if ran <= 0 or not rows:
        return None
    return 100.0 * sum(work.least_seconds(f, b) for f, b in rows) / ran
