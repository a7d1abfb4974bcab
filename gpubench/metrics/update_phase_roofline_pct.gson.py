"""update_phase_roofline_pct.gson: kernels B2-B4's share of their
roofline: the least time the Update phase's counted work needs
(``gpubench.work``) over the time in which the lock's and the
accumulators' launches ran in the profiled window."""
from gpubench import trace, work

KERNELS = ("lock_tile_kernel", "owner_scatter_kernel", "accum_group_kernel")


def read(t):
    ran = trace.busy_seconds(trace.named(t.device, KERNELS))
    rows = t.work.get("update_phase", [])
    if ran <= 0 or not rows:
        return None
    return 100.0 * sum(work.least_seconds(f, b) for f, b in rows) / ran
