"""mfu_pct.gson: the whole iteration's share of the H100's peak: the
least time its counted work needs at the published peaks
(``gpubench.work``), over the host wall of the same iterations run
without the profiler."""
from gpubench import work


def read(t):
    rows = t.work.get("iteration", [])
    if not rows or t.unprofiled_s <= 0 or not t.device:
        return None
    least = sum(work.least_seconds(f, b) for f, b in rows)
    return 100.0 * least / t.unprofiled_s
