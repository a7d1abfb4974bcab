"""device_idle_pct.gson: the share of the profiled window's host wall in
which no device operation ran (operations that overlap count once)."""


def read(t):
    if not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
