"""step_device_ms.gson: device time per fleet iteration, the sum of the
durations of every device operation in the profiled window (kernels,
copies, fills) over its iterations. The window holds the program's work
alone: its inputs were drawn before it started."""


def read(t):
    if not t.device or t.iterations <= 0:
        return None
    return sum(e - s for _, s, e in t.device) / 1e3 / t.iterations
