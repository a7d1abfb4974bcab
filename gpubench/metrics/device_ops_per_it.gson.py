"""device_ops_per_it.gson: device operations launched per fleet
iteration in the profiled window, which holds the program's work alone
(its inputs were drawn before it started)."""


def read(t):
    if not t.device or t.iterations <= 0:
        return None
    return len(t.device) / t.iterations
