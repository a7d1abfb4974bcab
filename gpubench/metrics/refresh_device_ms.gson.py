"""refresh_device_ms.gson: device time per fleet iteration of the
operations launched inside the program's span ``gson.refresh`` (the SOAM
refresh, ``refresh_topology`` and ``topology.compute_topo_states``, from
each of its call sites: the step's, the loop's cadence, the check's), in
the profiled stretch of the span pass (``gpubench.spans``)."""
from gpubench import spans


def read(t):
    st = spans.of(t)
    if st is None or not st.device:
        return None
    return spans.device_us(st.host, st.device).get(
        "gson.refresh", 0.0) / 1e3 / st.iterations
