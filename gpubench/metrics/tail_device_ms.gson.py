"""tail_device_ms.gson: device time per fleet iteration of the
operations launched inside the program's span ``gson.tail`` (the
structural tail: ``core/gson/multi.py`` 3f-3h, ``topology.py``,
``batch.py``), in the profiled stretch of the span pass
(``gpubench.spans``): the profiled pass's iterations."""
from gpubench import spans


def read(t):
    st = spans.of(t)
    if st is None or not st.device:
        return None
    return spans.device_us(st.host, st.device).get(
        "gson.tail", 0.0) / 1e3 / st.iterations
