"""gng_insert_device_ms.gng: device time per fleet iteration of the
operations launched inside the program's span ``gson.gng_insert`` (GNG's
periodic insertion at the units of largest error, ``core/gson/multi.py``
3g: the sort of the errors through the global error decay), in the
profiled stretch of the span pass (``gpubench.spans``). A program
without that span reads nothing."""
from gpubench import spans

SPAN = "gson.gng_insert"


def read(t):
    st = spans.of(t)
    if st is None or not st.device:
        return None
    us = spans.device_us(st.host, st.device).get(SPAN)
    return None if us is None else us / 1e3 / st.iterations
