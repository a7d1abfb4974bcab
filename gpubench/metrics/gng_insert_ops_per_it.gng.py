"""gng_insert_ops_per_it.gng: device operations per fleet iteration
launched inside the program's span ``gson.gng_insert`` (see
``gng_insert_device_ms.gng``), in the profiled stretch of the span pass
(``gpubench.spans``): an operation is the span's when it is the
innermost program span open at the operation's launch. A program
without that span reads nothing."""
from gpubench import spans

SPAN = "gson.gng_insert"


def read(t):
    st = spans.of(t)
    if st is None or not st.device:
        return None
    inner = spans.Spans(st.host)
    n = sum(1 for at in spans.launches(st.host, st.device)
            if at is not None and inner.innermost(at) == SPAN)
    return n / st.iterations if n else None
