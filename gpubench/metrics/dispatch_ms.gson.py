"""dispatch_ms.gson: host time per fleet iteration inside the program's
span ``gson.tick`` but outside its ``gson.wait`` spans (the blocking
reads of the device): the time the run driver takes to issue an
iteration's work. From the span log of the span pass's unprofiled
stretch (``gpubench.spans``): the profiler's own host cost would swamp
it in the profiled one."""
from gpubench import spans


def read(t):
    st = spans.of(t)
    if st is None or not st.log:
        return None
    return spans.dispatch_ns(st.log) / 1e6 / st.iterations
