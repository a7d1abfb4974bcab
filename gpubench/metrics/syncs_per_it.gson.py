"""syncs_per_it.gson: runtime calls per fleet iteration that block the
host until the device has caught up, issued inside the program's span
``gson.tick``, in the profiled stretch of the span pass
(``gpubench.spans``). Counted by name (``spans.SYNCS``):
``cudaStreamSynchronize`` (each ``.cpu()`` of a device tensor, after
its ``cudaMemcpyAsync``), ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, the blocking copies ``cudaMemcpy`` and
``cudaMemcpy2D``, and the driver API's counterparts. A reading above the
``gson.wait`` spans per iteration means syncs outside them: implicit
ones."""
from gpubench import spans


def read(t):
    st = spans.of(t)
    if st is None or not st.device:
        return None
    return spans.syncs(st.host) / st.iterations
