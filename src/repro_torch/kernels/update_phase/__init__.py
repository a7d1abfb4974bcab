"""The dense Update phase (paper Sec. 2.5) as two hand-written Hopper
kernels: the winner lock, and the per-unit accumulators with edge aging
folded into their per-slot launch. kernel.py (wrappers + plain
versions), ops.py (prologue / epilogue, the engine's ``UpdatePhaseFn``),
ref.py (the one-hot oracle)."""
from repro_torch.kernels.update_phase.kernel import (BIG_PRIO,
                                                     edge_age_plain,
                                                     update_accum,
                                                     update_accum_plain,
                                                     winner_lock_min,
                                                     winner_lock_min_plain)
from repro_torch.kernels.update_phase.ops import update_phase_op
from repro_torch.kernels.update_phase.ref import update_phase_dense
