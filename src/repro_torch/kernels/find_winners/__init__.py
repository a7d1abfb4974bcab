"""Find Winners (paper Sec. 2.5): batched top-2 nearest-unit search as a
hand-written Hopper kernel. kernel.py (wrapper, plain versions, the
regime choice), ops.py (padding, the degenerate second slot, the engine
adapter), ref.py (the direct-difference oracle)."""
from repro_torch.kernels.find_winners.kernel import (compact_active,
                                                     compact_active_plain,
                                                     find_winners_top2,
                                                     find_winners_top2_plain,
                                                     regime)
from repro_torch.kernels.find_winners.ops import (cuda_find_winners,
                                                  find_winners_op)
from repro_torch.kernels.find_winners.ref import find_winners_ref
