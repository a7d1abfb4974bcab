"""The SOAM topology refresh (the state ladder of every unit) as a
hand-written Hopper kernel. kernel.py (the wrapper); the plain version
is ``repro_torch.core.gson.topology.compute_topo_states_plain``."""
from repro_torch.kernels.topo_states.kernel import topo_states
