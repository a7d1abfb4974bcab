"""The single-signal algorithm: the paper's sequential baseline.

The port's counterpart of ``repro.core.gson.single``. The single-signal
algorithm IS the multi-signal step at m = 1 (the winner lock always
keeps the lone signal, so its priority is 0 and no draw is needed), so
this module runs the shared step over a chunk of signals one at a time.
That makes the coherence between the two variants, a design goal the
paper states, testable.

Only Find Winners is pluggable here; the Update phase is the
reference's, as in the JAX package. The SOAM refresh falls after signal
i of the chunk where ``(i + 1) % refresh_every == 0``, the counter
restarting at 0 with every chunk, as the JAX scan's does.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson.batch import batchable
from repro_torch.core.gson.multi import (FindWinnersFn, multi_signal_step,
                                         refresh_topology)
from repro_torch.core.gson.state import GSONParams, NetworkState


@batchable(3)
def single_signal_scan(
    state: NetworkState,
    signals: torch.Tensor,
    params: GSONParams,
    refresh_every: int = 50,
    find_winners: FindWinnersFn | None = None,
) -> NetworkState:
    """Process ``signals`` (B, n, dim) strictly one at a time, for every
    network of the batch."""
    B, n = signals.shape[:2]
    prio = torch.zeros((B, 1), dtype=torch.int32, device=signals.device)
    is_soam = params.model == "soam"
    for i in range(n):
        state = multi_signal_step(state, signals[:, i:i + 1], params, prio,
                                  refresh_states=False,
                                  find_winners=find_winners)
        if is_soam and (i + 1) % refresh_every == 0:
            state = refresh_topology(state, params)
    return state
