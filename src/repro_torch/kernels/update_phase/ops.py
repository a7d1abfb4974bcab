"""Public wrapper for the Update-phase kernel suite.

``update_phase_op`` implements the engine's ``UpdatePhaseFn`` contract
(see ``repro_torch.core.gson.multi``) for a fleet of B networks, one
launch of each kernel for the whole fleet: a PyTorch prologue does the O(m)
per-signal gathers and decisions, two kernels do every per-unit
reduction — the lock's minimum, then the weight / habituation / error
accumulators with edge aging and the winner-second reset in one call
(three device launches in all) — and a PyTorch epilogue applies the
accumulators elementwise.

Numerics against ``update_phase_reference``:

  * bitwise: ``selected`` / ``adapt`` / ``ins`` (the integer lock and
    comparisons), winner weight pulls and habituation (one contributor
    per unit), GNG error, edge ages;
  * within about 1e-6: neighbor pulls and neighbor habituation where
    several signals share a neighbor — the kernel sums them in slot
    order, the reference in scatter order.

``neighbor_collision="last"`` (the GPU write-race emulation mode) is not
implemented: the op raises, as the JAX one does.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson.batch import batchable, take
from repro_torch.core.gson.multi import (UpdateOut, stable_units,
                                         update_phase_inputs)
from repro_torch.core.gson.state import GSONParams, NetworkState
from repro_torch.kernels.update_phase.kernel import (BIG_PRIO,
                                                     update_accum,
                                                     winner_lock_min)


@batchable(3)
def update_phase_op(
    state: NetworkState,
    signals: torch.Tensor,
    wid: torch.Tensor,
    sid: torch.Tensor,
    d2b: torch.Tensor,
    prio: torch.Tensor,
    params: GSONParams,
    signal_mask: torch.Tensor | None = None,
) -> UpdateOut:
    """The dense Update phase through the kernels for every network of a
    fleet, one launch of each kernel: (B, m) per-signal arrays, state
    leaves (B, ...).

    Same contract as ``repro_torch.core.gson.multi.update_phase_reference``
    (winner lock -> insertion decision -> weight pulls -> habituation
    -> error -> edge aging + winner-second refresh).
    """
    if params.neighbor_collision != "sum":
        raise NotImplementedError(
            "the update-phase kernels implement the deterministic "
            '"sum" neighbor-collision mode only; use the reference '
            'backend to study neighbor_collision="last"')
    C = state.capacity
    is_gng = params.model == "gng"
    wid = wid.to(torch.int32).contiguous()

    # ---- kernel B2: winner lock (per-unit min priority) --------------------
    mask = (torch.ones(wid.shape, dtype=torch.bool, device=signals.device)
            if signal_mask is None else signal_mask)
    prio_masked = torch.where(mask, prio.to(torch.int32), BIG_PRIO)
    best = winner_lock_min(wid, prio_masked.contiguous(), C)
    selected = (prio_masked == take(best, wid.clamp(0, C - 1).long())) & mask

    # ---- shared per-signal prologue ----------------------------------------
    (ins, adapt, scale_b, dec_b, _h_b, _nb, _nb_valid, scale_n,
     dec_n) = update_phase_inputs(state, wid, d2b, selected, params)
    stable_u = stable_units(state, params)

    # ---- kernels B3 + B4: per-unit accumulators, edge aging and the
    # winner-second refresh in one call -------------------------------------
    w1, nsc, nsx, err_u, decb_u, decn_u, _wind, age = update_accum(*(
        t.contiguous() for t in (
            signals, wid, selected, adapt, scale_b, d2b, dec_b, scale_n,
            dec_n, state.nbr, state.w, sid.to(torch.int32), state.age,
            stable_u)))
    # neighbor pull epilogue: sum_i s_i * (x_i - w1) == nsx - nsc * w1
    w2 = w1 + (nsx - nsc[..., None] * w1)
    firing = (state.firing if is_gng else
              (state.firing - decb_u - decn_u).clamp(params.h_min, 1.0))
    error = state.error + err_u if is_gng else state.error

    return UpdateOut(selected=selected, adapt=adapt, ins=ins,
                     w=w2, firing=firing, error=error, age=age)
