"""Public wrapper for the Update-phase kernel suite.

``update_phase_op`` implements the engine's ``UpdatePhaseFn`` contract
(see ``repro_torch.core.gson.multi``): a PyTorch prologue does the O(m)
per-signal gathers and decisions, the three kernels do every per-unit
reduction — the lock's minimum, the weight / habituation / error
accumulators, edge aging — and a PyTorch epilogue applies the
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

from repro_torch.core.gson import topology as topo
from repro_torch.core.gson.multi import (UpdateOut, stable_units,
                                         update_phase_inputs)
from repro_torch.core.gson.state import GSONParams, NetworkState
from repro_torch.kernels.update_phase.kernel import (BIG_PRIO, edge_age,
                                                     update_accum,
                                                     winner_lock_min)


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
    """The dense Update phase through the kernels.

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
    m = signals.shape[0]
    is_gng = params.model == "gng"
    wid = wid.to(torch.int32).contiguous()

    # ---- kernel B2: winner lock (per-unit min priority) --------------------
    mask = (torch.ones((m,), dtype=torch.bool, device=signals.device)
            if signal_mask is None else signal_mask)
    prio_masked = torch.where(mask, prio.to(torch.int32), BIG_PRIO)
    best = winner_lock_min(wid[None], prio_masked[None].contiguous(), C)[0]
    selected = (prio_masked == best[wid.clamp(0, C - 1).long()]) & mask

    # ---- shared per-signal prologue ----------------------------------------
    (ins, adapt, scale_b, dec_b, _h_b, _nb, _nb_valid, scale_n,
     dec_n) = update_phase_inputs(state, wid, d2b, selected, params)
    stable_u = stable_units(state, params)

    # ---- kernel B3: fused per-unit accumulators ----------------------------
    def b1(t):
        return t.contiguous()[None]

    w1, nsc, nsx, err_u, decb_u, decn_u, wind = (
        o[0] for o in update_accum(
            b1(signals), b1(wid), b1(selected), b1(adapt), b1(scale_b),
            b1(d2b), b1(dec_b), b1(scale_n), b1(dec_n), b1(state.nbr),
            b1(state.w)))
    # neighbor pull epilogue: sum_i s_i * (x_i - w1) == nsx - nsc * w1
    w2 = w1 + (nsx - nsc[:, None] * w1)
    firing = (state.firing if is_gng else
              (state.firing - decb_u - decn_u).clamp(params.h_min, 1.0))
    error = state.error + err_u if is_gng else state.error
    win_ind = wind > 0.0

    # ---- kernel B4: fused edge aging + winner-second refresh ---------------
    reset = topo.edge_slots(state.nbr, wid, sid, adapt)
    age = edge_age(b1(state.age), b1(state.nbr), b1(win_ind), b1(stable_u),
                   b1(reset))[0]

    return UpdateOut(selected=selected, adapt=adapt, ins=ins,
                     w=w2, firing=firing, error=error, age=age)
