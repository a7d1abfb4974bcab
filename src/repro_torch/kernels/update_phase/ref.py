"""Plain oracle for the update_phase kernel suite.

Computes the dense Update phase through full (m, capacity) one-hot
matrices and whole-array contractions — the TPU kernels' algorithm with
the tiling stripped away, and a numerically distinct witness from the
scatter-based engine reference (``update_phase_reference``). O(m C K)
memory: for tests at small sizes.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson import topology as topo
from repro_torch.core.gson.multi import BIG32, UpdateOut, stable_units
from repro_torch.core.gson.state import GSONParams, NetworkState


def update_phase_dense(
    state: NetworkState,
    signals: torch.Tensor,
    wid: torch.Tensor,
    sid: torch.Tensor,
    d2b: torch.Tensor,
    prio: torch.Tensor,
    params: GSONParams,
    signal_mask: torch.Tensor | None = None,
) -> UpdateOut:
    """UpdatePhaseFn contract via dense one-hot contractions."""
    if params.neighbor_collision != "sum":
        raise NotImplementedError(
            "the dense update-phase formulation implements the "
            'deterministic "sum" neighbor-collision mode only')
    C = state.capacity
    m = signals.shape[0]
    dev = signals.device
    f32 = torch.float32
    is_gng = params.model == "gng"
    units = torch.arange(C, dtype=torch.int32, device=dev)

    # ---- winner lock: masked min-reduce over the winner one-hot ------------
    mask = (torch.ones((m,), dtype=torch.bool, device=dev)
            if signal_mask is None else signal_mask)
    prio_m = torch.where(mask, prio.to(torch.int32), BIG32)
    onehot = wid[:, None] == units[None, :]
    best = torch.where(onehot, prio_m[:, None], BIG32).min(dim=0).values
    wc = wid.clamp(0, C - 1).long()
    selected = (prio_m == best[wc]) & mask

    # ---- per-signal decisions (identical formulas to the reference) --------
    if is_gng:
        ins = torch.zeros((m,), dtype=torch.bool, device=dev)
    else:
        ins = (selected & (torch.sqrt(d2b) > state.threshold[wc])
               & (state.firing[wc] < params.firing_threshold))
    adapt = selected if is_gng else (selected & ~ins)

    stable_u = stable_units(state, params)
    h_b = state.firing[wc]
    scale_b = params.eps_b * (torch.ones_like(h_b) if is_gng else h_b)
    scale_b = torch.where(stable_u[wc], 0.0, scale_b)

    # ---- winner pull: one-hot copy (post-lock winners are distinct) --------
    o_adapt = (onehot & adapt[:, None]).to(f32)
    o_sel = (onehot & selected[:, None]).to(f32)
    scale_vec = o_adapt.T @ scale_b[:, None]                  # (C, 1)
    sel_x = o_adapt.T @ signals                               # (C, d)
    w1 = state.w + scale_vec * (sel_x - state.w)

    # ---- neighbor pulls: slot-summed weighted one-hot ----------------------
    nb = state.nbr[wc]
    nb_valid = (nb >= 0) & adapt[:, None]
    nb_safe = nb.clamp(0, C - 1).long()
    h_n = state.firing[nb_safe]
    scale_n = params.eps_n * (torch.ones_like(h_n) if is_gng else h_n)
    scale_n = torch.where(stable_u[nb_safe], 0.0, scale_n)
    scale_n = torch.where(nb_valid, scale_n, 0.0)
    nb_k = torch.where(nb_valid, nb, -1)
    o_nb = (nb_k[:, :, None] == units[None, None, :]).to(f32)
    wn = (o_nb * scale_n[:, :, None]).sum(dim=1)              # (m, C)
    nsc = wn.sum(dim=0)[:, None]                              # (C, 1)
    nsx = wn.T @ signals                                      # (C, d)
    w2 = w1 + (nsx - nsc * w1)

    # ---- habituation + GNG error -------------------------------------------
    if is_gng:
        firing = state.firing
        error = state.error + (o_sel.T @ d2b[:, None])[:, 0]
    else:
        dec_b = params.tau_b * (h_b - params.h_min)
        dec_n = torch.where(nb_valid, params.tau_n * (h_n - params.h_min),
                            0.0)
        dn = (o_nb * dec_n[:, :, None]).sum(dim=1)
        firing = (state.firing - (o_adapt.T @ dec_b[:, None])[:, 0]
                  - dn.sum(dim=0)).clamp(params.h_min, 1.0)
        error = state.error

    # ---- edge aging + winner-second refresh --------------------------------
    nbr = state.nbr
    safe = nbr.clamp(0, C - 1).long()
    win_ind = (o_sel > 0.0).any(dim=0)
    valid = nbr >= 0
    winat = win_ind[safe] & valid
    keep = stable_u[:, None] & stable_u[safe]
    inc = ((win_ind[:, None].to(f32) + winat.to(f32)) * valid.to(f32)
           * (1.0 - keep.to(f32)))
    reset = topo.edge_slots(nbr, wid, sid, adapt)
    age = torch.where(reset, 0.0, state.age + inc)

    return UpdateOut(selected=selected, adapt=adapt, ins=ins,
                     w=w2, firing=firing, error=error, age=age)
