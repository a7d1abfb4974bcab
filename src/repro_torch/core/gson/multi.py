"""The paper's multi-signal iteration (Sec. 2.2/2.5) in PyTorch.

One call processes m >> 1 signals at once:

  1. Find Winners  — batched top-2 nearest-unit search (pluggable: the
     plain reference below, or the Hopper kernel of
     ``repro_torch.kernels.find_winners``).
  2. Winner lock   — among signals sharing a winner, exactly one (lowest
     random priority) survives; the rest are *discarded* (paper Sec. 2.2).
  3. Update        — adaptation + structural changes, vectorized.

Both hot phases are pluggable, as in ``repro.core.gson.multi``:
``find_winners`` swaps the top-2 search (``FindWinnersFn``) and
``update_phase`` the dense half of the Update phase (``UpdatePhaseFn``):
winner lock, weight pulls, habituation, error accumulation and edge
aging. The discrete structural tail (unit and edge insertion, expiry,
pruning) is shared plain PyTorch.

The lock priorities are an argument here: the JAX step splits them off
the state's PRNG key, the port draws them through ``repro_torch.rng``.

Every function takes a leading network axis B (state leaves ``(B, ...)``,
signals ``(B, M, d)``, per-signal arrays ``(B, M)``), which is how a
fleet steps all its networks at once (``repro_torch.core.gson.fleet``);
called without it, a function runs as a fleet of one. Both backend
contracts are batched.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.gson import topology as topo
from repro_torch.core.gson.batch import add, batchable, put, take
from repro_torch.core.gson.state import (DISK, SINGULAR, GSONParams,
                                         NetworkState)
from repro_torch.utils.timing import span

BIG32 = 2 ** 31 - 1

# (signals (B, M, d), w (B, C, d), active (B, C)) -> (winner_ids,
# second_ids, d2_winner, d2_second), each (B, M).
FindWinnersFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                         tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]]


class UpdateOut(NamedTuple):
    """Result of the dense Update phase (see ``UpdatePhaseFn``)."""

    selected: torch.Tensor   # (B, m) bool — winner-lock survivors
    adapt: torch.Tensor      # (B, m) bool — survivors that adapt (vs insert)
    ins: torch.Tensor        # (B, m) bool — GWR/SOAM insertion triggers
    w: torch.Tensor          # (B, C, dim) f32 adapted reference vectors
    firing: torch.Tensor     # (B, C) f32 habituation counters
    error: torch.Tensor      # (B, C) f32 GNG error accumulator
    age: torch.Tensor        # (B, C, K) f32 aged (and refreshed) ages


# (state, signals, wid, sid, d2b, prio, params, signal_mask) -> UpdateOut,
# all batched. ``prio`` is a permutation of range(m) per network, int32:
# the lock priorities.
UpdatePhaseFn = Callable[..., UpdateOut]


@batchable(3)
def find_winners_reference(signals: torch.Tensor, w: torch.Tensor,
                           active: torch.Tensor):
    """Plain batched top-2 nearest units.

    dist^2 = |x|^2 - 2 x.w + |w|^2 as a matrix product, top-2 by two
    masked argmin passes (first lowest id on ties). Returns
    (winner_ids, second_ids, d2_winner, d2_second).
    """
    x2 = (signals * signals).sum(dim=-1, keepdim=True)          # (B, m, 1)
    w2 = (w * w).sum(dim=-1)                                    # (B, C)
    d2 = (x2 - torch.bmm(2.0 * signals, w.transpose(1, 2))
          + w2[:, None, :])                                     # (B, m, C)
    d2 = torch.where(active[:, None, :], d2, torch.inf)
    wid = d2.argmin(dim=-1)
    d2b = torch.gather(d2, -1, wid[..., None])[..., 0]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    d2m = torch.where(cols == wid[..., None], torch.inf, d2)
    sid = d2m.argmin(dim=-1)
    d2s = torch.gather(d2m, -1, sid[..., None])[..., 0]
    # degenerate (<2 active): duplicate the winner
    invalid = ~torch.isfinite(d2s)
    sid = torch.where(invalid, wid, sid)
    d2s = torch.where(invalid, d2b, d2s)
    return (wid.to(torch.int32), sid.to(torch.int32),
            d2b.clamp(min=0.0), d2s.clamp(min=0.0))


@batchable(2)
def winner_lock(prio: torch.Tensor, winner_ids: torch.Tensor,
                capacity: int, mask: torch.Tensor | None = None):
    """Paper's collision rule: one surviving signal per distinct winner.

    ``prio`` holds unique random priorities (a permutation of range(m));
    a scatter-min keeps the lowest per winner, so the survivor is uniform
    among the colliding signals — the paper's 'first incoming signal, in
    a random order'. Rows with ``mask`` False never survive and never
    out-prioritize a valid row. Returns ``(selected, prio)`` with the
    masked priorities.
    """
    prio = prio.to(torch.int32)
    if mask is not None:
        prio = torch.where(mask, prio, BIG32)
    best = torch.full((prio.shape[0], capacity), BIG32, dtype=torch.int32,
                      device=prio.device)
    wid = winner_ids.long()
    best = best.scatter_reduce(1, wid, prio, reduce="amin")
    selected = prio == torch.gather(best, 1, wid)
    if mask is not None:
        selected = selected & mask
    return selected, prio


@batchable(3)
def refresh_topology(state: NetworkState,
                     params: GSONParams) -> NetworkState:
    """Recompute the SOAM state ladder + adapt per-unit insertion
    thresholds toward the local feature size (tighten while stuck
    non-disk, relax once locally stable)."""
    with span("gson.refresh"):
        topo_state = topo.compute_topo_states(
            state.nbr, state.active, state.firing, params.firing_threshold)
        habituated = state.firing < params.firing_threshold
        stable = (topo_state >= DISK) & (topo_state != SINGULAR)
        stuck = state.active & habituated & ~stable
        inconsistent = torch.where(stuck, state.inconsistent_for + 1, 0)
        tighten = inconsistent >= params.stuck_window
        thr_min = params.insertion_threshold * params.thr_min_frac
        threshold = torch.where(
            tighten,
            (state.threshold * params.thr_decay).clamp(min=thr_min),
            state.threshold)
        inconsistent = torch.where(tighten, 0, inconsistent)
        threshold = torch.where(
            state.active & stable,
            (threshold * params.thr_recover).clamp(
                max=params.insertion_threshold),
            threshold)
        return state.replace(topo_state=topo_state, threshold=threshold,
                             inconsistent_for=inconsistent)


@batchable(3)
def stable_units(state: NetworkState, params: GSONParams) -> torch.Tensor:
    """(B, C) bool — units frozen in place by SOAM crystallization."""
    if params.model == "soam" and params.freeze_stable:
        return (state.topo_state >= DISK) & (state.topo_state != SINGULAR)
    return torch.zeros(state.active.shape, dtype=torch.bool,
                       device=state.device)


@batchable(3)
def update_phase_inputs(state: NetworkState, wid: torch.Tensor,
                        d2b: torch.Tensor, selected: torch.Tensor,
                        params: GSONParams):
    """Shared per-signal prologue of the dense Update phase.

    From the lock survivors, derive every per-signal decision and
    coefficient the adaptation needs. One definition serves both
    :func:`update_phase_reference` and the kernel wrapper
    (``repro_torch.kernels.update_phase.ops``).

    Returns ``(ins, adapt, scale_b, dec_b, h_b, nb, nb_valid, scale_n,
    dec_n)`` with ``scale_n``/``dec_n`` zeroed on invalid slots and
    stable units' scales zeroed (SOAM freeze).
    """
    C = state.capacity
    is_gng = params.model == "gng"
    wc = wid.clamp(0, C - 1).long()
    h_b = take(state.firing, wc)
    if is_gng:
        ins = torch.zeros_like(selected)
    else:
        ins = (selected
               & (torch.sqrt(d2b) > take(state.threshold, wc))
               & (h_b < params.firing_threshold))
    adapt = selected if is_gng else (selected & ~ins)

    stable_u = stable_units(state, params)
    scale_b = params.eps_b * (torch.ones_like(h_b) if is_gng else h_b)
    scale_b = torch.where(take(stable_u, wc), 0.0, scale_b)
    dec_b = (torch.zeros_like(h_b) if is_gng
             else params.tau_b * (h_b - params.h_min))

    nb = take(state.nbr, wc)                                  # (B, m, K)
    nb_valid = (nb >= 0) & adapt[..., None]
    nb_safe = nb.clamp(0, C - 1).long()
    h_n = take(state.firing, nb_safe)
    scale_n = params.eps_n * (torch.ones_like(h_n) if is_gng else h_n)
    scale_n = torch.where(take(stable_u, nb_safe), 0.0, scale_n)
    scale_n = torch.where(nb_valid, scale_n, 0.0)
    dec_n = (torch.zeros_like(h_n) if is_gng
             else torch.where(nb_valid,
                              params.tau_n * (h_n - params.h_min), 0.0))
    return ins, adapt, scale_b, dec_b, h_b, nb, nb_valid, scale_n, dec_n


@batchable(3)
def update_phase_reference(
    state: NetworkState,
    signals: torch.Tensor,
    wid: torch.Tensor,
    sid: torch.Tensor,
    d2b: torch.Tensor,
    prio: torch.Tensor,
    params: GSONParams,
    signal_mask: torch.Tensor | None = None,
) -> UpdateOut:
    """The dense Update phase, scatter-based (the plain reference path).

    Winner lock, insertion decision, winner + neighbor weight pulls,
    habituation, GNG error accumulation, edge aging on winner rows and
    the winner-second edge-age refresh. Per-unit sums are scatter-adds;
    on a CUDA tensor those use float atomics, so their order (and the
    last ulp of a sum with several contributors) varies from run to run.
    The Hopper kernels of ``repro_torch.kernels.update_phase`` sum in a
    fixed order instead.
    """
    C = state.capacity
    is_gng = params.model == "gng"

    # ---- 2. winner lock ----------------------------------------------------
    selected, prio = winner_lock(prio, wid, C, signal_mask)
    sel_w = torch.where(selected, wid, C)

    # ---- 3a. per-signal decisions + coefficients (shared prologue) ---------
    (ins, adapt, scale_b, dec_b, _h_b, nb, nb_valid, scale_n,
     dec_n) = update_phase_inputs(state, wid, d2b, selected, params)

    # ---- 3b. adaptation of winner + neighbors ------------------------------
    w = state.w
    firing = state.firing
    stable_u = stable_units(state, params)
    wc = wid.clamp(0, C - 1).long()
    delta_b = scale_b[..., None] * (signals - take(w, wc))
    w = add(w, (torch.where(adapt, wid, C),), delta_b)

    nb_safe = nb.clamp(0, C - 1).long()
    delta_n = scale_n[..., None] * (signals[..., None, :]
                                    - take(w, nb_safe))
    delta_n = torch.where(nb_valid[..., None], delta_n, 0.0)
    nb_tgt = torch.where(nb_valid, nb, C).long()
    if params.neighbor_collision == "sum":
        w = add(w, (nb_tgt,), delta_n)
    else:  # "last": GPU write-race emulation — one survivor per target row
        B = nb.shape[0]
        flat_nb = nb_tgt.reshape(B, -1)
        flat_prio = prio[..., None].expand(nb.shape).reshape(B, -1)
        best_n = torch.full((B, C + 1), BIG32, dtype=torch.int32,
                            device=w.device)
        best_n = best_n.scatter_reduce(1, flat_nb, flat_prio,
                                       reduce="amin")[:, :C]
        keep = flat_prio == torch.gather(best_n, 1, flat_nb.clamp(0, C - 1))
        tgt = torch.where(keep & (flat_nb < C), flat_nb, C)
        w = add(w, (tgt,), delta_n.reshape(B, -1, w.shape[-1]))

    # ---- 3c. habituation (GWR/SOAM) ----------------------------------------
    if not is_gng:
        firing = add(firing, (torch.where(adapt, wid, C),), -dec_b)
        firing = add(firing, (nb_tgt,), -dec_n)
        firing = firing.clamp(params.h_min, 1.0)

    # ---- 3d. GNG error bookkeeping -----------------------------------------
    error = state.error
    if is_gng:
        error = add(error, (sel_w,), d2b)

    # ---- 3e. edge aging on winner rows (distinct winners post-lock) --------
    age = topo.age_incident_edges(state.nbr, state.age, wid, selected,
                                  protect=stable_u)
    age = topo.reset_edge_ages(state.nbr, age, wid, sid, adapt)

    return UpdateOut(selected=selected, adapt=adapt, ins=ins,
                     w=w, firing=firing, error=error, age=age)


@batchable(3)
def multi_signal_step(
    state: NetworkState,
    signals: torch.Tensor,
    params: GSONParams,
    prio: torch.Tensor,
    refresh_states: bool = True,
    find_winners: FindWinnersFn | None = None,
    signal_mask: torch.Tensor | None = None,
    update_phase: UpdatePhaseFn | None = None,
    fw_aux=None,
) -> NetworkState:
    """One multi-signal iteration of every network. ``signals``:
    (B, m, dim) float32.

    ``prio``: (B, m) int32, a permutation of range(m) per network — the
    lock priorities.

    ``signal_mask``: optional (B, m) bool. Rows with mask False are inert:
    they never win the lock, never adapt/insert, and are not counted as
    consumed signals. The fused loop keeps one static ``max_parallel``
    buffer and masks in its first ``m_t`` rows.

    ``fw_aux``: optional precomputed search structure of a *stateful*
    Find Winners backend (``find_winners.stateful`` is True, e.g. the
    ``repro_torch.ann`` hash grid), every leaf batched. Such a backend
    provides ``build(w, active) -> aux`` and takes the result as
    ``__call__(..., aux=)``; the loop drivers carry the aux and rebuild
    it on the refresh cadence. ``None`` means the backend rebuilds
    internally: always correct, just not amortized.

    The input state is not modified; a new state is returned.
    """
    if find_winners is None:
        find_winners = find_winners_reference
    if update_phase is None:
        update_phase = update_phase_reference
    C = state.capacity
    dev = state.device
    B, m = signals.shape[:2]
    m_eff = (torch.full((B,), m, dtype=torch.int32, device=dev)
             if signal_mask is None
             else signal_mask.sum(dim=-1, dtype=torch.int32))
    is_gng = params.model == "gng"
    is_soam = params.model == "soam"

    # ---- 1. Find Winners ---------------------------------------------------
    with span("gson.find_winners"):
        if fw_aux is not None:
            wid, sid, d2b, _ = find_winners(signals, state.w, state.active,
                                            aux=fw_aux)
        else:
            wid, sid, d2b, _ = find_winners(signals, state.w, state.active)

    # ---- 2-3e. dense Update phase (pluggable backend) ----------------------
    with span("gson.update"):
        up = update_phase(state, signals, wid, sid, d2b, prio, params,
                          signal_mask)
        selected, adapt, ins = up.selected, up.adapt, up.ins
        w, firing, error, age = up.w, up.firing, up.error, up.age
        n_sel = selected.sum(dim=-1, dtype=torch.int32)
        nbr = state.nbr

    # ---- 3f. GWR/SOAM unit insertion ---------------------------------------
    with span("gson.tail"):
        active = state.active
        threshold = state.threshold
        topo_state = state.topo_state
        inconsistent = state.inconsistent_for
        n_active = state.n_active
        dropped_units = state.dropped_units

        # inactive first
        free_order = torch.argsort(active.to(torch.int32), dim=-1,
                                   stable=True).to(torch.int32)
        n_free = (C - n_active)[:, None]
        wc = wid.clamp(0, C - 1).long()

        def take_free(fits, rank):
            slot = torch.gather(free_order, -1, rank.clamp(0, C - 1).long())
            return torch.where(fits, slot, C)

        if not is_gng:
            rank = torch.cumsum(ins.to(torch.int32), -1,
                                dtype=torch.int32) - 1
            fits = ins & (rank < n_free)
            dropped_units = dropped_units + (ins & ~fits).sum(
                dim=-1, dtype=torch.int32)
            new_id = take_free(fits, rank)
            nid = (new_id.long(),)
            w_new = 0.5 * (take(w, wc) + signals)
            w = put(w, nid, w_new)
            active = put(active, nid, True)
            firing = put(firing, nid, 1.0)
            error = put(error, nid, 0.0)
            threshold = put(threshold, nid, take(threshold, wc))
            topo_state = put(topo_state, nid, 0)
            inconsistent = put(inconsistent, nid, 0)
            n_active = n_active + fits.sum(dim=-1, dtype=torch.int32)

            # edges: (new, b) and (new, s); drop (b, s)
            e_a = torch.cat([new_id, new_id], dim=-1)
            e_b = torch.cat([wid, sid], dim=-1)
            e_m = torch.cat([fits, fits], dim=-1)
            nbr, age, d1 = topo.insert_edges(nbr, age, e_a, e_b, e_m)
            nbr, age = topo.remove_edge_pairs(nbr, age, wid, sid, fits)
            # refresh/insert (b, s) for adapting signals
            nbr, age, d2_ = topo.insert_edges(nbr, age, wid, sid, adapt)
            dropped_edges = state.dropped_edges + d1 + d2_
        else:
            nbr, age, d2_ = topo.insert_edges(nbr, age, wid, sid, selected)
            dropped_edges = state.dropped_edges + d2_

        # ---- 3g. GNG periodic insertion at max-error units -----------------
        eff_old = state.signal_count - state.discarded
        eff_new = eff_old + n_sel
        if is_gng:
            with span("gson.gng_insert"):
                k_cap = 8  # static cap on inserts per iteration
                lam = params.gng_lambda
                n_ins = ((eff_new // lam)
                         - (eff_old // lam)).clamp(0, k_cap)
                err_masked = torch.where(active, error, -torch.inf)
                # lax.top_k order: descending, ties to the lower index
                q_ids = torch.sort(err_masked, dim=-1, descending=True,
                                   stable=True).indices[:, :k_cap]
                take_q = (torch.arange(k_cap, device=dev) < n_ins[:, None])
                # worst neighbor f of each q
                q_nb = take(nbr, q_ids)                       # (B, k, K)
                q_nb_err = torch.where(
                    q_nb >= 0, take(error, q_nb.clamp(0, C - 1).long()),
                    -torch.inf)
                f_slot = q_nb_err.argmax(dim=-1)
                f_ids = torch.gather(q_nb, -1, f_slot[..., None])[..., 0]
                take_q = take_q & (f_ids >= 0)
                rank = torch.cumsum(take_q.to(torch.int32), -1,
                                    dtype=torch.int32) - 1
                fits = take_q & (rank < n_free)
                dropped_units = dropped_units + (take_q & ~fits).sum(
                    dim=-1, dtype=torch.int32)
                new_id = take_free(fits, rank)
                nid = (new_id.long(),)
                f_safe = f_ids.clamp(0, C - 1).long()
                w_new = 0.5 * (take(w, q_ids) + take(w, f_safe))
                w = put(w, nid, w_new)
                active = put(active, nid, True)
                firing = put(firing, nid, 1.0)
                n_active = n_active + fits.sum(dim=-1, dtype=torch.int32)
                # error redistribution: one multiplication per hit, in order
                units = torch.arange(C, device=dev)
                for ids in (q_ids, f_ids.long()):
                    for j in range(k_cap):
                        hit = fits[:, j:j + 1] & (units == ids[:, j:j + 1])
                        error = torch.where(hit, error * params.gng_alpha,
                                            error)
                error = put(error, nid, params.gng_alpha * take(error, q_ids))
                q32 = q_ids.to(torch.int32)
                e_a = torch.cat([new_id, new_id], dim=-1)
                e_b = torch.cat([q32, f_ids], dim=-1)
                e_m = torch.cat([fits, fits], dim=-1)
                nbr, age, d3 = topo.insert_edges(nbr, age, e_a, e_b, e_m)
                nbr, age = topo.remove_edge_pairs(nbr, age, q32, f_ids, fits)
                dropped_edges = dropped_edges + d3
                # global error decay, once per effective signal
                decay = torch.full((), 1.0 - params.gng_beta,
                                   dtype=torch.float32, device=dev)
                error = error * torch.pow(
                    decay, n_sel.to(torch.float32))[:, None]

        # ---- 3h. expiry + pruning ------------------------------------------
        nbr, age, _ = topo.expire_edges(nbr, age, params.age_max)
        active, _ = topo.prune_isolated(active, nbr, firing)
        n_active = active.sum(dim=-1, dtype=torch.int32)
        nbr = torch.where(active[..., None], nbr, -1)
        nbr, age = topo.drop_edges_to_inactive(nbr, age, active)

        out = state.replace(
            w=w, active=active, nbr=nbr, age=age, error=error, firing=firing,
            threshold=threshold, topo_state=topo_state,
            inconsistent_for=inconsistent, n_active=n_active,
            signal_count=state.signal_count + m_eff,
            discarded=state.discarded + (m_eff - n_sel),
            dropped_edges=dropped_edges, dropped_units=dropped_units,
        )
    # ---- 3i. SOAM: topology states + adaptive insertion threshold ----------
    if is_soam and refresh_states:
        out = refresh_topology(out, params)
    return out


@batchable(3)
def soam_converged(state: NetworkState) -> torch.Tensor:
    """Paper's termination, per network: every unit's neighborhood is a
    (patch of a) disk — threshold-free. Requires a fresh ``topo_state``.
    Returns (B,) bool."""
    stable = (state.topo_state == DISK) | (state.topo_state == DISK + 1)
    return torch.where(state.active, stable, True).all(dim=-1) & (
        state.n_active >= 4)
