"""Mixture-of-Experts FFN of the port (``repro.models.moe``'s
counterpart), with JAX's two paths over one parameter layout.

* ``mesh=None``: the dense reference path. Every expert runs on every
  token and the top-k gate combines them (exact: no capacity drops).
* a mesh with a ``model`` axis: expert parallelism (``moe_ffn_ep``),
  JAX's ``shard_map`` body run by every rank of the mesh on its own
  block. The experts are split over ``model``; a rank's tokens are its
  rows of the batch, further split over ``model`` by sequence when the
  sequence divides it (each token routed once), else routed redundantly
  by every ``model`` rank (decode, S = 1), every rank then taking the
  result of ``model`` rank 0's copy (the value JAX reports). Tokens
  travel to their experts' ranks and back through two ``all_to_all``
  calls with a fixed per-destination capacity
  ``cap = int((t_l * k / n_ep) * capacity_factor) + 1``, grouped per
  expert by ``_rank_in_group`` (a stable sort) with capacity ``cap_e``;
  assignments over capacity are dropped, in JAX's order. The
  load-balance loss is formed from the router's statistics summed over
  every sharded axis (the mean over ``model`` under replicated routing),
  so it equals the reference's. Shared experts run outside the
  expert-parallel region, on the rank's rows.

The parameter layout is JAX's: the expert
count is padded to a multiple of the 16-way EP width JAX deploys
(qwen2-moe: 60 -> 64, with 4 never-routed null experts whose router
logits are masked to -1e30, so their probability is exactly 0). Shared
experts (qwen2-moe) run as one fused dense MLP of width
``n_shared * d_ff_expert`` beside the routed path.

The router's statistics (assignment counts, probability sums, token
count) stay unreduced until ``_aux_from_stats`` forms the Switch-style
load-balance loss, as in JAX. ``torch.topk`` orders the selected experts
by gate like ``jax.lax.top_k``, but promises no order between equal
probabilities (JAX takes the lower index).

"""
from __future__ import annotations

import torch

from repro_torch.models import placement
from repro_torch.models.common import ModelConfig, ParamSet, silu

# the expert matrices, whose leading (expert) dimension the
# expert-parallel path keeps split over the mesh's model axis
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def padded_experts(cfg: ModelConfig, ep: int | None = None) -> int:
    ep = ep or 1
    e = cfg.n_experts
    return (e + ep - 1) // ep * ep


def moe_param_defs(ps: ParamSet, cfg: ModelConfig):
    L, D = cfg.n_layers, cfg.d_model
    F = cfg.d_ff_expert or cfg.d_ff
    # pad experts to the worst-case EP width JAX deploys (16-way model axis)
    E = padded_experts(cfg, 16)
    ps.add("layers/router", (L, D, E), ("layer", "embed", "experts"))
    ps.add("layers/we_gate", (L, E, D, F),
           ("layer", "experts", "expert_in", "expert_out"))
    ps.add("layers/we_up", (L, E, D, F),
           ("layer", "experts", "expert_in", "expert_out"))
    ps.add("layers/we_down", (L, E, F, D),
           ("layer", "experts", "expert_out", "expert_in"))
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        ps.add("layers/ws_gate", (L, D, Fs), ("layer", "embed", "mlp"))
        ps.add("layers/ws_up", (L, D, Fs), ("layer", "embed", "mlp"))
        ps.add("layers/ws_down", (L, Fs, D), ("layer", "mlp", "embed"))


def _router(router_w: torch.Tensor, cfg: ModelConfig, x2: torch.Tensor):
    """x2: (T, D) -> (gates (T,k) in x2's dtype, experts (T,k) int32,
    stats): ``stats`` = (assignment counts (E,), prob sums (E,), token
    count), unreduced."""
    e_pad = router_w.shape[-1]
    logits = (x2 @ router_w.to(x2.dtype)).float()
    if e_pad != cfg.n_experts:  # mask padded (null) experts
        pad_mask = torch.arange(e_pad, device=x2.device) >= cfg.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # the assignments per expert (a sum of ones: exact in any order; unlike
    # bincount it also runs on the meta device, for the dry run's count)
    flat = experts.reshape(-1)
    counts = torch.zeros(e_pad, dtype=torch.float32, device=x2.device
                         ).scatter_add_(0, flat, torch.ones(
                             flat.shape, dtype=torch.float32,
                             device=x2.device))
    stats = (counts, probs.sum(dim=0), float(x2.shape[0]))
    return gates.to(x2.dtype), experts.to(torch.int32), stats


def _aux_from_stats(cfg: ModelConfig, stats) -> torch.Tensor:
    """Switch-style load balance: E * sum_e f_e * p_e."""
    counts, prob_sum, n = stats
    f = counts / max(n * cfg.top_k, 1.0)
    p = prob_sum / max(n, 1.0)
    return cfg.n_experts * torch.sum(f * p)


def _expert_mlp(we_gate, we_up, we_down, x):
    """Grouped SwiGLU: x (E, Cap, D) with per-expert weights (E, D, F)."""
    g = silu(torch.bmm(x, we_gate))
    u = torch.bmm(x, we_up)
    return torch.bmm(g * u, we_down)


def _shared_mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    g = silu(x @ lp["ws_gate"].to(x.dtype))
    u = x @ lp["ws_up"].to(x.dtype)
    return (g * u) @ lp["ws_down"].to(x.dtype)


def moe_ffn_reference(lp: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (y (B, S, D), aux f32 scalar)."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    gates, experts, stats = _router(lp["router"], cfg, x2)
    aux = _aux_from_stats(cfg, stats)
    e_pad = lp["router"].shape[-1]
    onehot = torch.nn.functional.one_hot(experts.long(), e_pad).to(x.dtype)
    combine = torch.einsum("tk,tke->te", gates, onehot)          # (T,E)
    xe = x2[None].expand((e_pad,) + tuple(x2.shape))             # (E,T,D)
    ye = _expert_mlp(lp["we_gate"].to(x.dtype), lp["we_up"].to(x.dtype),
                     lp["we_down"].to(x.dtype), xe)              # (E,T,D)
    y = torch.einsum("te,etd->td", combine, ye)
    if cfg.n_shared_experts:
        y = y + _shared_mlp(lp, x2)
    return y.reshape(b, s, d), aux


def _rank_in_group(groups: torch.Tensor) -> torch.Tensor:
    """0-based occurrence rank of each element within its group id."""
    order = torch.argsort(groups, stable=True)
    sorted_g = groups[order]
    first = torch.searchsorted(sorted_g, sorted_g, side="left")
    rank_sorted = torch.arange(groups.shape[0], device=groups.device) - first
    return torch.zeros_like(rank_sorted).index_put(
        (order,), rank_sorted)


def moe_ffn_ep(lp: dict, x: torch.Tensor, cfg: ModelConfig, mesh,
               ep_axis: str = "model", bat: tuple = (), drops=None):
    """Expert-parallel routed experts. Collective over the mesh.

    ``x``: this rank's rows (b, S, D) of the batch, whose rows are split
    over ``bat``; ``lp``: the layer's parameters gathered by their specs,
    the expert matrices either whole or as this rank's block of experts
    along ``ep_axis``. Returns (this rank's rows of y, the load-balance
    loss). A dict ``drops`` receives this rank's counts of assignments
    (``routed``) and of those dropped at dispatch (``dropped_send``) and
    at its experts (``dropped_expert``)."""
    n_ep = mesh.size(ep_axis)
    idx = mesh.index(ep_axis)
    e_pad = lp["router"].shape[-1]
    e_local = e_pad // n_ep
    x_in = x
    # JAX's layout inside the region: rows over the batch axes, the
    # sequence over ep_axis; rows split over ep_axis come together first
    if ep_axis in bat:
        x = placement.gather(x, mesh, (ep_axis,), 0)
    batch_axes = tuple(a for a in bat if a != ep_axis)
    seq_shard = x.shape[1] % n_ep == 0 and x.shape[1] >= n_ep
    if seq_shard:
        s_l = x.shape[1] // n_ep
        x = x.narrow(1, idx * s_l, s_l)
    experts_w = [lp[k] if lp[k].shape[0] == e_local
                 else lp[k].narrow(0, idx * e_local, e_local)
                 for k in EXPERT_LEAVES]

    b_l, s_l, d = x.shape
    t_l = b_l * s_l
    dev = x.device
    x2 = x.reshape(t_l, d)
    gates, experts, stats = _router(lp["router"], cfg, x2)
    k = cfg.top_k
    cap = int((t_l * k / n_ep) * cfg.capacity_factor) + 1

    # ---- dispatch: per-destination-shard send buffers ----
    flat_e = experts.reshape(-1).long()                # (T*k,)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(t_l * k, device=dev) // k
    dest = flat_e // e_local
    rank = _rank_in_group(dest)
    fits = rank < cap                                  # the rest dropped
    srow, slot = dest[fits], rank[fits]
    send_x = torch.zeros((n_ep, cap, d), dtype=x.dtype, device=dev
                         ).index_put((srow, slot), x2[flat_t[fits]])
    send_meta = torch.full((n_ep, cap, 2), -1, dtype=torch.long, device=dev
                           ).index_put((srow, slot), torch.stack(
                               [flat_t[fits], flat_e[fits] % e_local], 1))
    send_gate = torch.zeros((n_ep, cap), dtype=torch.float32, device=dev
                            ).index_put((srow, slot), flat_g[fits].float())

    recv_x = placement.all_to_all(send_x, mesh, ep_axis)
    recv_meta = placement.all_to_all(send_meta, mesh, ep_axis)

    # ---- local grouped expert compute ----
    rx = recv_x.reshape(n_ep * cap, d)
    re = recv_meta[..., 1].reshape(-1)                 # local expert ids
    rvalid = recv_meta[..., 0].reshape(-1) >= 0
    cap_e = int(n_ep * cap / e_local * cfg.capacity_factor) + 1
    eg = torch.where(rvalid, re, e_local)
    erank = _rank_in_group(eg)
    efits = rvalid & (erank < cap_e)
    erow, eslot = eg[efits], erank[efits]
    buf = torch.zeros((e_local, cap_e, d), dtype=x.dtype, device=dev
                      ).index_put((erow, eslot), rx[efits])
    if drops is not None:
        drops.update(routed=t_l * k, dropped_send=int((~fits).sum()),
                     dropped_expert=int((rvalid & ~efits).sum()))
    y_buf = _expert_mlp(*(w.to(x.dtype) for w in experts_w), buf)
    y_flat = torch.zeros((n_ep * cap, d), dtype=x.dtype, device=dev
                         ).index_put((efits.nonzero()[:, 0],),
                                     y_buf[erow, eslot])
    y_recv = y_flat.reshape(n_ep, cap, d)

    # ---- return all_to_all + weighted combine at the source ----
    y_send = placement.all_to_all(y_recv, mesh, ep_axis)
    tok = send_meta[..., 0].reshape(-1)
    contrib = (send_gate.reshape(-1, 1).to(x.dtype) * y_send.reshape(-1, d))
    sent = tok >= 0
    y2 = torch.zeros((t_l, d), dtype=x.dtype, device=dev).index_add(
        0, tok[sent], contrib[sent])
    # the global aux: the raw statistics summed over every sharded axis,
    # then the loss, exactly the reference's
    axes = batch_axes + ((ep_axis,) if seq_shard else ())
    counts, prob_sum, n = stats
    if axes:
        counts = placement.reduce(counts, mesh, axes)
        prob_sum = placement.psum_shares(prob_sum, mesh, axes)
        n = n * mesh.size(axes)
    aux = _aux_from_stats(cfg, (counts, prob_sum, n))
    if not seq_shard:  # every ep rank routed identical tokens
        aux = placement.psum_shares(aux, mesh, ep_axis, mean=True)

    y = y2.reshape(b_l, s_l, d)
    if seq_shard:
        y = placement.gather(y, mesh, (ep_axis,), 1)
    else:
        # each ep rank dispatched its own copy of the tokens; receivers
        # take the copies in rank order, so capacity may drop a later
        # copy where it keeps the first: JAX's replicas then disagree,
        # and the value it reports is ep rank 0's, which every rank takes
        y = placement.psum_shares(y * float(idx == 0), mesh, ep_axis)
    if ep_axis in bat:
        y = y.narrow(0, idx * x_in.shape[0], x_in.shape[0])
    if cfg.n_shared_experts:  # outside the expert-parallel region
        b, s, _ = x_in.shape
        y = y + _shared_mlp(lp, x_in.reshape(-1, d)).reshape(b, s, d)
    return y, aux


def moe_ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None,
            bat: tuple = ()):
    """The dense reference path, or on a mesh with a ``model`` axis the
    expert-parallel path over this rank's rows (split over ``bat``)."""
    if mesh is not None and "model" in mesh.axis_names:
        return moe_ffn_ep(lp, x, cfg, mesh, bat=bat)
    return moe_ffn_reference(lp, x, cfg)
