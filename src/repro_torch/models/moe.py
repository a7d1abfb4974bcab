"""Mixture-of-Experts FFN of the port (``repro.models.moe``'s
counterpart): the dense reference path on one device.

Every expert runs on every token and the top-k gate combines them
(exact: no capacity drops). The parameter layout is JAX's: the expert
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

The expert-parallel path (``moe_ffn_ep``: two all_to_alls over a mesh's
model axis, capacity drops) waits for the LM's meshes (ROADMAP A15f):
``moe_ffn`` raises when it is given a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, ParamSet, silu


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
    counts = torch.bincount(experts.reshape(-1), minlength=e_pad).float()
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


def moe_ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism (moe_ffn_ep over a mesh) is not ported "
            "yet: ROADMAP A15f")
    return moe_ffn_reference(lp, x, cfg)
