"""Decoder-only transformer LM of the port: the dense GQA family, the MoE
FFN and the VLM image prefix (``repro.models.transformer``'s
counterpart).

Parameters are layer-stacked (a leading L axis, ``layers/*``), as in the
JAX package; a Python loop over L takes the place of ``lax.scan``. Under
``cfg.remat == "full"`` the full-sequence forward wraps each layer in
``torch.utils.checkpoint`` (as JAX wraps its scan body in
``jax.checkpoint``), but only while gradients are being taken: a call
under ``torch.no_grad`` or on parameters that need no gradient (serving)
runs the layers as they are. Every call casts the parameters it reads to
``cfg.compute_dtype``, as JAX does inside each jitted call; gradients
reach an f32 master through that cast. On a tree already in that dtype
the cast is free (``ServeEngine`` holds such a copy). The embedding rows
are gathered before the cast, which gives the cast table's rows bitwise
without casting the whole table.

``decode_step`` writes the new keys and values into the cache it is
given, in place, and returns a cache dict holding the same ``k``/``v``
tensors and a new ``length``: a caller that needs the old cache passes a
clone. Like JAX, it writes every row at position ``length[0]`` (the
serving engine's lockstep invariant), from a device index, while rope
uses each row's own ``length``.

The FFN is pluggable: the MoE family (``repro_torch.models.moe``) runs
its dense reference path here and returns its router's load-balance
loss, which ``loss_fn`` adds. Any ``mesh`` (ROADMAP A15f) raises.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, ParamSet, apply_rope,
                                       cast_params, cross_entropy_loss,
                                       rms_norm, rope_tables, silu)


def no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the LM on a mesh (flash_decode, sharding rules, "
            "act_sharding) is not ported yet: ROADMAP A15f")


# ---------------------------------------------------------------------------
# parameter tables
# ---------------------------------------------------------------------------

def dense_param_set(cfg: ModelConfig) -> ParamSet:
    ps = ParamSet(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    H, KV, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    ps.add("embed", (V, D), ("vocab_in", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        ps.add("lm_head", (D, V), ("embed", "vocab"))
    ps.add("final_norm", (D,), ("none",), init="ones")
    ps.add("layers/ln1", (L, D), ("layer", "none"), init="ones")
    ps.add("layers/ln2", (L, D), ("layer", "none"), init="ones")
    ps.add("layers/wq", (L, D, H * Dh), ("layer", "embed", "heads"))
    ps.add("layers/wk", (L, D, KV * Dh), ("layer", "embed", "kv"))
    ps.add("layers/wv", (L, D, KV * Dh), ("layer", "embed", "kv"))
    ps.add("layers/wo", (L, H * Dh, D), ("layer", "heads", "embed"))
    if cfg.qkv_bias:
        ps.add("layers/bq", (L, H * Dh), ("layer", "heads"), init="zeros")
        ps.add("layers/bk", (L, KV * Dh), ("layer", "kv"), init="zeros")
        ps.add("layers/bv", (L, KV * Dh), ("layer", "kv"), init="zeros")
    _ffn_params(ps, cfg)
    return ps


def _ffn_params(ps: ParamSet, cfg: ModelConfig):
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    if cfg.family in ("dense", "vlm", "encdec"):
        ps.add("layers/w_gate", (L, D, F), ("layer", "embed", "mlp"))
        ps.add("layers/w_up", (L, D, F), ("layer", "embed", "mlp"))
        ps.add("layers/w_down", (L, F, D), ("layer", "mlp", "embed"))
    elif cfg.family == "moe":
        from repro_torch.models.moe import moe_param_defs
        moe_param_defs(ps, cfg)
    else:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _layers(params: dict, dtype, prefix: str = "layers"):
    """Each layer's parameters of the stack ``prefix``, in ``dtype``, in
    layer order."""
    pre = prefix + "/"
    stacked = cast_params({k[len(pre):]: v for k, v in params.items()
                           if k.startswith(pre)}, dtype)
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        yield {k: v[i] for k, v in stacked.items()}


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.compute_dtype)


def qkv(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    b, s, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = x @ lp["wq"].to(x.dtype)
    k = x @ lp["wk"].to(x.dtype)
    v = x @ lp["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(x.dtype)
        k = k + lp["bk"].to(x.dtype)
        v = v + lp["bv"].to(x.dtype)
    return (q.reshape(b, s, H, Dh), k.reshape(b, s, KV, Dh),
            v.reshape(b, s, KV, Dh))


def qkv_rope(lp: dict, cfg: ModelConfig, x: torch.Tensor, cs):
    """``qkv`` with rope from the tables ``cs`` on q and k."""
    q, k, v = qkv(lp, cfg, x)
    return apply_rope(q, *cs), apply_rope(k, *cs), v


def mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    gate = silu(x @ lp["w_gate"].to(x.dtype))
    up = x @ lp["w_up"].to(x.dtype)
    return (gate * up) @ lp["w_down"].to(x.dtype)


def make_ffn(cfg: ModelConfig, mesh=None):
    no_mesh(mesh)
    if cfg.family == "moe":
        from repro_torch.models.moe import moe_ffn
        return functools.partial(moe_ffn, cfg=cfg, mesh=mesh)

    def ffn(lp, x):  # the dense FFN has no auxiliary loss
        return mlp(lp, x), 0.0

    return ffn


def decoder_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions, ffn) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm GQA block over the full sequence. ``positions``: (S,), or
    the (cos, sin) pair ``rope_tables`` makes of them. Returns (x,
    aux_loss)."""
    rope_cs = positions if isinstance(positions, tuple) else rope_tables(
        positions, cfg.d_head, cfg.rope_theta)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_rope(lp, cfg, h, rope_cs)
    o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, causal=True)
    b, s = x.shape[:2]
    x = x + o.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = ffn(lp, h)
    return x + y, aux


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def remat(layer, cfg: ModelConfig, params: dict):
    """``layer`` under ``torch.utils.checkpoint`` when ``cfg.remat`` is
    ``"full"`` and gradients of ``params`` are being taken; else
    ``layer`` itself."""
    if cfg.remat == "full" and torch.is_grad_enabled() and any(
            v.requires_grad for v in params.values()):
        return functools.partial(checkpoint, layer, use_reentrant=False)
    return layer


def _prefix(params, cfg, tokens, img_embeds):
    x = _embed(params, cfg, tokens)
    if img_embeds is not None:  # VLM: precomputed patch embeddings prefix
        x = torch.cat([img_embeds.to(cfg.compute_dtype), x], dim=1)
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds: torch.Tensor | None = None, mesh=None) -> tuple:
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss)."""
    ffn = make_ffn(cfg, mesh)
    x = _prefix(params, cfg, tokens, img_embeds)
    s = x.shape[1]
    cs = rope_tables(torch.arange(s, device=x.device), cfg.d_head,
                     cfg.rope_theta)
    layer = remat(decoder_layer, cfg, params)
    aux = 0.0
    for lp in _layers(params, cfg.compute_dtype):
        x, a = layer(lp, cfg, x, cs, ffn)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, mesh=None):
    """batch: tokens (B,S) i32, labels (B,S) i32 (-1 = masked),
    optional img_embeds (B,Timg,D)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("img_embeds"), mesh=mesh)
    labels = batch["labels"]
    if batch.get("img_embeds") is not None:
        t_img = batch["img_embeds"].shape[1]
        logits = logits[:, t_img:]
    ce = cross_entropy_loss(logits, labels.clamp_min(0), labels >= 0)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    dtype = dtype or cfg.compute_dtype
    L, KV, Dh = cfg.n_layers, cfg.n_kv, cfg.d_head
    return {
        "k": torch.zeros((L, batch, max_len, KV, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, KV, Dh), dtype=dtype,
                         device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, mesh=None) -> tuple[dict, torch.Tensor]:
    """One decode step. token: (B, 1) i32. Returns (cache, logits (B,V)).

    Updates ``cache["k"]`` and ``cache["v"]`` in place (see the module
    docstring); the returned cache holds them and ``length + 1``.
    """
    ffn = make_ffn(cfg, mesh)
    x = _embed(params, cfg, token)                             # (B,1,D)
    b = x.shape[0]
    length = cache["length"]                                   # (B,)
    length1 = length + 1
    t = cache["k"].shape[2]
    # the lockstep write position; dynamic_update_slice clamps its start
    at = length[:1].clamp(max=t - 1).long()
    cs = rope_tables(length[:, None], cfg.d_head, cfg.rope_theta)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        kc, vc = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_rope(lp, cfg, h, cs)
        kc.index_copy_(1, at, k.to(kc.dtype))
        vc.index_copy_(1, at, v.to(vc.dtype))
        o = attn.decode_attention(q, kc, vc, length1)
        x = x + o.reshape(b, 1, -1) @ lp["wo"].to(x.dtype)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, _ = ffn(lp, h)
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    return {"k": cache["k"], "v": cache["v"], "length": length1}, logits


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, mesh=None,
            img_embeds: torch.Tensor | None = None) -> tuple[dict, torch.Tensor]:
    """Run the full prompt, build a new cache. Returns (cache,
    last_logits)."""
    ffn = make_ffn(cfg, mesh)
    x = _prefix(params, cfg, tokens, img_embeds)
    b, s = x.shape[:2]
    max_len = max_len or s
    cache = init_cache(cfg, b, max_len, device=x.device)
    cs = rope_tables(torch.arange(s, device=x.device), cfg.d_head,
                     cfg.rope_theta)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_rope(lp, cfg, h, cs)
        o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk,
                                     causal=True)
        x2 = x + o.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
        h2 = rms_norm(x2, lp["ln2"], cfg.norm_eps)
        y, _ = ffn(lp, h2)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        x = x2 + y
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    cache["length"].fill_(s)
    return cache, logits
