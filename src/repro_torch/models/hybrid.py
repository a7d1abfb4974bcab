"""Zamba2-style hybrid of the port: a mamba2 backbone and ONE shared
attention block (``repro.models.hybrid``'s counterpart).

The shared GQA transformer block (a single parameter set) runs after
every ``hybrid_attn_every``-th mamba layer: weight reuse across depth as
in Zamba2, without its embedding-concat input to the shared block (the
JAX package's simplification). Its K/V caches are indexed by invocation
(``n_inv = n_layers // every``): a model with fewer than ``every``
layers never runs the block. JAX's ``lax.cond`` on the layer index
becomes a Python ``if``: the index is static, so nothing is read from
the device.

``decode_step`` writes each layer's SSD state and conv tails and each
invocation's new key and value into the cache it is given, in place (the
K/V at position ``length[0]``, the lockstep invariant, as
``transformer.decode_step`` does), and returns a dict holding the same
tensors and a new ``length``.

**On a mesh** the mamba layers run as ``ssm_lm``'s do (its module
docstring); the shared block's ``shared/*`` leaves are gathered through
the call's ``placement.Place`` where the block runs. Its K/V cache,
(n_inv, B, S, KV, Dh), is seq-sharded over ``model`` as the
transformer's: prefill writes the rank's seq slice, decode writes on the
rank whose shard holds the clamped ``length[0]`` and attends through
``attention.flash_decode`` (over one ``model`` shard that is
``decode_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, ParamSet, cast_params,
                                       rms_norm, rope_tables)
from repro_torch.models.ssm import mamba_block, ssm_param_defs
from repro_torch.models.ssm_lm import StatePart, decode_layer
from repro_torch.models.ssm_lm import init_cache as ssm_init_cache
from repro_torch.models.ssm_lm import write_layer
from repro_torch.models.transformer import (_embed, _head, _layers, _norm,
                                            _rows_place, _write, attend_cache,
                                            decode_place, mlp, new_cache,
                                            prefill_place, qkv_rope, remat,
                                            seq_part, write_position)


def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


def hybrid_param_set(cfg: ModelConfig) -> ParamSet:
    ps = ParamSet(cfg)
    D, V = cfg.d_model, cfg.vocab
    H, KV, Dh, F = cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_ff
    ps.add("embed", (V, D), ("vocab_in", "embed"), scale=0.02)
    ps.add("lm_head", (D, V), ("embed", "vocab"))
    ps.add("final_norm", (D,), ("none",), init="ones")
    ssm_param_defs(ps, cfg)
    # one shared attention+MLP block
    ps.add("shared/ln1", (D,), ("none",), init="ones")
    ps.add("shared/ln2", (D,), ("none",), init="ones")
    ps.add("shared/wq", (D, H * Dh), ("embed", "heads"))
    ps.add("shared/wk", (D, KV * Dh), ("embed", "kv"))
    ps.add("shared/wv", (D, KV * Dh), ("embed", "kv"))
    ps.add("shared/wo", (H * Dh, D), ("heads", "embed"))
    ps.add("shared/w_gate", (D, F), ("embed", "mlp"))
    ps.add("shared/w_up", (D, F), ("embed", "mlp"))
    ps.add("shared/w_down", (F, D), ("mlp", "embed"))
    return ps


def _shared_params(params: dict, dtype, pl=None) -> dict:
    """The shared block's leaves in ``dtype``; gathered whole on a
    mesh (``pl``)."""
    sp = cast_params({k[len("shared/"):]: v for k, v in params.items()
                      if k.startswith("shared/")}, dtype)
    return sp if pl is None else pl.layer(sp, "shared", stacked=False)


def _is_attn(cfg: ModelConfig, i: int) -> bool:
    return (i + 1) % cfg.hybrid_attn_every == 0


def _mlp(sp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(sp, rms_norm(x, sp["ln2"], cfg.norm_eps))


def _shared_block(sp: dict, cfg: ModelConfig, x: torch.Tensor, cs):
    """The shared block over the full sequence, causal. ``cs``: the rope
    tables of positions 0..S-1. Returns (x, k, v)."""
    b, s, _ = x.shape
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = qkv_rope(sp, cfg, h, cs)
    o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, causal=True)
    x = x + o.reshape(b, s, -1) @ sp["wo"].to(x.dtype)
    return _mlp(sp, cfg, x), k, v


def _layer(lp, params, cfg, x, cs, i: int, pl=None):
    """Mamba layer ``i`` and, after every ``hybrid_attn_every``-th, the
    shared block; on a mesh both gather their leaves here (so remat
    gathers again)."""
    if pl is not None:
        lp = pl.layer(lp)
    x, _ = mamba_block(lp, cfg, x)
    if _is_attn(cfg, i):
        sp = _shared_params(params, cfg.compute_dtype, pl)
        x = _shared_block(sp, cfg, x, cs)[0]
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds=None, mesh=None):
    """Full-sequence forward. Returns (logits (B,S,V), 0.0 aux); on a
    mesh the logits are this rank's rows."""
    pl = _rows_place(params, cfg, mesh, tokens.shape[0])
    if pl is not None:
        tokens = pl.rows(tokens)
    x = _embed(params, cfg, tokens, pl)
    s = x.shape[1]
    cs = rope_tables(torch.arange(s, device=x.device), cfg.d_head,
                     cfg.rope_theta)
    layer = remat(_layer, cfg, params)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        x = layer(lp, params, cfg, x, cs, i, pl)
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    return x @ _head(params, cfg, pl), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    dtype = dtype or cfg.compute_dtype
    cache = ssm_init_cache(cfg, batch, max_len, dtype, device)
    shape = (n_shared_invocations(cfg), batch, max_len, cfg.n_kv, cfg.d_head)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, mesh=None):
    """Prompt pass: the SSD state per mamba layer and the K/V of each
    shared-block invocation. Returns (cache, last_logits); on a mesh this
    rank's block of the cache and its rows of the logits."""
    b, s = tokens.shape
    pl = prefill_place(params, cfg, mesh, b)
    if pl is not None:
        tokens = pl.rows(tokens)
    x = _embed(params, cfg, tokens, pl)
    cache = new_cache(init_cache, cfg, b, max_len or s, mesh, x.device)
    seq = seq_part(cache, s)
    n = seq.stop - seq.start
    cs = rope_tables(torch.arange(s, device=x.device), cfg.d_head,
                     cfg.rope_theta)
    n_inv = n_shared_invocations(cfg)
    every = cfg.hybrid_attn_every
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        x, (st, hx, hb, hc) = mamba_block(lp, cfg, x)
        write_layer(cache, i, st, hx, hb, hc)
        if _is_attn(cfg, i):
            sp = _shared_params(params, cfg.compute_dtype, pl)
            x, k, v = _shared_block(sp, cfg, x, cs)
            inv = min(i // every, n_inv - 1)
            cache["k"][inv, :, :n] = k[:, seq]
            cache["v"][inv, :, :n] = v[:, seq]
    x = rms_norm(x[:, -1:], _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    cache["length"].fill_(s)
    return cache, logits


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, mesh=None):
    """One decode step. token: (B, 1) i32. Returns (cache, logits (B,V));
    the cache is updated in place (module docstring). On a mesh the cache
    is this rank's ``placement.Sharded`` block and ``token`` the whole
    column; the logits are this rank's rows."""
    pl = decode_place(params, cfg, cache, mesh)
    part = None
    if pl is not None:
        token, part = pl.rows(token), StatePart.of(cache)
    x = _embed(params, cfg, token, pl)
    b = x.shape[0]
    length = cache["length"]
    length1 = length + 1
    at, valid, flash = write_position(cache, length, pl)
    cs = rope_tables(length[:, None], cfg.d_head, cfg.rope_theta)
    sp = None
    every = cfg.hybrid_attn_every
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        x = decode_layer(lp, cfg, x, cache, i, part)
        if not _is_attn(cfg, i):
            continue
        if sp is None:
            sp = _shared_params(params, cfg.compute_dtype, pl)
        kc, vc = cache["k"][i // every], cache["v"][i // every]
        h = rms_norm(x, sp["ln1"], cfg.norm_eps)
        q, k, v = qkv_rope(sp, cfg, h, cs)
        _write(kc, at, k, valid)
        _write(vc, at, v, valid)
        o = attend_cache(q, kc, vc, length1, flash, mesh)
        x = x + o.reshape(b, 1, -1) @ sp["wo"].to(x.dtype)
        x = _mlp(sp, cfg, x)
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    out = dict(cache, length=length1)
    return (cache.with_values(out) if pl is not None else out), logits
