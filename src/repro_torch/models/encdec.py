"""Whisper-style encoder-decoder backbone of the port
(``repro.models.encdec``'s counterpart).

The audio conv frontend is a stub: the model takes precomputed frame
embeddings (B, encoder_ctx, D). The encoder is bidirectional
self-attention; the decoder is causal self-attention and cross-attention
over the encoder's output. GELU MLPs (``jax.nn.gelu``'s default, the
tanh form), MHA (kv = heads). RoPE stands in for Whisper's learned and
sinusoidal positions, as in the JAX package; the encoder's keys in the
cross-attention take none.

The cache holds the decoder's self-attention K/V to ``max_len`` and the
cross-attention K/V at ``encoder_ctx``, made once by ``prefill``.
``decode_step`` writes the new key and value into the cache it is given,
in place, at position ``length[0]`` (the lockstep invariant, as
``transformer.decode_step`` does), reads the whole cross cache, and
returns a dict holding the same tensors and a new ``length``.

**On a mesh** the encoder and the decoder run on the rank's rows, each
layer gathering its leaves (``transformer``'s module docstring; the
``frames`` are global and split like the tokens). The self-attention
K/V is seq-sharded over ``model`` and decoded through
``attention.flash_decode``; the cross cache ``ck``/``cv``,
(L, B, Te, KV, Dh), is split on its kv heads over ``model``, and a rank
attends with the query heads of its own kv heads and gathers the output
over ``model``: exact, since heads are independent, and it moves
(B, H, Dh) per layer instead of the cross cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import placement
from repro_torch.models.common import (ModelConfig, ParamSet, rms_norm,
                                       rope_tables)
from repro_torch.models.transformer import (_embed, _head, _layers, _norm,
                                            _rows_place, _write, attend_cache,
                                            decode_place, local, new_cache,
                                            prefill_place, qkv_rope, remat,
                                            seq_part, write_position)


def encdec_param_set(cfg: ModelConfig) -> ParamSet:
    ps = ParamSet(cfg)
    D, V, Fd = cfg.d_model, cfg.vocab, cfg.d_ff
    H, KV, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    ps.add("embed", (V, D), ("vocab_in", "embed"), scale=0.02)
    ps.add("lm_head", (D, V), ("embed", "vocab"))
    ps.add("final_norm", (D,), ("none",), init="ones")
    ps.add("enc_final_norm", (D,), ("none",), init="ones")
    for pre, L in (("enc", Le), ("layers", Ld)):
        ps.add(f"{pre}/ln1", (L, D), ("layer", "none"), init="ones")
        ps.add(f"{pre}/ln2", (L, D), ("layer", "none"), init="ones")
        ps.add(f"{pre}/wq", (L, D, H * Dh), ("layer", "embed", "heads"))
        ps.add(f"{pre}/wk", (L, D, KV * Dh), ("layer", "embed", "kv"))
        ps.add(f"{pre}/wv", (L, D, KV * Dh), ("layer", "embed", "kv"))
        ps.add(f"{pre}/wo", (L, H * Dh, D), ("layer", "heads", "embed"))
        ps.add(f"{pre}/w_in", (L, D, Fd), ("layer", "embed", "mlp"))
        ps.add(f"{pre}/w_out", (L, Fd, D), ("layer", "mlp", "embed"))
    # decoder cross-attention
    ps.add("layers/ln_c", (Ld, D), ("layer", "none"), init="ones")
    ps.add("layers/wq_c", (Ld, D, H * Dh), ("layer", "embed", "heads"))
    ps.add("layers/wk_c", (Ld, D, KV * Dh), ("layer", "embed", "kv"))
    ps.add("layers/wv_c", (Ld, D, KV * Dh), ("layer", "embed", "kv"))
    ps.add("layers/wo_c", (Ld, H * Dh, D), ("layer", "heads", "embed"))
    return ps


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _mlp(lp, cfg, x):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = gelu(h @ lp["w_in"].to(x.dtype))
    return x + y @ lp["w_out"].to(x.dtype)


def _positions(s: int, cfg: ModelConfig, device):
    return rope_tables(torch.arange(s, device=device), cfg.d_head,
                       cfg.rope_theta)


def _encoder_layer(lp, cfg, x, cs, pl=None):
    if pl is not None:
        lp = pl.layer(lp, "enc")
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_rope(lp, cfg, h, cs)
    o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, causal=False)
    x = x + o.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
    return _mlp(lp, cfg, x)


def _encode(params: dict, cfg: ModelConfig, frames: torch.Tensor, pl=None):
    """The encoder over ``frames`` (this rank's rows on a mesh)."""
    x = frames.to(cfg.compute_dtype)
    cs = _positions(x.shape[1], cfg, x.device)
    layer = remat(_encoder_layer, cfg, params)
    for lp in _layers(params, cfg.compute_dtype, "enc"):
        x = layer(lp, cfg, x, cs, pl)
    return rms_norm(x, _norm(params, "enc_final_norm", pl), cfg.norm_eps)


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """frames: (B, Tenc, D) stub embeddings -> encoder states (on a mesh
    this rank's rows)."""
    pl = _rows_place(params, cfg, mesh, frames.shape[0])
    return _encode(params, cfg, pl.rows(frames) if pl else frames, pl)


def _decoder_layer(lp, cfg, x, cs, enc_out, pl=None):
    """One decoder layer over the full sequence. Returns (x, (k, v,
    cross k, cross v)): the last four are what the cache holds."""
    if pl is not None:
        lp = pl.layer(lp)
    b, s, _ = x.shape
    te = enc_out.shape[1]
    H, KV, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_rope(lp, cfg, h, cs)
    o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, causal=True)
    x = x + o.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
    # cross attention (no rope on the encoder's keys)
    h = rms_norm(x, lp["ln_c"], cfg.norm_eps)
    q = (h @ lp["wq_c"].to(x.dtype)).reshape(b, s, H, Dh)
    ck = (enc_out @ lp["wk_c"].to(x.dtype)).reshape(b, te, KV, Dh)
    cv = (enc_out @ lp["wv_c"].to(x.dtype)).reshape(b, te, KV, Dh)
    o = attn.blockwise_attention(q, ck, cv, chunk=cfg.attn_chunk,
                                 causal=False)
    x = x + o.reshape(b, s, -1) @ lp["wo_c"].to(x.dtype)
    return _mlp(lp, cfg, x), (k, v, ck, cv)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, mesh=None):
    """Teacher-forced decoder logits given stub audio frames. Returns
    (logits (B,S,V), 0.0 aux); on a mesh the logits are this rank's
    rows."""
    pl = _rows_place(params, cfg, mesh, tokens.shape[0])
    if pl is not None:
        tokens, frames = pl.rows(tokens), pl.rows(frames)
    enc_out = _encode(params, cfg, frames, pl)
    x = _embed(params, cfg, tokens, pl)
    cs = _positions(x.shape[1], cfg, x.device)
    layer = remat(_decoder_layer, cfg, params)
    for lp in _layers(params, cfg.compute_dtype):
        x = layer(lp, cfg, x, cs, enc_out, pl)[0]
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    return x @ _head(params, cfg, pl), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda", enc_len: int | None = None) -> dict:
    """Zeros; the cross K/V over ``enc_len`` frames (``encoder_ctx`` by
    default)."""
    dtype = dtype or cfg.compute_dtype
    L, KV, Dh = cfg.n_layers, cfg.n_kv, cfg.d_head
    te = enc_len or cfg.encoder_ctx

    def zeros(t):
        return torch.zeros((L, batch, t, KV, Dh), dtype=dtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len), "ck": zeros(te),
            "cv": zeros(te),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, max_len: int | None = None, mesh=None):
    """Encode the audio and run the decoder prompt teacher-forced,
    building the self-attention cache and the cross K/V cache. Returns
    (cache, last_logits); on a mesh this rank's block of the cache and
    its rows of the logits."""
    b, s = tokens.shape
    pl = prefill_place(params, cfg, mesh, b)
    if pl is not None:
        tokens, frames = pl.rows(tokens), pl.rows(frames)
    enc_out = _encode(params, cfg, frames, pl)
    x = _embed(params, cfg, tokens, pl)
    cache = new_cache(init_cache, cfg, b, max_len or s, mesh, x.device,
                      enc_len=enc_out.shape[1])
    seq = seq_part(cache, s)
    n = seq.stop - seq.start
    cs = _positions(s, cfg, x.device)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        x, (k, v, ck, cv) = _decoder_layer(lp, cfg, x, cs, enc_out, pl)
        cache["k"][i, :, :n] = k[:, seq]
        cache["v"][i, :, :n] = v[:, seq]
        cache["ck"][i] = local(cache, "ck", ck)
        cache["cv"][i] = local(cache, "cv", cv)
    x = rms_norm(x[:, -1:], _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    cache["length"].fill_(s)
    return cache, logits


def _cross_heads(cache, cfg: ModelConfig):
    """(query heads, kv axes): the query heads that attend to this
    rank's kv heads of the cross cache and the axes those are split
    over (all heads and none without a mesh)."""
    if not isinstance(cache, placement.Sharded):
        return slice(0, cfg.n_heads), ()
    kv = placement.block(cache.spec("ck"), cache.shapes["ck"],
                         cache.mesh)[3]
    g = cfg.n_heads // cfg.n_kv
    return (slice(kv.start * g, kv.stop * g),
            placement.axes_of(cache.spec("ck")[3]))


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, mesh=None):
    """One decode step. token: (B, 1) i32. Returns (cache, logits (B,V));
    ``k`` and ``v`` are written in place (module docstring). On a mesh
    the cache is this rank's ``placement.Sharded`` block and ``token``
    the whole column; the logits are this rank's rows."""
    pl = decode_place(params, cfg, cache, mesh)
    if pl is not None:
        token = pl.rows(token)
    x = _embed(params, cfg, token, pl)
    b = x.shape[0]
    length = cache["length"]
    length1 = length + 1
    at, valid, flash = write_position(cache, length, pl)
    cs = rope_tables(length[:, None], cfg.d_head, cfg.rope_theta)
    Dh = cfg.d_head
    heads, kv_axes = _cross_heads(cache, cfg)
    te = cache["ck"].shape[2]
    full = torch.full((b,), te, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        kc, vc = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_rope(lp, cfg, h, cs)
        _write(kc, at, k, valid)
        _write(vc, at, v, valid)
        o = attend_cache(q, kc, vc, length1, flash, mesh)
        x = x + o.reshape(b, 1, -1) @ lp["wo"].to(x.dtype)
        h = rms_norm(x, lp["ln_c"], cfg.norm_eps)
        q = (h @ lp["wq_c"].to(x.dtype)).reshape(b, 1, -1, Dh)[:, :, heads]
        o = attn.decode_attention(q, cache["ck"][i], cache["cv"][i], full)
        if kv_axes:
            o = placement.gather(o, mesh, kv_axes, 2)
        x = x + o.reshape(b, 1, -1) @ lp["wo_c"].to(x.dtype)
        x = _mlp(lp, cfg, x)
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    out = dict(cache, length=length1)
    return (cache.with_values(out) if pl is not None else out), logits
