"""Pure Mamba2 language model of the port (attention-free; mamba2-2.7b),
``repro.models.ssm_lm``'s counterpart.

A Python loop over the layers takes the place of ``lax.scan``. The
"cache" of an SSM has no sequence axis: per layer the f32 SSD state
(L, B, H, P, N) and the conv tails (L, B, dc-1, C) in the compute dtype,
plus ``length``. ``prefill`` builds a new cache; ``decode_step`` writes
each layer's new state and tails into the cache it is given, in place,
as ``transformer.decode_step`` writes its K/V, and returns a dict that
holds the same tensors and a new ``length``: a caller that needs the old
cache passes a clone.

**On a mesh** (an ``LMMesh``) the model runs as the dense transformer
does (``transformer``'s module docstring): each layer gathers its
leaves, a rank computes on its rows, ``loss`` is the rank's share of the
global loss. The cache is held as ``launch.steps.cache_specs`` says:
``ssm`` with its heads over ``model``, ``hx`` with its channels over
``model``, ``hb``/``hc`` by batch only. Prefill runs the chunked SSD on
the rank's rows and keeps the rank's block of the final state and tails.
A decode step updates the rank's own heads only (:class:`StatePart`):
the conv on its ``hx`` channels, the state of its heads, and ``y``
gathered over ``model`` before the gated norm, which is exact because
heads are independent up to there. It moves B·Di values per layer where
gathering the state would move B·H·P·N f32s.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import placement
from repro_torch.models.common import ModelConfig, ParamSet, rms_norm
from repro_torch.models.ssm import (mamba_block, mamba_decode_step,
                                    ssm_param_defs)
from repro_torch.models.transformer import (_embed, _head, _layers, _norm,
                                            _rows_place, decode_place, local,
                                            new_cache, prefill_place, remat)


def ssm_param_set(cfg: ModelConfig) -> ParamSet:
    ps = ParamSet(cfg)
    D, V = cfg.d_model, cfg.vocab
    ps.add("embed", (V, D), ("vocab_in", "embed"), scale=0.02)
    ps.add("lm_head", (D, V), ("embed", "vocab"))
    ps.add("final_norm", (D,), ("none",), init="ones")
    ssm_param_defs(ps, cfg)
    return ps


def _block_out(lp, cfg, x, pl=None):
    if pl is not None:
        lp = pl.layer(lp)
    return mamba_block(lp, cfg, x)[0]


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds=None, mesh=None):
    """Full-sequence forward. Returns (logits (B,S,V), 0.0 aux); on a
    mesh the logits are this rank's rows."""
    pl = _rows_place(params, cfg, mesh, tokens.shape[0])
    if pl is not None:
        tokens = pl.rows(tokens)
    x = _embed(params, cfg, tokens, pl)
    block = remat(_block_out, cfg, params)
    for lp in _layers(params, cfg.compute_dtype):
        x = block(lp, cfg, x, pl)
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    return x @ _head(params, cfg, pl), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    dtype = dtype or cfg.compute_dtype
    L = cfg.n_layers
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    dc = cfg.ssm_conv

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "ssm": zeros((L, batch, H, P, N), torch.float32),
        "hx": zeros((L, batch, dc - 1, cfg.d_inner), dtype),
        "hb": zeros((L, batch, dc - 1, N), dtype),
        "hc": zeros((L, batch, dc - 1, N), dtype),
        "length": zeros((batch,), torch.int32),
    }


def write_layer(cache: dict, i: int, st, hx, hb, hc) -> None:
    """Layer ``i``'s SSD state and conv tails into ``cache``, in place;
    on a mesh the rank's block of each (``transformer.local``)."""
    for name, v in (("ssm", st), ("hx", hx), ("hb", hb), ("hc", hc)):
        cache[name][i].copy_(local(cache, name, v))


@dataclass(frozen=True)
class StatePart:
    """What a rank's decode step updates on a mesh: ``heads``, the heads
    of its ``ssm`` block; ``hx_block``, the channels of its ``hx`` block.
    When those are the channels of ``heads`` the step runs on its own
    block; else (``hx`` split where ``ssm`` is not: H not divisible by
    the axis) it gathers ``hx`` whole and runs every head."""
    mesh: object
    heads: slice
    head_axes: tuple
    hx_block: slice
    hx_axes: tuple

    @classmethod
    def of(cls, cache) -> "StatePart":
        blk = placement.block(cache.spec("ssm"), cache.shapes["ssm"],
                              cache.mesh)
        hblk = placement.block(cache.spec("hx"), cache.shapes["hx"],
                               cache.mesh)
        return cls(cache.mesh, blk[2], placement.axes_of(
            cache.spec("ssm")[2]), hblk[3], placement.axes_of(
            cache.spec("hx")[3]))

    def join(self, y: torch.Tensor) -> torch.Tensor:
        """The heads' y gathered over the heads' axes (dim 1)."""
        return placement.gather(y, self.mesh, self.head_axes, 1)


def decode_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor, cache,
                 i: int, part: StatePart | None = None) -> torch.Tensor:
    """Layer ``i``'s mamba decode step against ``cache``, whose state and
    conv tails it updates in place; ``part``: this rank's on a mesh."""
    hx = cache["hx"][i]
    if part is None:
        x, (st, (hx, hb, hc)) = mamba_decode_step(
            lp, cfg, x, cache["ssm"][i], (hx, cache["hb"][i],
                                          cache["hc"][i]))
        write_layer(cache, i, st, hx, hb, hc)
        return x
    p_ = cfg.ssm_headdim
    own = (part.hx_block.start, part.hx_block.stop) == (
        part.heads.start * p_, part.heads.stop * p_)
    if not own:
        if part.head_axes:
            raise ValueError("the ssm state's heads and the hx channels "
                             "are split differently")
        hx = placement.gather(hx, part.mesh, part.hx_axes, 2)
    x, (st, (hx, hb, hc)) = mamba_decode_step(
        lp, cfg, x, cache["ssm"][i], (hx, cache["hb"][i], cache["hc"][i]),
        heads=part.heads, join=part.join if part.head_axes else None)
    if not own:
        hx = hx[..., part.hx_block]
    write_layer(cache, i, st, hx, hb, hc)
    return x


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, mesh=None):
    """Run the prompt, return (cache, last_logits). The cache is O(1) in
    the sequence length: the final SSD state and conv tails per layer;
    on a mesh this rank's block of it and its rows of the logits."""
    b, s = tokens.shape
    pl = prefill_place(params, cfg, mesh, b)
    if pl is not None:
        tokens = pl.rows(tokens)
    x = _embed(params, cfg, tokens, pl)
    cache = new_cache(init_cache, cfg, b, max_len or s, mesh, x.device)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        x, (st, hx, hb, hc) = mamba_block(lp, cfg, x)
        write_layer(cache, i, st, hx, hb, hc)
    x = rms_norm(x[:, -1:], _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    cache["length"].fill_(s)
    return cache, logits


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, mesh=None):
    """One decode step. token: (B, 1) i32. Returns (cache, logits (B,V));
    the state and conv tails are updated in place (module docstring). On
    a mesh the cache is this rank's ``placement.Sharded`` block and
    ``token`` the whole column; the logits are this rank's rows."""
    pl = decode_place(params, cfg, cache, mesh)
    part = None
    if pl is not None:
        token, part = pl.rows(token), StatePart.of(cache)
    x = _embed(params, cfg, token, pl)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        x = decode_layer(lp, cfg, x, cache, i, part)
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    out = dict(cache, length=cache["length"] + 1)
    return (cache.with_values(out) if pl is not None else out), logits
