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
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, ParamSet, rms_norm
from repro_torch.models.ssm import (mamba_block, mamba_decode_step,
                                    ssm_param_defs)
from repro_torch.models.transformer import (_embed, _head, _layers, no_mesh,
                                            remat)


def ssm_param_set(cfg: ModelConfig) -> ParamSet:
    ps = ParamSet(cfg)
    D, V = cfg.d_model, cfg.vocab
    ps.add("embed", (V, D), ("vocab_in", "embed"), scale=0.02)
    ps.add("lm_head", (D, V), ("embed", "vocab"))
    ps.add("final_norm", (D,), ("none",), init="ones")
    ssm_param_defs(ps, cfg)
    return ps


def _block_out(lp, cfg, x):
    return mamba_block(lp, cfg, x)[0]


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds=None, mesh=None):
    """Full-sequence forward. Returns (logits (B,S,V), 0.0 aux)."""
    no_mesh(mesh, "ssm")
    x = _embed(params, cfg, tokens)
    block = remat(_block_out, cfg, params)
    for lp in _layers(params, cfg.compute_dtype):
        x = block(lp, cfg, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


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
    """Layer ``i``'s SSD state and conv tails into ``cache``, in place."""
    cache["ssm"][i].copy_(st)
    cache["hx"][i].copy_(hx)
    cache["hb"][i].copy_(hb)
    cache["hc"][i].copy_(hc)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, mesh=None):
    """Run the prompt, return (cache, last_logits). The cache is O(1) in
    the sequence length: the final SSD state and conv tails per layer."""
    no_mesh(mesh, "ssm")
    x = _embed(params, cfg, tokens)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, device=x.device)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        x, (st, hx, hb, hc) = mamba_block(lp, cfg, x)
        write_layer(cache, i, st, hx, hb, hc)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    cache["length"].fill_(s)
    return cache, logits


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, mesh=None):
    """One decode step. token: (B, 1) i32. Returns (cache, logits (B,V));
    the state and conv tails are updated in place (module docstring)."""
    no_mesh(mesh, "ssm")
    x = _embed(params, cfg, token)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        x, (st, (hx, hb, hc)) = mamba_decode_step(
            lp, cfg, x, cache["ssm"][i],
            (cache["hx"][i], cache["hb"][i], cache["hc"][i]))
        write_layer(cache, i, st, hx, hb, hc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    return dict(cache, length=cache["length"] + 1), logits
