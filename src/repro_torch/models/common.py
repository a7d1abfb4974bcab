"""Shared model machinery of the port: configs, parameter tables and the
numerics primitives (``repro.models.common``'s counterparts).

Parameters are plain dicts of tensors keyed by name; layer-stacked
entries (``layers/*``) carry a leading layer axis. Every module defines
its parameters through ``ParamSet``, so two views derive from one table:
  * ``init(seed_or_generator, device)`` — materialised tensors;
  * ``shapes()``                         — the same tensors on the
    ``meta`` device (names, shapes and dtypes; nothing allocated).

The logical-axis sharding rules (``ShardingRules``, ``rules_for_mesh``,
``ParamSet.specs``) wait for the LM's meshes (ROADMAP A15f).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# smoke-test variants: same code paths, toy sizes
SMOKE_SHAPES = {
    "train_4k": ShapeCfg("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeCfg("long_500k", 256, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 5e5
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): one shared attention block every k mamba layers
    hybrid_attn_every: int = 6
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_ctx: int = 1500
    # --- vlm ---
    n_img_tokens: int = 256
    # --- numerics / partitioning ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"          # "full" | "none": checkpoint each layer
    #                              while gradients are taken
    attn_chunk: int = 512        # blockwise attention KV chunk
    # long-context capability marker (sub-quadratic path exists)
    subquadratic: bool = False

    @property
    def d_inner(self) -> int:    # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def pad_to_multiple(n: int, mult: int) -> int:
    return (n + mult - 1) // mult * mult


# ---------------------------------------------------------------------------
# ParamSet: one table -> init / shapes
# ---------------------------------------------------------------------------

@dataclass
class ParamDef:
    shape: tuple
    logical_axes: tuple
    init: str = "normal"         # normal | zeros | ones
    scale: float | None = None


class ParamSet:
    """Declarative parameter table for one module."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.defs: dict[str, ParamDef] = {}

    def add(self, name: str, shape: tuple, logical_axes: tuple,
            init: str = "normal", scale: float | None = None):
        assert len(shape) == len(logical_axes), name
        self.defs[name] = ParamDef(tuple(int(s) for s in shape),
                                   logical_axes, init, scale)

    def init(self, seed_or_generator=0, device="cuda") -> dict:
        """Materialised parameters on ``device``, drawn in sorted-name
        order with the JAX table's scales (``normal`` entries are
        ``scale * N(0, 1)``, ``scale`` defaulting to 1/sqrt(fan_in)).
        The values differ from JAX's threefry draws: parity goes through
        weights carried across (``repro_torch.convert``)."""
        dtype = self.cfg.param_dtype
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))
        out = {}
        for name, d in sorted(self.defs.items()):
            if d.init == "zeros":
                out[name] = torch.zeros(d.shape, dtype=dtype, device=device)
            elif d.init == "ones":
                out[name] = torch.ones(d.shape, dtype=dtype, device=device)
            else:
                fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
                scale = d.scale if d.scale is not None else 1.0 / np.sqrt(
                    max(fan_in, 1))
                x = torch.randn(d.shape, generator=gen, device=device,
                                dtype=torch.float32)
                out[name] = x.mul_(float(scale)).to(dtype)
        return out

    def shapes(self) -> dict:
        """The parameters as ``meta`` tensors: nothing is allocated."""
        return {name: torch.empty(d.shape, dtype=self.cfg.param_dtype,
                                  device="meta")
                for name, d in sorted(self.defs.items())}


# ---------------------------------------------------------------------------
# numerics primitives (the JAX cast sequence, op for op)
# ---------------------------------------------------------------------------

def cast_params(tree: dict, dtype) -> dict:
    """The tree in ``dtype``; a tensor already in it is returned as it is
    (no copy)."""
    return {k: v.to(dtype) for k, v in tree.items()}


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(dt) * gamma.to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * gamma.to(dt) + beta.to(dt)


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """The f32 (cos, sin) of ``rope`` for positions (..., S) and head
    width ``d``, shaped (..., S, 1, d/2): computed once, they serve q and
    k of every layer of one call."""
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = torch.pow(float(theta), -ar / half)
    angles = positions[..., :, None].to(torch.float32) * freq
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``rope`` with its tables given. A bf16 ``x`` times the f32 cos/sin
    promotes to f32 and is cast back at the end, as in JAX."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves not interleaved. x: (..., S, H, D),
    positions: (..., S); angles in f32."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean CE + z-loss, in f32."""
    logits = logits.float()
    lmax = logits.amax(dim=-1, keepdim=True)
    shifted = logits - lmax
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + lmax[..., 0]
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    tok = lse - gold + z_loss * lse.square()
    if mask is None:
        return tok.mean()
    mask = mask.float()
    return (tok * mask).sum() / mask.sum().clamp_min(1.0)

