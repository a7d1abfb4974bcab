"""Shared model machinery of the port: configs, parameter tables and the
numerics primitives (``repro.models.common``'s counterparts).

Parameters are plain dicts of tensors keyed by name; layer-stacked
entries (``layers/*``) carry a leading layer axis. Every module defines
its parameters through ``ParamSet``, so two views derive from one table:
  * ``init(seed_or_generator, device)`` — materialised tensors;
  * ``shapes()``                         — the same tensors on the
    ``meta`` device (names, shapes and dtypes; nothing allocated);
  * ``specs(rules)``                     — the same names mapped to a
    partition spec ``P`` (JAX's logical-axis rules, ``ShardingRules``).

``P`` is the port's PartitionSpec: a tuple with one entry per dimension,
each None, a mesh axis name or a tuple of names. How a rank holds and
computes with what a spec says is ``repro_torch.models.placement``'s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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
# logical-axis -> mesh-axis rules
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry per dimension (None, an axis name or a
    tuple of axis names), ``jax.sharding.PartitionSpec``'s counterpart."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical param/activation axes to mesh axes (or None)."""
    tensor_axis: str | None = "model"    # TP
    fsdp_axis: str | tuple | None = "data"  # param FSDP
    batch_axes: tuple = ("pod", "data")  # activation batch sharding
    # lm_head vocab axis: kept on 'model' even when TP is off so logits
    # stay vocab-sharded
    vocab_axis: str | None = "model"
    mesh_axis_sizes: dict = field(default_factory=dict)

    def axis_for(self, logical: str, dim_size: int):
        """Physical mesh axis (or axis tuple) for a logical axis,
        honoring divisibility. ``fsdp_axis`` may be a tuple
        (("data","model") for pure-DP big models: ZeRO-3-wide)."""
        table = {
            "layer": None,
            "embed": self.fsdp_axis,
            "embed_no_fsdp": None,
            "heads": self.tensor_axis,
            "kv": self.tensor_axis,
            "mlp": self.tensor_axis,
            "vocab": self.vocab_axis,
            # input-embedding vocab axis: replicated over TP so the token
            # gather needs no collective
            "vocab_in": None,
            "experts": self.tensor_axis,
            # expert matrices carry FSDP on their input dim
            "expert_in": self.fsdp_axis,
            "expert_out": None,
            "ssm_heads": self.tensor_axis,
            "ssm_state": None,
            "conv": None,
            "none": None,
        }
        ax = table[logical]
        if ax is None:
            return None
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= self.mesh_axis_sizes.get(a, 1)
        if dim_size % size != 0:
            return None  # not divisible -> replicate
        return ax

    def spec_for(self, logical_axes: tuple, shape: tuple) -> P:
        used = set()
        out = []
        for name, dim in zip(logical_axes, shape):
            ax = self.axis_for(name, dim)
            parts = ax if isinstance(ax, tuple) else (ax,)
            if any(p in used for p in parts if p):  # axis used once only
                ax = None
            elif ax is not None:
                used.update(p for p in parts if p)
            out.append(ax)
        return P(*out)

    def batch_spec(self, *trailing) -> P:
        axes = tuple(a for a in self.batch_axes
                     if a in self.mesh_axis_sizes)
        return P(axes if axes else None, *trailing)


def rules_for_mesh(mesh) -> ShardingRules:
    """The rules of a mesh (an ``LMMesh``, or anything with
    ``axis_names`` and ``devices.shape``)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return ShardingRules(mesh_axis_sizes=sizes,
                         vocab_axis="model" if "model" in sizes else None,
                         batch_axes=tuple(a for a in ("pod", "data")
                                          if a in sizes))


# ---------------------------------------------------------------------------
# ParamSet: one table -> init / shapes / specs
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

    def specs(self, rules: ShardingRules) -> dict:
        return {name: rules.spec_for(d.logical_axes, d.shape)
                for name, d in sorted(self.defs.items())}


# ---------------------------------------------------------------------------
# numerics primitives (the JAX cast sequence, op for op)
# ---------------------------------------------------------------------------

def cast_params(tree: dict, dtype) -> dict:
    """The tree in ``dtype``; a tensor already in it is returned as it is
    (no copy). A ``placement.Sharded`` tree stays one, with its specs."""
    out = {k: v.to(dtype) for k, v in tree.items()}
    return tree.with_values(out) if hasattr(tree, "with_values") else out


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

