"""Uniform model API of the port, consumed by the server
(``repro.models.registry``'s counterpart).

``get_bundle(cfg)`` returns a ModelBundle exposing:
  init / param_shapes / param_specs      — parameters (3 views, 1 table)
  loss(params, batch)                    — training objective
  forward(params, batch)                 — prefill-style full forward
  init_cache / decode_step / prefill     — serving
  cache_shapes / input_specs(shape)      — ``meta`` tensors (no memory)

It serves every family of the JAX package: ``dense``, ``vlm`` and
``moe`` (the MoE FFN on its dense reference path,
``repro_torch.models.moe``) through ``transformer``, ``ssm``
(``ssm_lm``), ``hybrid`` and ``encdec``, each on one device or on a
mesh (an ``LMMesh``, with parameters and caches held as
``repro_torch.models.placement`` says; a mesh loss is this rank's share
of the global loss, ``transformer.mesh_loss``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.common import (ModelConfig, ParamSet, ShapeCfg,
                                       cross_entropy_loss)


@dataclass
class ModelBundle:
    cfg: ModelConfig
    param_set: ParamSet
    _loss: Callable
    _forward: Callable
    _init_cache: Callable | None = None
    _decode_step: Callable | None = None
    _prefill: Callable | None = None

    # ---- parameters -----------------------------------------------------
    def init(self, seed_or_generator=0, device="cuda") -> dict:
        """Parameters on ``device`` (the card unless the caller asks for
        the CPU), drawn from a seed or a ``torch.Generator``."""
        return self.param_set.init(seed_or_generator, device)

    def param_shapes(self) -> dict:
        return self.param_set.shapes()

    def param_specs(self, rules) -> dict:
        return self.param_set.specs(rules)

    # ---- compute --------------------------------------------------------
    def loss(self, params, batch, mesh=None):
        return self._loss(params, self.cfg, batch, mesh=mesh)

    def forward(self, params, batch, mesh=None):
        return self._forward(params, self.cfg, batch, mesh=mesh)

    @property
    def can_decode(self) -> bool:
        return self._decode_step is not None

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self._init_cache(self.cfg, batch, max_len, device=device)

    def decode_step(self, params, cache, token, mesh=None):
        """(cache, logits); writes the step into ``cache`` in place (its
        K/V, or an SSM's state and conv tails)."""
        return self._decode_step(params, self.cfg, cache, token, mesh=mesh)

    def prefill(self, params, batch, max_len=None, mesh=None):
        """Prompt pass -> (cache, last_logits). ``batch`` as input_specs:
        an enc-dec batch's ``frames`` are encoded first; a vlm batch's
        image prefix and text prompt share one sequence."""
        if self.cfg.family == "encdec":
            return self._prefill(params, self.cfg, batch["tokens"],
                                 batch["frames"], max_len=max_len,
                                 mesh=mesh)
        if self.cfg.family == "vlm":
            return self._prefill(params, self.cfg, batch["tokens"],
                                 max_len=max_len, mesh=mesh,
                                 img_embeds=batch.get("img_embeds"))
        return self._prefill(params, self.cfg, batch["tokens"],
                             max_len=max_len, mesh=mesh)

    def cache_shapes(self, batch: int, max_len: int):
        return self._init_cache(self.cfg, batch, max_len, device="meta")

    # ---- inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeCfg) -> dict:
        """``meta`` tensors standing in for every model input of this
        cell."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            t = s - cfg.n_img_tokens if cfg.family == "vlm" else s
            specs = {"tokens": meta((b, t))}
            if shape.kind == "train":
                specs["labels"] = meta((b, t))
            if cfg.family == "vlm":
                specs["img_embeds"] = meta((b, cfg.n_img_tokens, cfg.d_model),
                                           torch.float32)
            if cfg.family == "encdec":
                specs["frames"] = meta((b, cfg.encoder_ctx, cfg.d_model),
                                       torch.float32)
            return specs
        # decode: one new token against a seq_len cache
        return {"token": meta((b, 1)), "cache": self.cache_shapes(b, s)}


# ---------------------------------------------------------------------------
# family wiring
# ---------------------------------------------------------------------------

def _dense_loss(params, cfg, batch, mesh=None):
    return transformer.loss_fn(params, cfg, batch, mesh=mesh)


def _dense_forward(params, cfg, batch, mesh=None):
    return transformer.forward(params, cfg, batch["tokens"],
                               batch.get("img_embeds"), mesh=mesh)


def _logits_loss(params, cfg, logits, aux, labels, mesh):
    """The token-mean cross entropy of ``logits`` (this rank's rows on a
    mesh, whose loss is then its share of the global one)."""
    if mesh is not None:
        pl = transformer._rows_place(params, cfg, mesh, labels.shape[0])
        return transformer.mesh_loss(logits, pl.rows(labels), aux, cfg, pl)
    ce = cross_entropy_loss(logits, labels.clamp_min(0), labels >= 0)
    return ce, {"ce": ce, "aux": aux}


def _encdec_loss(params, cfg, batch, mesh=None):
    logits, aux = encdec.forward(params, cfg, batch["tokens"],
                                 batch["frames"], mesh=mesh)
    return _logits_loss(params, cfg, logits, aux, batch["labels"], mesh)


def _encdec_forward(params, cfg, batch, mesh=None):
    return encdec.forward(params, cfg, batch["tokens"], batch["frames"],
                          mesh=mesh)


def _simple_loss(fwd):
    def loss(params, cfg, batch, mesh=None):
        logits, aux = fwd(params, cfg, batch["tokens"], mesh=mesh)
        return _logits_loss(params, cfg, logits, aux, batch["labels"], mesh)
    return loss


def _simple_forward(fwd):
    def forward(params, cfg, batch, mesh=None):
        return fwd(params, cfg, batch["tokens"], mesh=mesh)
    return forward


def get_bundle(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelBundle(
            cfg, transformer.dense_param_set(cfg),
            _dense_loss, _dense_forward,
            transformer.init_cache, transformer.decode_step,
            transformer.prefill)
    if fam == "encdec":
        # the decoder's self-attention cache; cross K/V at encoder_ctx
        return ModelBundle(
            cfg, encdec.encdec_param_set(cfg),
            _encdec_loss, _encdec_forward,
            encdec.init_cache, encdec.decode_step, encdec.prefill)
    if fam in ("ssm", "hybrid"):
        mod, table = ((ssm_lm, ssm_lm.ssm_param_set) if fam == "ssm"
                      else (hybrid, hybrid.hybrid_param_set))
        return ModelBundle(
            cfg, table(cfg), _simple_loss(mod.forward),
            _simple_forward(mod.forward), mod.init_cache, mod.decode_step,
            mod.prefill)
    raise ValueError(fam)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2, d_model=64, d_head=16, vocab=256,
        remat="none", attn_chunk=32, compute_dtype=torch.float32,
        param_dtype=torch.float32, rope_theta=1e4,
    )
    kw["n_heads"] = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kw["n_kv"] = min(cfg.n_kv, kw["n_heads"]) if cfg.n_kv else 0
    kw["d_ff"] = 128 if cfg.d_ff else 0
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2),
                  d_ff_expert=32,
                  n_shared_experts=min(cfg.n_shared_experts, 2))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_headdim=8, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(hybrid_attn_every=2, n_heads=4, n_kv=4, d_ff=128)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=2, encoder_ctx=24)
    if cfg.family == "vlm":
        kw.update(n_img_tokens=8)
    return cfg.replace(**kw)
