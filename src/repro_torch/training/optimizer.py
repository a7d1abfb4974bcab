"""AdamW and Adafactor (factored second moment) on dicts of tensors
(``repro.training.optimizer``'s counterpart).

Plain functions, not ``torch.optim``: the state is a dict like JAX's
(AdamW ``m``/``v``/``step``; Adafactor ``vr``/``vc``/``step``) and every
update runs JAX's operations in JAX's order, so the two agree up to
rounding. The bias corrections come from an f32 step; AdamW's weight
decay sits inside its delta; Adafactor's ``beta2`` is ``1 - t**-0.8``
and its update is clipped to RMS 1.

``apply_update(..., inplace=True)`` writes the new parameters and
moments into the tensors it was given (what JAX's buffer donation
allows); with ``inplace=False`` it leaves them as they are and returns
new ones. Parameter sharding specs (``match_opt_specs``) wait for the
LM's meshes (ROADMAP A15f).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95             # adafactor: decay exponent toward 1
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    min_dim_factored: int = 128  # factor leaves with both dims >= this


def _factored(cfg: OptConfig, shape: tuple) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_factored
            and shape[-2] >= cfg.min_dim_factored)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def init_opt_state(cfg: OptConfig, params: dict) -> dict:
    """The optimizer's state for ``params`` (a dict of tensors, ``meta``
    ones too), in f32 on the parameters' devices; ``step`` is a 0-d
    int32 tensor."""
    dev = next(iter(params.values())).device if params else "cpu"
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "adamw":
        return {"m": {k: _zeros(p.shape, p) for k, p in params.items()},
                "v": {k: _zeros(p.shape, p) for k, p in params.items()},
                "step": step}
    if cfg.name == "adafactor":
        def vrow(p):
            if _factored(cfg, p.shape):
                return _zeros(p.shape[:-1], p)
            return _zeros(p.shape, p)

        def vcol(p):
            if _factored(cfg, p.shape):
                return _zeros(p.shape[:-2] + p.shape[-1:], p)
            return _zeros((1,), p)  # unused placeholder

        return {"vr": {k: vrow(p) for k, p in params.items()},
                "vc": {k: vcol(p) for k, p in params.items()},
                "step": step}
    raise ValueError(cfg.name)


def match_opt_specs(cfg: OptConfig, params_shapes, param_specs) -> dict:
    raise NotImplementedError(
        "optimizer-state sharding specs are not ported yet: ROADMAP A15f")


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping as a 0-d f32 tensor); the scale is cast to each
    gradient's dtype, as in JAX."""
    gn = torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                        for k in sorted(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gn


def _put(dst: torch.Tensor, src: torch.Tensor, inplace: bool):
    if inplace:
        dst.copy_(src)
        return dst
    return src


@torch.no_grad()
def apply_update(cfg: OptConfig, params: dict, grads: dict, state: dict,
                 inplace: bool = False):
    """Returns (new_params, new_state). Grads may be bf16; the math is in
    f32 and each parameter comes back in its own dtype."""
    step = state["step"] + 1
    t = step.float()
    if cfg.name == "adamw":
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            p32 = p.float()
            m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
            v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g * g
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
            new_p[k] = _put(p, (p32 - cfg.lr * delta).to(p.dtype), inplace)
            new_m[k] = _put(state["m"][k], m, inplace)
            new_v[k] = _put(state["v"][k], v, inplace)
        return new_p, {"m": new_m, "v": new_v,
                       "step": _put(state["step"], step, inplace)}
    if cfg.name != "adafactor":
        raise ValueError(cfg.name)

    beta2 = 1.0 - t ** (-0.8)            # schedule per Shazeer & Stern
    new_p, new_vr, new_vc = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        p32 = p.float()
        vr, vc = state["vr"][k], state["vc"][k]
        g2 = g * g + 1e-30
        if _factored(cfg, p.shape):
            vr_n = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
            vc_n = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
            r = vr_n / torch.clamp(vr_n.mean(dim=-1, keepdim=True), min=1e-30)
            pre = r[..., None] * vc_n[..., None, :]
            update = g / torch.sqrt(pre + cfg.eps)
        else:
            vr_n, vc_n = beta2 * vr + (1 - beta2) * g2, vc
            update = g / torch.sqrt(vr_n + cfg.eps)
        # relative step clipping (RMS-1) as in the paper
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        out = p32 - cfg.lr * update - cfg.lr * cfg.weight_decay * p32
        new_p[k] = _put(p, out.to(p.dtype), inplace)
        new_vr[k] = _put(vr, vr_n, inplace)
        new_vc[k] = _put(vc, vc_n, inplace)
    return new_p, {"vr": new_vr, "vc": new_vc,
                   "step": _put(state["step"], step, inplace)}
