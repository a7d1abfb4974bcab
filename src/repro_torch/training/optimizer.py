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
new ones.

On a mesh the parameters, gradients and moments are this rank's blocks
(``match_opt_specs`` gives the moments' specs, each inheriting its
parameter's). AdamW is elementwise and needs no collective;
``clip_by_global_norm`` and Adafactor's means (its factored moments and
the update's RMS) sum over the axes their blocks are split on, given the
leaves' ``specs`` and the ``mesh``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import placement
from repro_torch.models.common import P


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
    """Specs for opt state, shape-aware (handles factored leaves)."""
    if cfg.name == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}

    def full(p, s):
        return tuple(s) + (None,) * (len(p.shape) - len(tuple(s)))

    def vr(p, s):
        s = full(p, s)
        return P(*s[:-1]) if _factored(cfg, p.shape) else P(*s)

    def vc(p, s):
        s = full(p, s)
        return P(*(s[:-2] + s[-1:])) if _factored(cfg, p.shape) else P()

    return {"vr": {k: vr(p, param_specs[k]) for k, p in params_shapes.items()},
            "vc": {k: vc(p, param_specs[k]) for k, p in params_shapes.items()},
            "step": P()}


def _mean(x: torch.Tensor, dims: tuple, spec, mesh, keepdim=False):
    """``x.mean(dims)`` of a block under ``spec`` as of the whole tensor:
    the sum over the axes splitting ``dims``, over the whole count."""
    if mesh is None:
        return (x.mean() if len(dims) == x.dim() and not keepdim
                else x.mean(dim=dims, keepdim=keepdim))
    e = placement.entries(spec, x.dim())
    axes = tuple(a for a in mesh.axis_names
                 if any(a in placement.axes_of(e[d]) for d in dims))
    n = 1
    for d in dims:
        n *= x.shape[d] * mesh.size(e[d])
    return placement.reduce(x.sum(dim=dims, keepdim=keepdim), mesh,
                            axes) / n


def clip_by_global_norm(grads: dict, max_norm: float, specs=None, mesh=None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping as a 0-d f32 tensor); the scale is cast to each
    gradient's dtype, as in JAX. On a mesh the grads are blocks under
    ``specs`` (collective)."""
    if mesh is not None:
        sq = sum(torch.sum(torch.square(grads[k].float()))
                 / placement.replicas(specs[k], mesh) for k in sorted(grads))
        gn = torch.sqrt(placement.reduce(sq, mesh, mesh.axis_names))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gn
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
                 inplace: bool = False, specs=None, mesh=None):
    """Returns (new_params, new_state). Grads may be bf16; the math is in
    f32 and each parameter comes back in its own dtype. On a mesh (the
    leaves blocks under ``specs``) Adafactor's means are collective."""
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
        spec = None if mesh is None else specs[k]
        nd = g.dim()
        if _factored(cfg, p.shape):
            vr_n = beta2 * vr + (1 - beta2) * _mean(g2, (nd - 1,), spec, mesh)
            vc_n = beta2 * vc + (1 - beta2) * _mean(g2, (nd - 2,), spec, mesh)
            r = vr_n / torch.clamp(_mean(vr_n, (nd - 2,), spec, mesh,
                                         keepdim=True), min=1e-30)
            pre = r[..., None] * vc_n[..., None, :]
            update = g / torch.sqrt(pre + cfg.eps)
        else:
            vr_n, vc_n = beta2 * vr + (1 - beta2) * g2, vc
            update = g / torch.sqrt(vr_n + cfg.eps)
        # relative step clipping (RMS-1) as in the paper
        rms = torch.sqrt(_mean(update * update, tuple(range(nd)), spec, mesh)
                         + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        out = p32 - cfg.lr * update - cfg.lr * cfg.weight_decay * p32
        new_p[k] = _put(p, out.to(p.dtype), inplace)
        new_vr[k] = _put(vr, vr_n, inplace)
        new_vc[k] = _put(vc, vc_n, inplace)
    return new_p, {"vr": new_vr, "vc": new_vc,
                   "step": _put(state["step"], step, inplace)}
