"""Gradient compression for the cross-pod all-reduce
(``repro.training.compression``'s counterpart).

int8 error-feedback quantization: each pod quantizes its local gradient
to int8 with a per-leaf scale shared by every pod (a MAX all-reduce),
sums the int8 payload (in int32, so it cannot overflow across pods) with
an ``all_reduce`` over the pod group, dequantizes, and keeps the
quantization residual in a persistent error-feedback buffer added back
next step. The f32 operations are JAX's, in JAX's order, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.gson.distributed import _comm_device


def init_ef_state(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return x
    xs = x.to(_comm_device(group, x), copy=True).contiguous()
    dist.all_reduce(xs, op=op, group=group)
    return xs.to(x.device)


def compressed_psum(grads: dict, ef: dict, group, n_shards: int, *,
                    scale_group=None):
    """int8-quantized sum over the ranks of ``group`` (None: one rank)
    with error feedback. Collective.

    Returns (mean_grads_f32, new_ef). ``scale_group`` is where each
    leaf's largest magnitude is taken (a MAX all-reduce), ``group`` when
    None; ranks that hold blocks of the leaves pass a group over all of
    them, so that the scale is the whole leaf's, as it is in JAX.
    """
    scale_group = group if scale_group is None else scale_group
    out, new_ef = {}, {}
    for k in grads:
        g = grads[k].float() + ef[k]
        # shared scale (max over the pods) so the int8 payloads sum exactly
        scale = _all_reduce(torch.clamp(g.abs().max(), min=1e-12) / 127.0,
                            scale_group, dist.ReduceOp.MAX)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_ef[k] = g - q.float() * scale  # local residual
        summed = _all_reduce(q.to(torch.int32), group, dist.ReduceOp.SUM)
        deq = summed.float() * scale
        out[k] = deq / n_shards
    return out, new_ef
