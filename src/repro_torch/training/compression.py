"""Gradient compression for the cross-pod all-reduce
(``repro.training.compression``'s counterpart).

``init_ef_state`` is the error-feedback buffer (f32 zeros shaped like
the parameters). ``compressed_psum``, the int8 error-feedback psum over
the pod axis, needs a process group and waits for the LM's meshes
(ROADMAP A15f).
"""
from __future__ import annotations

import torch


def init_ef_state(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_psum(grads, ef, axis_name: str, n_shards: int):
    raise NotImplementedError(
        "the int8 error-feedback psum over pods is not ported yet: "
        "ROADMAP A15f")
