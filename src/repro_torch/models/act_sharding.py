"""Activation layouts, installed without threading rules through every
model signature (``repro.models.act_sharding``'s counterpart).

The step factories (``launch/steps.py``) install an
``ActivationSharding`` for the duration of a call; model code calls
``constrain(x, kind)`` where the JAX package does. In JAX that is a
sharding constraint for GSPMD. In the port's realization
(``repro_torch.models.placement``) a rank computes on its rows of the
batch with everything else replicated, so ``constrain`` returns ``x``
unchanged; what the context still decides is the rows' layout: the
full-sequence forward on a mesh splits the global batch over the
context's ``batch_axes`` (greedily, as ``residual_spec`` does), or over
the mesh's ``pod`` and ``data`` axes outside any context. ``seq_axis``
(sequence parallelism on residuals) is recorded and changes no value:
its memory saving is not realized (ROADMAP, differences kept on purpose).
``residual_spec`` is JAX's, for the specs it reports.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

from repro_torch.models.common import P

_STATE = threading.local()


@dataclass(frozen=True)
class ActivationSharding:
    batch_axes: tuple = ()
    seq_axis: str | None = None     # SP: shard S of (B, S, D) residuals

    def residual_spec(self, shape, axis_sizes: dict) -> P | None:
        if len(shape) != 3:
            return None
        bat_axes, prod = [], 1
        for a in self.batch_axes:   # greedy: divisibility vs the product
            size = max(axis_sizes.get(a, 1), 1)
            if shape[0] % (prod * size) == 0:
                bat_axes.append(a)
                prod *= size
        bat = tuple(bat_axes) if bat_axes else None
        seq = self.seq_axis
        if seq is not None and shape[1] % max(
                axis_sizes.get(seq, 1), 1) != 0:
            seq = None
        if bat is None and seq is None:
            return None
        return P(bat, seq, None)


@contextlib.contextmanager
def activation_sharding(spec: ActivationSharding, mesh,
                        manual_axes: frozenset = frozenset()):
    """Install ``spec`` for ``mesh``; ``manual_axes`` are the axes a step
    handles by hand (the pod axis of the pod-manual train step)."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (spec, mesh, frozenset(manual_axes))
    try:
        yield
    finally:
        _STATE.ctx = prev


def batch_axes(mesh) -> tuple:
    """The axes the full-sequence forward splits its rows over: the
    installed context's (without its manual axes), else the mesh's
    ``pod`` and ``data``."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    spec, _, manual = ctx
    return tuple(a for a in spec.batch_axes if a not in manual)


def constrain(x, kind: str = "residual"):
    """The identity: a rank already holds its rows (see the module
    docstring)."""
    return x
