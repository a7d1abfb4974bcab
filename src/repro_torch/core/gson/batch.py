"""The leading network axis: per-network gathers and scatters, and the
B = 1 view of functions written for a fleet.

Every tensor of a fleet carries a leading axis of B networks; per-unit
tables are ``(B, C, ...)`` and per-signal ones ``(B, M, ...)``. Index
tensors hold unit ids of their own network, so a gather or scatter goes
through flat indices ``b * C + c`` into a ``(B * C, ...)`` view of the
table. For B = 1 the offset is 0 and no offset op is issued, so one
network costs the device ops it cost before the axis was added.

``batchable(rank)`` lets a function written for the axis take an
unbatched network too: when its first argument has one dimension fewer
than ``rank``, every tensor argument (and ``NetworkState``) gets a
leading axis of 1 and every result loses it again. These are views; the
device sees no extra op.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.gson.state import NetworkState

_OFFSETS: dict = {}


def _offsets(B: int, n: int, device) -> torch.Tensor:
    """(B,) int64 tensor ``b * n``, cached per (B, n, device)."""
    key = (B, n, str(device))
    off = _OFFSETS.get(key)
    if off is None:
        off = torch.arange(B, device=device, dtype=torch.int64) * n
        _OFFSETS[key] = off
    return off


def _flat(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row ids in [0, n) of each network -> ids into the (B * n) rows."""
    B = idx.shape[0]
    if B == 1:
        return idx
    return idx + _offsets(B, n, idx.device).view(B, *[1] * (idx.dim() - 1))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, ...]]`` for every network b: x (B, C, *t), idx
    (B, *s) of ids in [0, C) -> (B, *s, *t)."""
    B, C = x.shape[:2]
    if B == 1:
        return x[0][idx[0]][None]
    return x.reshape(B * C, *x.shape[2:])[_flat(idx, C)]


def _spare_rows(x: torch.Tensor, rows: torch.Tensor):
    """A flat copy of x with one spare row at the end, and ``rows`` as
    flat row ids into it: a row id equal to C (out of range) lands in the
    spare row, which the caller cuts off."""
    B, C = x.shape[:2]
    tail = tuple(x.shape[2:])
    ext = torch.cat([x.reshape(B * C, *tail), x.new_zeros((1, *tail))])
    rows = rows.long()
    if B > 1:
        rows = torch.where(rows < C, _flat(rows, C), B * C)
    return ext, rows


def put(x: torch.Tensor, index: tuple, values) -> torch.Tensor:
    """``x.at[index].set(values, mode="drop")`` per network. ``index`` is
    ``(rows,)`` or ``(rows, cols)`` with rows (B, ...) in [0, C], where C
    drops the entry; ``values`` a scalar or (B, *index shape, *tail).
    Returns a new tensor."""
    ext, rows = _spare_rows(x, index[0])
    ext[(rows, *index[1:])] = values
    return ext[:-1].view(x.shape)


def add(x: torch.Tensor, index: tuple, values: torch.Tensor) -> torch.Tensor:
    """``x.at[index].add(values, mode="drop")`` per network, same index
    rule as :func:`put`, for rows of x or (row, column) pairs of a
    (B, C, K) x. Uses ``index_add_`` over the flat rows: in index order
    on the CPU (so each network sums in the order it would alone), with
    float atomics (an order that varies from run to run) on a CUDA
    tensor."""
    tail = tuple(x.shape[2:])
    ext, rows = _spare_rows(x, index[0])
    if len(index) == 1:
        ext.index_add_(0, rows.reshape(-1), values.reshape((-1,) + tail))
    else:
        rows, cols = torch.broadcast_tensors(rows, index[1])
        ext.view(-1).index_add_(0, (rows * tail[0] + cols).reshape(-1),
                                values.reshape(-1))
    return ext[:-1].view(x.shape)


def stack(tensors: list) -> torch.Tensor:
    """Per-network tensors stacked on a new leading axis (a view for
    one)."""
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def _map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, NetworkState):
        return obj.map(fn)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # NamedTuple
        return type(obj)(*(_map(fn, o) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, o) for o in obj)
    return obj


def _rank(first) -> int:
    return (first.w.dim() if isinstance(first, NetworkState)
            else first.dim())


def batchable(rank: int):
    """Decorator: ``fn`` takes a leading network axis, its first argument
    having ``rank`` dimensions (a ``NetworkState`` counts its ``w``);
    called with one dimension fewer, it runs as a fleet of one."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if _rank(args[0]) == rank:
                return fn(*args, **kw)

            def up(t):
                return t[None]
            out = fn(*_map(up, args), **{k: _map(up, v)
                                         for k, v in kw.items()})
            return _map(lambda t: t[0], out)
        return call
    return wrap
