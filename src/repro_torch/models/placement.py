"""How a rank of an ``LMMesh`` holds and computes with sharded tensors:
the port's realization of GSPMD's partitioning (no JAX counterpart: XLA
does this inside ``jit``).

* **Storage follows the spec.** :class:`Sharded` is a dict of this
  rank's local shards beside each entry's spec (``common.P``) and global
  shape: exactly the block of every parameter, optimizer moment and
  cache leaf that its spec gives (:func:`shard_params`,
  :func:`shard_cache`; :func:`gather_params` is the inverse). The layer
  axis is never sharded.
* **Compute gathers what it reads, one layer at a time.** :class:`Place`
  is one call's view: inside the layer loop each leaf's layer slice is
  gathered over the axes its spec names (:func:`gather`, whose forward is
  ``all_gather_into_tensor`` and whose backward ``reduce_scatter_tensor``
  over the same group), and the rank computes on its rows of the batch
  (``Place.rows``). Tensor parallelism over ``model`` is thus sharded
  storage with the compute replicated on the rank's rows, not Megatron's
  column/row products, and sequence parallelism's saving on residuals is
  not realized: both are speed work, and a sharding never changes a
  value.
* **Gradients are partial sums.** Each rank's loss is its share of the
  global loss (the shares over all ranks sum to it), so the gradient a
  rank's backward leaves is its share too; every collective's backward
  is its transpose in that convention (a gather's is a reduce-scatter,
  a sum's over shards a sum, ``all_to_all``'s ``all_to_all``), and
  :func:`reduce_grads` sums each leaf's share over the axes its spec does
  not name. A rank thus ends with its shard of the exact gradient.

Tensors of a collective live on the rank's card under NCCL and on the
host under gloo (``_comm_device``, the backend's own placement; compute
stays on the rank's device). A collective over one rank is the identity.
Every function here that reads across ranks is collective.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.gson.distributed import _comm_device
from repro_torch.launch.mesh import LMMesh, axes_of


def check_mesh(mesh) -> LMMesh | None:
    """``mesh`` itself: None, or an ``LMMesh``; anything else raises."""
    if mesh is not None and not isinstance(mesh, LMMesh):
        raise TypeError(
            f"mesh must be a repro_torch.launch.mesh.LMMesh (or None), got "
            f"{type(mesh).__name__}")
    return mesh


def entries(spec, ndim: int) -> tuple:
    """The spec's entries padded with None to ``ndim`` dimensions."""
    spec = tuple(spec or ())
    return spec + (None,) * (ndim - len(spec))


class Sharded(dict):
    """This rank's local shards (a dict of tensors) with ``specs`` (name ->
    ``P``), ``shapes`` (name -> global shape) and the ``mesh``."""

    def __init__(self, local: dict, specs: dict, shapes: dict, mesh: LMMesh):
        super().__init__(local)
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.mesh = mesh

    def with_values(self, local: dict) -> "Sharded":
        """The same specs, shapes and mesh over other local tensors."""
        return Sharded(local, self.specs, self.shapes, self.mesh)

    def spec(self, name: str) -> tuple:
        return entries(self.specs.get(name), self[name].dim())


def block(spec, shape, mesh: LMMesh) -> tuple:
    """This rank's slices of a tensor of global ``shape`` under ``spec``;
    a dimension its axes do not divide raises."""
    out = []
    for dim, e in zip(shape, entries(spec, len(shape))):
        n = mesh.size(e)
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} is not "
                             f"divisible by the {n} shards of {e!r}")
        lo = mesh.index(e) * (dim // n)
        out.append(slice(lo, lo + dim // n))
    return tuple(out)


def shard_count(spec, mesh: LMMesh) -> int:
    """Into how many blocks ``spec`` cuts a tensor on ``mesh``."""
    return math.prod(mesh.size(e) for e in tuple(spec or ()))


def shard_params(full: dict, specs: dict, mesh: LMMesh) -> Sharded:
    """This rank's blocks of every entry of ``full`` (copies, on the
    entries' devices): parameters, moments or a cache."""
    local = {k: v[block(specs.get(k), v.shape, mesh)].clone()
             for k, v in full.items()}
    return Sharded(local, specs, {k: v.shape for k, v in full.items()}, mesh)


shard_cache = shard_params


def gather_params(tree: dict, specs: dict | None = None,
                  mesh: LMMesh | None = None) -> dict:
    """Collective: the whole tensors of a ``Sharded`` tree (or of a dict
    of blocks under ``specs`` on ``mesh``) on every rank; the inverse of
    :func:`shard_params`."""
    specs = tree.specs if specs is None else specs
    mesh = tree.mesh if mesh is None else mesh
    with torch.no_grad():
        return {k: gather_spec(v, specs.get(k), mesh)
                for k, v in tree.items()}


# ---------------------------------------------------------------------------
# collectives


def _flat(name: str, old: str):
    """The collective ``name``, under its older name ``old`` in releases
    that lack it (newer ones deprecate the old name)."""
    return getattr(dist, name, None) or getattr(dist, old)


def _ag(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    dev = _comm_device(group, x)
    xs = x.movedim(dim, 0).contiguous().to(dev)
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=dev)
    _flat("all_gather_single", "all_gather_into_tensor")(out, xs, group=group)
    return out.to(x.device).movedim(0, dim)


def _rs(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    dev = _comm_device(group, x)
    xs = x.movedim(dim, 0).contiguous().to(dev)
    out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=dev)
    _flat("reduce_scatter_single", "reduce_scatter_tensor")(
        out, xs, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device).movedim(0, dim)


def _ar(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dev = _comm_device(group, x)
    xs = x.detach().to(dev, copy=True).contiguous()
    dist.all_reduce(xs, op=op, group=group)
    return xs.to(x.device)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    dev = _comm_device(group, x)
    xs = x.contiguous().to(dev)
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return out.to(x.device)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _ag(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _rs(g, ctx.group, ctx.dim), None, None


class _SumShares(torch.autograd.Function):
    """Sum over ranks of values whose cotangents are shares too: the
    backward is the same sum."""

    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        y = _ar(x, group)
        return y / dist.get_world_size(group) if mean else y

    @staticmethod
    def backward(ctx, g):
        y = _ar(g, ctx.group)
        return (y / dist.get_world_size(ctx.group) if ctx.mean else y,
                None, None)


class _Total(torch.autograd.Function):
    """The sum over ranks of each rank's share of a loss; each rank's
    backward then differentiates its own share."""

    @staticmethod
    def forward(ctx, x, group):
        return _ar(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def gather(x: torch.Tensor, mesh: LMMesh, axes, dim: int) -> torch.Tensor:
    """Collective over ``axes``: the blocks of every rank of the group
    joined along ``dim`` (backward: the reduce-scatter of the cotangent)."""
    group = mesh.group(axes)
    return x if group is None else _Gather.apply(x, group, dim)


def gather_spec(x: torch.Tensor, spec, mesh: LMMesh, keep=()) -> torch.Tensor:
    """``x`` (a block under ``spec``) gathered whole along every sharded
    dimension but those in ``keep``."""
    for d, e in enumerate(entries(spec, x.dim())):
        if d not in keep and mesh.size(e) > 1:
            x = gather(x, mesh, e, d)
    return x


def psum_shares(x: torch.Tensor, mesh: LMMesh, axes,
                mean: bool = False) -> torch.Tensor:
    """Collective: the sum (or mean) over ``axes`` of per-rank values
    (router statistics); differentiable in the share convention."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _SumShares.apply(x, group, mean)


def total(share: torch.Tensor, mesh: LMMesh, axes) -> torch.Tensor:
    """Collective: the sum over ``axes`` of each rank's share of a loss;
    its gradient on each rank is that of the rank's own share."""
    group = mesh.group(axes)
    return share if group is None else _Total.apply(share, group)


def reduce(x: torch.Tensor, mesh: LMMesh, axes,
           op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Collective, not differentiated: ``x`` reduced over ``axes``."""
    group = mesh.group(axes)
    return x if group is None else _ar(x, group, op)


def all_to_all(x: torch.Tensor, mesh: LMMesh, axes) -> torch.Tensor:
    """Collective over ``axes``: block j of ``x``'s leading axis goes to
    the group's rank j, which gets the blocks in rank order."""
    group = mesh.group(axes)
    return x if group is None else _AllToAll.apply(x, group)


def reduce_grads(grads: dict, specs: dict, mesh: LMMesh) -> dict:
    """Collective: each rank's share of each leaf's gradient summed over
    the mesh's (non-manual) axes that the leaf's spec does not name, in
    one all-reduce per group of such axes."""
    buckets = {}
    for k in sorted(grads):
        named = {a for e in tuple(specs.get(k) or ()) for a in axes_of(e)}
        rest = tuple(a for a in mesh.auto_axes if a not in named)
        buckets.setdefault((rest, grads[k].dtype), []).append(k)
    out = dict(grads)
    for (rest, _), names in buckets.items():
        if mesh.group(rest) is None:
            continue
        flat = reduce(torch.cat([grads[k].reshape(-1) for k in names]),
                      mesh, rest)
        for k, piece in zip(names, flat.split([grads[k].numel()
                                               for k in names])):
            out[k] = piece.view(grads[k].shape)
    return out


def replicas(spec, mesh: LMMesh) -> int:
    """How many ranks of the whole mesh hold the same block."""
    named = {a for e in tuple(spec or ()) for a in axes_of(e)}
    return mesh.size(tuple(a for a in mesh.axis_names if a not in named))


# ---------------------------------------------------------------------------
# one call's view


def greedy_axes(mesh: LMMesh, axes, b: int) -> tuple:
    """The axes of ``axes`` (in order, skipping manual ones and those the
    mesh lacks) over which ``b`` rows split, each kept while the product
    divides ``b``: the rows' layout."""
    out, prod = [], 1
    for a in axes:
        if a in mesh.shape and a not in mesh.manual \
                and b % (prod * mesh.shape[a]) == 0:
            out.append(a)
            prod *= mesh.shape[a]
    return tuple(out)


class Place:
    """One call on a mesh: the parameters' specs and the rows' layout.

    ``bat`` are the axes the global batch's rows are split over (this
    rank holds block ``mesh.index(bat)``); the compute is replicated over
    the other axes. ``keep`` maps a layer leaf's name to the dimensions
    of its layer slice that stay sharded (the experts of the
    expert-parallel FFN)."""

    def __init__(self, mesh: LMMesh, params, bat: tuple = (), keep=None):
        if not isinstance(params, Sharded):
            raise TypeError(
                "on a mesh the parameters are this rank's shards: pass "
                "repro_torch.models.placement.shard_params(...)")
        self.mesh, self.params, self.bat = mesh, params, tuple(bat)
        self.keep = keep or {}

    @property
    def rep(self) -> int:
        """How many ranks compute on the same rows."""
        return self.mesh.size(tuple(a for a in self.mesh.auto_axes
                                    if a not in self.bat))

    def rows(self, x: torch.Tensor | None):
        """This rank's rows of a global batch tensor (None stays None)."""
        if x is None or not self.bat:
            return x
        b = x.shape[0] // self.mesh.size(self.bat)
        return x.narrow(0, self.mesh.index(self.bat) * b, b)

    def full(self, name: str, dtype) -> torch.Tensor:
        """Parameter ``name`` whole, cast to ``dtype`` before the gather."""
        return gather_spec(self.params[name].to(dtype),
                           self.params.spec(name), self.mesh)

    def layer(self, lp: dict, prefix: str = "layers",
              stacked: bool = True) -> dict:
        """A layer's local slices (the dict ``_layers`` yields) gathered
        by their specs; ``stacked=False``: leaves with no layer axis (the
        hybrid's shared block)."""
        out = {}
        for k, v in lp.items():
            spec = self.params.spec(f"{prefix}/{k}")[1 if stacked else 0:]
            out[k] = gather_spec(v, spec, self.mesh, self.keep.get(k, ()))
        return out
