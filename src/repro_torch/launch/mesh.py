"""Device meshes of the port's LM on ``torch.distributed``
(``repro.launch.mesh``'s counterpart).

The JAX package names its devices through a ``jax.sharding.Mesh``; the
port is SPMD, one process per device, as its GSON meshes are
(``repro_torch.core.gson.distributed``). An :class:`LMMesh` lays ranks
``0..n-1`` of the default process group out row-major over named axes
(``("data", "model")`` or ``("pod", "data", "model")``), and holds this
rank's coordinate on each axis and a process group for every axis and
every tuple of axes (the ranks that share this rank's coordinates on the
other axes, in rank order, which is the order of the shards along a
dimension split over that tuple). Building one is collective: every rank
of the world, also a rank outside the mesh, calls
``torch.distributed.new_group`` for every group, in one order. A group
of one rank is not built: a collective over it is the identity.

``mesh.devices`` is the array of ranks, shaped like the mesh, so code
that reads ``dict(zip(mesh.axis_names, mesh.devices.shape))`` reads a
JAX mesh and an ``LMMesh`` alike.

The JAX module keeps a TPU v5e's peak rates and memory here; the port
keeps the card's instead (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``NVLINK_BW``,
``HBM_PER_CARD``), read by ``launch/roofline.py`` and ``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist


# NVIDIA H100 SXM5 80GB, the card the port runs on
# (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
# "NVIDIA H100 80GB HBM3, 700.00 W"). The rates are the NVIDIA H100 Tensor
# Core GPU data sheet's for the SXM part at its 700 W limit; a card set
# below it runs slower under load.
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s (no sparsity)
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4 bytes/s per direction (900 GB/s both)
# device memory as torch.cuda.get_device_properties(0).total_memory
# reports it on that card
HBM_PER_CARD = 85_017_493_504


def axes_of(entry) -> tuple:
    """A spec entry (None, an axis name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True, eq=False)
class LMMesh:
    """Ranks ``0..n-1`` laid out over named axes; see the module
    docstring. ``manual`` names axes that a step handles by hand (the pod
    axis of the pod-manual train step, as JAX's ``shard_map`` over
    ``{'pod'}``): the model's layouts and reductions leave them out."""
    axis_names: tuple
    shape: dict                     # axis -> size, in axis order
    coords: dict                    # axis -> this rank's coordinate
    groups: dict = field(repr=False)  # axes tuple -> group (None: 1 rank)
    manual: frozenset = frozenset()

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.n).reshape(tuple(self.shape.values()))

    @property
    def n(self) -> int:
        return math.prod(self.shape.values())

    @property
    def member(self) -> bool:
        """Whether this rank lies in the mesh."""
        return bool(self.coords)

    @property
    def auto_axes(self) -> tuple:
        return tuple(a for a in self.axis_names if a not in self.manual)

    def _known(self, axes) -> tuple:
        """``axes`` without those the mesh does not have (size 1)."""
        return tuple(a for a in axes_of(axes) if a in self.shape)

    def size(self, axes) -> int:
        """The number of shards along ``axes`` (1 for no axis, or one
        the mesh does not have)."""
        return math.prod(self.shape[a] for a in self._known(axes))

    def index(self, axes) -> int:
        """This rank's shard index along ``axes``, the first axis the
        most significant."""
        i = 0
        for a in self._known(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group over ``axes`` holding this rank, or None
        when it has one rank. The tuple must follow the mesh's axis
        order: the shards of a dimension split over it are then in the
        group's rank order."""
        key = tuple(a for a in self.axis_names if a in self._known(axes))
        if key != self._known(axes):
            raise ValueError(f"axes {axes} do not follow the mesh's order "
                             f"{self.axis_names}")
        if not self.member:
            raise RuntimeError("this rank lies outside the mesh")
        return self.groups.get(key)

    def manual_over(self, *axes) -> "LMMesh":
        """This mesh with ``axes`` handled by hand (the same groups)."""
        return dataclasses.replace(self, manual=self.manual | set(axes))


def build_mesh(shape, axes) -> LMMesh:
    """Collective: the mesh of ranks ``0..prod(shape)-1`` over ``axes``.
    Raises when the world is smaller than the mesh."""
    if not dist.is_initialized():
        raise RuntimeError(
            "an LMMesh needs a torch.distributed process group: start one "
            "process per device (torchrun, or "
            "repro_torch.core.gson.distributed.run_world)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, found {world}")
    rank = dist.get_rank()
    coords = (dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
              if rank < n else {})
    ranks = np.arange(n).reshape(shape)
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            if math.prod(shape[i] for i in sub) == 1:
                continue
            rest = [i for i in range(len(axes)) if i not in sub]
            # every rank builds every group, in one order
            moved = np.moveaxis(ranks, rest + list(sub),
                                range(len(axes))).reshape(
                -1, math.prod(shape[i] for i in sub))
            for members in moved:
                g = dist.new_group([int(r) for r in members])
                if rank in members:
                    groups[tuple(axes[i] for i in sub)] = g
    return LMMesh(axes, dict(zip(axes, shape)), coords, groups)


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: the JAX package's production layouts. Collective;
    raises with the rank count when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> LMMesh:
    """A small mesh for multi-rank tests. Collective."""
    return build_mesh(shape, axes)
