"""RunSpec: one declarative description of a GSON experiment.

The paper's experiments are points in a (variant, model, surface) grid
with shared hyper-parameters (Sec. 3.1); a RunSpec is one such point plus
the execution knobs: pool geometry, run limits, backend and device.
``resolve(spec)`` turns it into the concrete strategy + Runtime the
session drives.

Two fields differ from ``repro.gson.RunSpec``: ``device`` (the port runs
on the card unless the caller asks for the CPU) and the default backend,
``"cuda-full"``, so that a default run goes through the kernels.

Distributed execution is declared the same way: a :class:`MeshSpec`
names a group of ``torch.distributed`` ranks, one process per device,
and ``RunSpec.mesh`` (signal-axis sharding of one network, the paper's
data partitioning) or ``FleetSpec.mesh`` (network-axis sharding of a
cohort, see ``repro_torch.gson.fleet``) places the run on it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch.distributed as dist

from repro_torch.core.gson.state import GSONParams
from repro_torch.gson.registry import (VARIANTS, resolve_backend,
                                       resolve_model, resolve_sampler)
from repro_torch.gson.variants import Runtime, VariantStrategy


@dataclass(frozen=True)
class MeshSpec:
    """A declarative device mesh: which axis to shard, over how many ranks.

    ``axis`` picks the parallelization strategy (paper Sec. 2.5 taxonomy,
    see ``repro_torch.core.gson.distributed``):

    * ``"network"`` — shard a *fleet*'s leading B axis: each rank owns
      ``B/ndev`` whole networks, no collective per iteration. Goes on
      :class:`~repro_torch.gson.fleet.FleetSpec`.
    * ``"signal"`` — shard the signal batch of ONE network's multi-signal
      step (the paper's data partitioning): each rank finds winners for
      its own signals, the Update phase runs replicated on every rank.
      Goes on :class:`RunSpec`; composes with any Find Winners backend.

    The port is SPMD: every rank runs the same driver code on its own
    device, one process per device, and the mesh is the process group of
    ranks ``0..ndev-1`` of the default ``torch.distributed`` group (the
    JAX package takes ``jax.devices()[:ndev]``). Ranks outside it hold no
    networks. ``devices=None`` uses the whole world. The spec is a frozen,
    hashable value (a cohort key); the group is built when a session
    starts (:meth:`build`), never at import time.
    """

    axis: str = "network"           # "network" | "signal"
    devices: int | None = None      # None = every rank of the world
    # the JAX package's shard_map axis label; the port has no shard_map
    # and ignores it (kept for parity, outside equality and the hash)
    axis_name: str = field(default="gson", compare=False)

    def __post_init__(self):
        if self.axis not in ("network", "signal"):
            raise ValueError(
                f"MeshSpec.axis must be 'network' (shard a fleet's B "
                f"axis) or 'signal' (shard one network's signal "
                f"batch); got {self.axis!r}")
        if self.devices is not None and self.devices < 1:
            raise ValueError(
                f"MeshSpec.devices must be >= 1 or None (= all "
                f"ranks), got {self.devices}")

    def ndev(self) -> int:
        """``devices``, or the world size when it is None."""
        if self.devices is not None:
            return self.devices
        _require_world(None)
        return dist.get_world_size()

    def build(self):
        """The process group of ranks ``0..ndev-1`` (memoized per spec and
        world, so equal specs share one group). Collective: every rank of
        the default group calls it, in the same order, since
        ``torch.distributed.new_group`` is (a mesh of the whole world is
        the default group itself). A rank outside the group gets
        ``torch.distributed.GroupMember.NON_GROUP_MEMBER``."""
        n = self.ndev()
        _require_world(n)
        world = dist.group.WORLD
        key = (self, n)
        hit = _GROUPS.get(key)
        if hit is not None and hit[0] is world:
            return hit[1]
        group = (world if n == dist.get_world_size()
                 else dist.new_group(list(range(n))))
        _GROUPS[key] = (world, group)
        return group


# (MeshSpec, ndev) -> (the default group it was built in, the group)
_GROUPS: dict = {}


def _require_world(n: int | None) -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a MeshSpec needs a torch.distributed process group, one "
            "process per device: start the ranks with torchrun (or "
            "torch.multiprocessing.spawn) and call "
            "torch.distributed.init_process_group(backend, "
            "init_method=..., rank=..., world_size=...) in each first")
    if n is not None and n > dist.get_world_size():
        raise RuntimeError(
            f"MeshSpec wants {n} ranks, the world has "
            f"{dist.get_world_size()}; start {n} processes (torchrun "
            f"--nproc-per-node={n}, or world_size={n})")


@dataclass(frozen=True)
class RunSpec:
    """Everything needed to reproduce one run (modulo the seed).

    Axis fields accept a registered name or a concrete object; the typed
    per-variant knobs live in ``variant_config`` (``None`` means the
    variant's defaults). ``mesh`` (optional, ``MeshSpec(axis="signal")``)
    shards the signal axis of the multi-signal step across the ranks of a
    ``torch.distributed`` group (see :class:`MeshSpec`).

    ``device="cuda"`` is ``cuda:{LOCAL_RANK}`` (the environment variable
    torchrun sets; 0 without it); a name with an index (``"cuda:0"``)
    is taken as it is, which is how several ranks share one card.
    """

    variant: str | Any = "multi"
    model: str | GSONParams = "soam"
    sampler: str | Any = "sphere"
    backend: str | Any | None = "cuda-full"
    variant_config: Any = None
    mesh: MeshSpec | None = None

    # pool geometry
    capacity: int = 4096
    dim: int = 3
    max_deg: int = 16

    # run limits + convergence (shared by all variants)
    max_iterations: int = 100_000
    max_signals: int = 50_000_000
    check_every: int = 10         # iterations between convergence checks
    qe_threshold: float = 1e-3    # GNG/GWR convergence
    n_probe: int = 2048

    device: str = "cuda"

    def replace(self, **kw) -> "RunSpec":
        return dataclasses.replace(self, **kw)


def resolve_variant(variant: str | Any) -> VariantStrategy:
    if isinstance(variant, str):
        variant = VARIANTS.get(variant)
    if isinstance(variant, type):
        # classes registered through the @VARIANTS.register decorator (or
        # passed directly) are instantiated: strategies are stateless, so
        # a fresh instance is equivalent to a singleton
        variant = variant()
    if not isinstance(variant, VariantStrategy):
        raise TypeError(
            f"variant must be a registered name or a VariantStrategy "
            f"(name, config_cls); got {type(variant)!r}")
    return variant


def resolve(spec: RunSpec) -> tuple[VariantStrategy, Runtime]:
    """Assemble the concrete strategy + runtime context from the spec."""
    strategy = resolve_variant(spec.variant)
    vcfg = spec.variant_config
    if vcfg is None:
        vcfg = strategy.config_cls()
    elif not isinstance(vcfg, strategy.config_cls):
        raise TypeError(
            f"variant {strategy.name!r} takes a "
            f"{strategy.config_cls.__name__}, got {type(vcfg).__name__}")
    be = resolve_backend(spec.backend)
    find_winners = be.find_winners
    if spec.mesh is not None:
        if spec.mesh.axis != "signal":
            raise ValueError(
                "RunSpec.mesh shards the signal axis of one network "
                "(MeshSpec(axis='signal')); to shard a fleet's network "
                "axis put the MeshSpec on the FleetSpec instead")
        # memoized per (group, backend): ONE sharded adapter instance, so
        # the cohort key (which holds find_winners) groups equal specs
        from repro_torch.core.gson.distributed import \
            signal_sharded_find_winners
        find_winners = signal_sharded_find_winners(
            spec.mesh.build(), find_winners)
    rt = Runtime(
        spec=spec,
        params=resolve_model(spec.model),
        vcfg=vcfg,
        sampler=resolve_sampler(spec.sampler),
        find_winners=find_winners,
        update_phase=be.update_phase,
    )
    return strategy, rt
