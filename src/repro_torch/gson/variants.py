"""Variant strategies: the pluggable parallelization axis.

The paper's contribution is a *variant* of the growing-network loop —
same rule set, different execution schedule (Sec. 2.2: the multi-signal
iteration). A strategy is a stateless singleton registered in
``VARIANTS`` with a typed config dataclass (``config_cls``) and the two
things the one run driver (``repro_torch.gson.fleet.Cohort.tick``) asks
of it:

  fleet_mode                  — "host": one iteration per tick, the
                                paper's multi-signal loop; "device": whole
                                fused supersteps per tick; "scan": one
                                chunk of single signals per tick
  fleet_cfg(spec, params, vcfg) — the loop config (``SuperstepConfig``)

and, in "scan" mode, ``scan(params, cfg, vcfg, find_winners)``: the chunk
function ``(nets, signals) -> nets``.

Sessions and fleets both run through ``Cohort.tick``. ``fleet_capable =
True`` marks a strategy whose step is one program for B networks; the
sequential baselines (``single``, ``indexed``) run as a ``Session`` only.
The JAX strategies' ``step`` hook and its ``StepResult`` have no
counterpart: the one driver asks a strategy only for its tick mode.
:func:`check_convergence` is the JAX package's shared termination
predicate, selected by the model's registered ``convergence``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.ann import indexed_find_winners, indexed_scan
from repro_torch.core.gson import fleet as fleet_core
from repro_torch.core.gson.single import single_signal_scan
from repro_torch.core.gson.state import GSONParams
from repro_torch.core.gson.superstep import SuperstepConfig, next_pow2
from repro_torch.gson.registry import MODELS, VARIANTS

DEFAULT_BBOX = ((-3.0, -3.0, -3.0), (3.0, 3.0, 3.0))


@dataclass(frozen=True)
class MultiConfig:
    """Host-dispatched multi-signal loop (paper Sec. 2.2/2.5)."""

    fixed_m: int | None = None    # override the paper's m-schedule
    min_m: int = 4                # floor of the m-schedule
    refresh_every: int = 5        # SOAM topo refresh cadence (iterations)


@dataclass(frozen=True)
class FusedConfig:
    """Fused loop (up to ``superstep.length`` iterations per step)."""

    superstep: SuperstepConfig = field(default_factory=SuperstepConfig)
    fixed_m: int | None = None
    min_m: int = 4
    refresh_every: int = 5


@dataclass(frozen=True)
class SingleConfig:
    """Sequential single-signal baseline (the paper's reference)."""

    chunk: int = 256              # signals per tick
    refresh_every: int = 200      # SOAM refresh cadence, in signals


@dataclass(frozen=True)
class IndexedConfig:
    """Single-signal with the hash-grid Find Winners index (Sec. 3.1)."""

    chunk: int = 256
    refresh_every: int = 200
    grid_per_axis: int = 24
    per_cell_cap: int = 24
    rebuild_every: int = 64
    bbox: tuple = DEFAULT_BBOX    # ((min,)*dim, (max,)*dim)


@dataclass
class Runtime:
    """Resolved per-run context: the spec's axes as concrete objects;
    ``probes`` is the run's probe set where one is known
    (``Session.rt``)."""

    spec: Any                     # the RunSpec
    params: GSONParams
    vcfg: Any                     # the variant's typed config
    sampler: Any                  # f(gen, n) -> (n, dim) f32
    find_winners: Any             # FindWinnersFn | None
    update_phase: Any = None      # UpdatePhaseFn | None
    probes: torch.Tensor | None = None


@runtime_checkable
class VariantStrategy(Protocol):
    name: str
    config_cls: type


def convergence_mode(params: GSONParams) -> str:
    """The model's registered ``ModelDef.convergence``; "qe" for a model
    the registry does not hold."""
    return (MODELS.get(params.model).convergence if params.model in MODELS
            else "qe")


def check_convergence(rt: Runtime, state):
    """The termination predicate of one network: the run loop's own
    (``core.gson.fleet.convergence_check``), selected by the model's
    registered ``convergence``: "topology" runs SOAM's criterion on a
    fresh state ladder, "qe" compares the quantization error on
    ``rt.probes`` with the threshold. Returns ``(done, qe, state)``, the
    state with the fresh ladder where one was computed."""
    state, done, qe = fleet_core.convergence_check(
        state, rt.probes, params=rt.params,
        mode=convergence_mode(rt.params),
        qe_threshold=rt.spec.qe_threshold)
    return bool(done), float(qe), state


class _FleetBacked:
    """Shared base of the registered strategies: both run through the
    fleet core (``repro_torch.core.gson.fleet``), at B = 1 in a
    ``Session`` and at B = N in a ``FleetSession``."""

    fleet_capable = True
    fleet_mode = "host"

    def fleet_cfg(self, spec, params: GSONParams, vcfg) -> SuperstepConfig:
        """The loop config from the spec-level knobs."""
        raise NotImplementedError


class MultiVariant(_FleetBacked):
    """Host-dispatched multi-signal loop: one iteration per tick.

    The signal buffer has ``max_parallel`` rows and the device
    m-schedule masks in the first ``m_t = next_pow2(n_active)`` of them —
    the same iteration the fused loop runs, one at a time, as one
    ``fleet_iterate`` of a B = 1 fleet.
    """

    name = "multi"
    config_cls = MultiConfig

    def fleet_cfg(self, spec, params, vcfg) -> SuperstepConfig:
        if vcfg.fixed_m is not None:
            buf = min(params.max_parallel, vcfg.fixed_m)
        else:
            buf = min(params.max_parallel, next_pow2(spec.capacity))
        return SuperstepConfig(
            length=1, max_parallel=buf, min_m=vcfg.min_m,
            fixed_m=vcfg.fixed_m, refresh_every=vcfg.refresh_every,
            check_every=spec.check_every,
            qe_threshold=spec.qe_threshold)


class FusedVariant(_FleetBacked):
    """Whole iterate-sample-converge supersteps per tick."""

    name = "multi-fused"
    fleet_mode = "device"
    config_cls = FusedConfig

    def fleet_cfg(self, spec, params, vcfg) -> SuperstepConfig:
        ss = vcfg.superstep.resolve(spec.capacity, params)
        return dataclasses.replace(
            ss,
            refresh_every=vcfg.refresh_every,
            check_every=spec.check_every,
            qe_threshold=spec.qe_threshold,
            min_m=vcfg.min_m,
            fixed_m=(vcfg.fixed_m if vcfg.fixed_m is not None
                     else ss.fixed_m))


class SingleVariant:
    """The paper's sequential baseline: one chunk of signals per tick, each
    signal a step at m = 1 (``core.gson.single``). Not fleet-capable, as
    in the JAX package: it runs as a ``Session``."""

    name = "single"
    config_cls = SingleConfig
    fleet_capable = False
    fleet_mode = "scan"

    def fleet_cfg(self, spec, params, vcfg) -> SuperstepConfig:
        """The chunk is the loop's ``max_parallel``; ``refresh_every``
        counts signals within a chunk."""
        return SuperstepConfig(
            length=1, max_parallel=vcfg.chunk,
            refresh_every=vcfg.refresh_every,
            check_every=spec.check_every, qe_threshold=spec.qe_threshold)

    def scan(self, params, cfg, vcfg, find_winners):
        """The chunk: the step at m = 1 with the backend's Find Winners
        and the reference Update phase, as in the JAX package."""
        return functools.partial(single_signal_scan, params=params,
                                 refresh_every=cfg.refresh_every,
                                 find_winners=find_winners)


class IndexedVariant(SingleVariant):
    """The paper's Indexed baseline on the ``repro_torch.ann`` grid: the
    hash-grid quantizer in its exhaustive-fallback discipline, built from
    the config (the run's backend is not used, as in the JAX package),
    with the aux rebuilt every ``rebuild_every`` signals of a chunk
    (``ann.indexed_scan``). A ``Session`` only."""

    name = "indexed"
    config_cls = IndexedConfig

    def scan(self, params, cfg, vcfg, find_winners):
        fw = indexed_find_winners(vcfg.grid_per_axis, vcfg.per_cell_cap,
                                  vcfg.bbox)
        return functools.partial(indexed_scan, params=params, fw=fw,
                                 rebuild_every=vcfg.rebuild_every,
                                 refresh_every=vcfg.refresh_every)


# stateless singletons: one instance per registered name
VARIANTS.register("single", SingleVariant())
VARIANTS.register("indexed", IndexedVariant())
VARIANTS.register("multi", MultiVariant())
VARIANTS.register("multi-fused", FusedVariant())
