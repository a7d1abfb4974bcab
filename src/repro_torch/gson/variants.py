"""Variant strategies: the pluggable parallelization axis.

The paper's contribution is a *variant* of the growing-network loop —
same rule set, different execution schedule (Sec. 2.2: the multi-signal
iteration). A strategy is a stateless singleton registered in
``VARIANTS`` with a typed config dataclass (``config_cls``) and the two
things the one run driver (``repro_torch.gson.fleet.Cohort.tick``) asks
of it:

  fleet_mode                  — "host": one iteration per tick, the
                                paper's multi-signal loop; "device": whole
                                fused supersteps per tick
  fleet_cfg(spec, params, vcfg) — the loop config (``SuperstepConfig``)

Sessions and fleets both run through that driver, so ``fleet_capable =
True`` marks a strategy that provides them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from repro_torch.core.gson.state import GSONParams
from repro_torch.core.gson.superstep import SuperstepConfig, next_pow2
from repro_torch.gson.registry import VARIANTS


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


@dataclass
class Runtime:
    """Resolved per-run context: the spec's axes as concrete objects."""

    spec: Any                     # the RunSpec
    params: GSONParams
    vcfg: Any                     # the variant's typed config
    sampler: Any                  # f(gen, n) -> (n, dim) f32
    find_winners: Any             # FindWinnersFn | None
    update_phase: Any = None      # UpdatePhaseFn | None


@runtime_checkable
class VariantStrategy(Protocol):
    name: str
    config_cls: type


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


# stateless singletons: one instance per registered name
VARIANTS.register("multi", MultiVariant())
VARIANTS.register("multi-fused", FusedVariant())
