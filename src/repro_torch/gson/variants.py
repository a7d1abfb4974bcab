"""Variant strategies: the pluggable parallelization axis.

The paper's contribution is a *variant* of the growing-network loop —
same rule set, different execution schedule (Sec. 2.2: the multi-signal
iteration). Each variant is a strategy object with three hooks:

  prepare(rt)                 — resolve derived config once per run
  step(rt, state, it, n)      — advance up to ``n`` iterations; returns a
                                StepResult
  convergence(rt, state)      — the termination predicate

and a typed config dataclass (``config_cls``). Strategies are stateless
singletons registered in ``VARIANTS``; per-run state lives in the
:class:`Runtime` the session owns, the run's RNG seam included
(``rt.draws``, see ``repro_torch.rng``).

In the JAX package both multi-signal variants step through the fleet
core at B=1; here they step one network directly, in the fleet core's
order (see ``repro_torch.core.gson.superstep``).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.gson import superstep
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
    """Resolved per-run context the session hands to its strategy."""

    spec: Any                     # the RunSpec
    params: GSONParams
    vcfg: Any                     # the variant's typed config
    sampler: Any                  # f(gen, n) -> (n, dim) f32
    find_winners: Any             # FindWinnersFn | None
    update_phase: Any = None      # UpdatePhaseFn | None
    draws: Any = None             # the run's RNG seam
    probes: torch.Tensor | None = None
    cfg: SuperstepConfig | None = None   # the loop config, from prepare

    @property
    def check_every(self) -> int:
        return self.spec.check_every

    @property
    def qe_threshold(self) -> float:
        return self.spec.qe_threshold


@dataclass
class StepResult:
    """Outcome of one strategy step (1 iteration, or a fused superstep)."""

    state: Any
    iterations: int               # iterations actually executed
    checked: bool                 # convergence predicate evaluated?
    done: bool
    qe: float
    seconds: float                # host wall time of the step


@runtime_checkable
class VariantStrategy(Protocol):
    name: str
    config_cls: type

    def prepare(self, rt: Runtime) -> None: ...

    def step(self, rt: Runtime, state, it: int,
             max_iters: int) -> StepResult: ...

    def convergence(self, rt: Runtime, state) -> tuple[bool, float, Any]: ...


def check_convergence(rt: Runtime, state):
    """The termination predicate on the host: SOAM's criterion on a fresh
    state ladder, or quantization error against the probe set (GNG,
    GWR). Returns ``(done, qe, state)``."""
    state, done, qe = superstep.convergence_check(
        state, rt.probes, params=rt.params, qe_threshold=rt.qe_threshold)
    return bool(done), float(qe), state


class _LoopBacked:
    """Shared base: the loop config comes from ``loop_cfg``."""

    def loop_cfg(self, spec, params: GSONParams, vcfg) -> SuperstepConfig:
        raise NotImplementedError

    def prepare(self, rt: Runtime) -> None:
        rt.cfg = self.loop_cfg(rt.spec, rt.params, rt.vcfg)

    def convergence(self, rt: Runtime, state):
        return check_convergence(rt, state)


class MultiVariant(_LoopBacked):
    """Host-dispatched multi-signal loop: one iteration per step.

    The signal buffer has ``max_parallel`` rows and the device
    m-schedule masks in the first ``m_t = next_pow2(n_active)`` of them —
    the same iteration the fused loop runs, one at a time.
    """

    name = "multi"
    config_cls = MultiConfig

    def loop_cfg(self, spec, params, vcfg) -> SuperstepConfig:
        if vcfg.fixed_m is not None:
            buf = min(params.max_parallel, vcfg.fixed_m)
        else:
            buf = min(params.max_parallel, next_pow2(spec.capacity))
        return SuperstepConfig(
            length=1, max_parallel=buf, min_m=vcfg.min_m,
            fixed_m=vcfg.fixed_m, refresh_every=vcfg.refresh_every,
            check_every=spec.check_every,
            qe_threshold=spec.qe_threshold)

    def step(self, rt: Runtime, state, it: int,
             max_iters: int) -> StepResult:
        t0 = time.perf_counter()
        res = superstep.run_superstep(
            state, rt.draws, rt.probes, it, params=rt.params, cfg=rt.cfg,
            max_steps=1, find_winners=rt.find_winners,
            update_phase=rt.update_phase)
        return StepResult(res.state, 1, (it + 1) % rt.check_every == 0,
                          res.converged, res.qe, time.perf_counter() - t0)


class FusedVariant(_LoopBacked):
    """Whole iterate-sample-converge supersteps per step."""

    name = "multi-fused"
    config_cls = FusedConfig

    def loop_cfg(self, spec, params, vcfg) -> SuperstepConfig:
        ss = vcfg.superstep.resolve(spec.capacity, params)
        return dataclasses.replace(
            ss,
            refresh_every=vcfg.refresh_every,
            check_every=spec.check_every,
            qe_threshold=spec.qe_threshold,
            min_m=vcfg.min_m,
            fixed_m=(vcfg.fixed_m if vcfg.fixed_m is not None
                     else ss.fixed_m))

    def step(self, rt: Runtime, state, it: int,
             max_iters: int) -> StepResult:
        ss = rt.cfg
        # bound by BOTH remaining budgets: iterations, and signals (worst
        # case one iteration consumes max_parallel signals)
        sig_left = rt.spec.max_signals - int(state.signal_count)
        length = max(1, min(ss.length, max_iters,
                            -(-sig_left // ss.max_parallel)))
        t0 = time.perf_counter()
        res = superstep.run_superstep(
            state, rt.draws, rt.probes, it, params=rt.params, cfg=ss,
            max_steps=length, find_winners=rt.find_winners,
            update_phase=rt.update_phase)
        return StepResult(res.state, res.iterations, True, res.converged,
                          res.qe, time.perf_counter() - t0)


# stateless singletons: one instance per registered name
VARIANTS.register("multi", MultiVariant())
VARIANTS.register("multi-fused", FusedVariant())
