"""RunSpec: one declarative description of a GSON experiment.

The paper's experiments are points in a (variant, model, surface) grid
with shared hyper-parameters (Sec. 3.1); a RunSpec is one such point plus
the execution knobs: pool geometry, run limits, backend and device.
``resolve(spec)`` turns it into the concrete strategy + Runtime the
session drives.

Two fields differ from ``repro.gson.RunSpec``: ``device`` (the port runs
on the card unless the caller asks for the CPU) and the default backend,
``"cuda-full"``, so that a default run goes through the kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

from repro_torch.core.gson.state import GSONParams
from repro_torch.gson.registry import (VARIANTS, resolve_backend,
                                       resolve_model, resolve_sampler)
from repro_torch.gson.variants import Runtime, VariantStrategy


@dataclass(frozen=True)
class RunSpec:
    """Everything needed to reproduce one run (modulo the seed).

    Axis fields accept a registered name or a concrete object; the typed
    per-variant knobs live in ``variant_config`` (``None`` means the
    variant's defaults).
    """

    variant: str | Any = "multi"
    model: str | GSONParams = "soam"
    sampler: str | Any = "sphere"
    backend: str | Any | None = "cuda-full"
    variant_config: Any = None

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
    rt = Runtime(
        spec=spec,
        params=resolve_model(spec.model),
        vcfg=vcfg,
        sampler=resolve_sampler(spec.sampler),
        find_winners=be.find_winners,
        update_phase=be.update_phase,
    )
    return strategy, rt
