"""Legacy engine entry point: a thin shim over :mod:`repro_torch.gson`.

The port's counterpart of ``repro.core.gson.engine``. The flat
``EngineConfig`` maps onto a ``RunSpec`` with a typed per-variant config
(``MultiConfig``, ``FusedConfig``, ``SingleConfig`` or ``IndexedConfig``),
and
``GSONEngine(cfg, sampler).run(seed)`` returns what
``gson.run(cfg.to_spec(sampler), seed=seed)`` returns. New code should
build a ``repro_torch.gson.RunSpec``; the shim keeps older callers
running and grows no features.

Differences from the JAX shim: ``run`` takes an integer seed where the
JAX one takes a PRNG key (the port's draws go through
``repro_torch.rng``); ``device`` says where the run goes (the card
unless the caller asks for the CPU). The grid frame of
``variant="indexed"`` is ``GSONEngine``'s ``bbox`` argument, as in the
JAX shim.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

from repro_torch.core.gson.state import GSONParams
from repro_torch.core.gson.superstep import SuperstepConfig
from repro_torch.gson.session import RunStats, Session  # noqa: F401
from repro_torch.gson.spec import RunSpec
from repro_torch.gson.variants import (DEFAULT_BBOX, FusedConfig,
                                       IndexedConfig, MultiConfig,
                                       SingleConfig)


@dataclass
class EngineConfig:
    """Flat legacy config, mapped onto a ``RunSpec`` and a typed
    per-variant config by :meth:`to_spec`."""

    params: GSONParams = field(default_factory=GSONParams)
    capacity: int = 4096
    max_deg: int = 16
    dim: int = 3
    variant: str = "multi"        # any name in repro_torch.gson.VARIANTS
    superstep: SuperstepConfig = field(
        default_factory=SuperstepConfig)  # multi-fused only
    fixed_m: int | None = None    # override the paper's m-schedule
    chunk: int = 256              # signals per tick of single / indexed
    check_every: int = 10         # iterations between convergence checks
    refresh_every: int = 5        # multi-signal topo refresh cadence (iters)
    single_refresh_every: int = 200   # per-signal cadence inside a chunk
    max_iterations: int = 100_000
    max_signals: int = 50_000_000
    qe_threshold: float = 1e-3    # GNG/GWR convergence
    n_probe: int = 2048
    min_m: int = 4
    # indexed variant (paper Sec. 3.1 hash grid)
    grid_per_axis: int = 24
    per_cell_cap: int = 24
    index_rebuild_every: int = 64

    def variant_config(self, bbox=None):
        """The typed per-variant config equivalent to this flat one;
        ``bbox`` is the indexed variant's grid frame (``None``: its
        default)."""
        if self.variant == "multi":
            return MultiConfig(fixed_m=self.fixed_m, min_m=self.min_m,
                               refresh_every=self.refresh_every)
        if self.variant == "multi-fused":
            return FusedConfig(superstep=self.superstep,
                               fixed_m=self.fixed_m, min_m=self.min_m,
                               refresh_every=self.refresh_every)
        if self.variant == "single":
            return SingleConfig(chunk=self.chunk,
                                refresh_every=self.single_refresh_every)
        if self.variant == "indexed":
            return IndexedConfig(chunk=self.chunk,
                                 refresh_every=self.single_refresh_every,
                                 grid_per_axis=self.grid_per_axis,
                                 per_cell_cap=self.per_cell_cap,
                                 rebuild_every=self.index_rebuild_every,
                                 bbox=DEFAULT_BBOX if bbox is None else bbox)
        return None   # custom registered variant: use its defaults

    def to_spec(self, sampler, find_winners=None,
                device: str = "cuda", bbox=None) -> RunSpec:
        """The ``RunSpec`` of this config; ``find_winners`` is a backend
        name or ``Backend`` (``None``: ``"reference"``, as the legacy
        engine's plain search)."""
        return RunSpec(
            variant=self.variant,
            model=self.params,
            sampler=sampler,
            backend="reference" if find_winners is None else find_winners,
            variant_config=self.variant_config(bbox),
            capacity=self.capacity,
            dim=self.dim,
            max_deg=self.max_deg,
            max_iterations=self.max_iterations,
            max_signals=self.max_signals,
            check_every=self.check_every,
            qe_threshold=self.qe_threshold,
            n_probe=self.n_probe,
            device=device,
        )


class GSONEngine:
    """Deprecated: use ``repro_torch.gson.run`` / ``gson.Session``."""

    def __init__(self, config: EngineConfig, sampler, find_winners=None,
                 device: str = "cuda", bbox=DEFAULT_BBOX):
        warnings.warn(
            "GSONEngine is a legacy shim; build a repro_torch.gson.RunSpec "
            "and use repro_torch.gson.run / repro_torch.gson.Session "
            "instead", DeprecationWarning, stacklevel=2)
        self.cfg = config
        self.sampler = sampler
        self.find_winners = find_winners
        self.bbox = (tuple(float(x) for x in bbox[0]),
                     tuple(float(x) for x in bbox[1]))
        self.spec = config.to_spec(sampler, find_winners, device, self.bbox)

    def run(self, seed: int = 0, verbose: bool = False):
        """Run to termination from ``seed``: ``(state, stats)``. ``verbose``
        prints each history row."""
        session = Session(self.spec, seed=seed)
        for row in session.stream():
            if verbose:
                print(f"  it={row['iteration']:6d} units={row['units']:6d} "
                      f"signals={row['signals']:9d} qe={row['qe']:.5f}")
        return session.result()
