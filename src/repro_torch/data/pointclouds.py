"""Point-cloud input pipeline for the GSON engine.

The port's ``repro.data.pointclouds``: the benchmark surface samplers
with the paper's Sample-phase semantics (uniform P(xi) over the region of
interest), optional additive observation noise, and deterministic resume
(the signals of iteration i are a pure function of (seed, i)).

PyTorch has no ``jax.random.fold_in``. :meth:`PointCloudStream.signals`
seeds a fresh ``torch.Generator`` from ``np.random.SeedSequence([seed,
iteration])`` instead, so its points differ from the JAX stream's while
keeping its contract. Inside a run the stream acts through
:meth:`PointCloudStream.as_sampler`, and the run's RNG seam
(``repro_torch.rng``) owns the generator.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.gson import sampling


@dataclass(frozen=True)
class NoisySampler:
    """Hashable ``(gen, n) -> points`` sampler with additive Gaussian
    observation noise, drawn from the same generator after the points.
    Equal (surface, noise) pairs compare and hash equal, so runs that use
    them group into one cohort."""

    base: sampling.SurfaceSampler
    noise: float

    def __call__(self, gen: torch.Generator, n: int) -> torch.Tensor:
        pts = self.base(gen, n)
        return pts + self.noise * torch.randn(pts.shape, generator=gen,
                                              device=gen.device)


@dataclass
class PointCloudStream:
    """Signals of a surface, with optional noise, by (seed, iteration).

    ``device``: where :meth:`signals` draws (the card unless the caller
    asks for the CPU).
    """

    surface: str
    seed: int = 0
    noise: float = 0.0
    device: str = "cuda"

    def __post_init__(self):
        self._sampler = sampling.make_sampler(self.surface)

    def signals(self, iteration: int, m: int) -> torch.Tensor:
        """(m, 3) f32 points for ``iteration``: a generator seeded from
        ``SeedSequence([seed, iteration])`` draws the points, then the
        noise."""
        state = np.random.SeedSequence([self.seed, iteration]).generate_state(
            1, np.uint32)
        gen = torch.Generator(device=self.device).manual_seed(int(state[0]))
        return self.as_sampler()(gen, m)

    def as_sampler(self):
        """The engine's ``(gen, n)`` sampler, noise included.

        The stream's ``seed`` does not carry over: in the session API the
        run's RNG seam owns the generator, so determinism comes from the
        session's seed, not the stream's.
        """
        if self.noise > 0.0:
            return NoisySampler(self._sampler, self.noise)
        return self._sampler
