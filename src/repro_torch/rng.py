"""The one RNG seam of the port.

Every random draw of a run goes through one object with four methods:

  seed_points(n)      the initial units, (n, dim) f32
  probes(n)           the fixed probe set of the convergence check
  signals(n)          one signal buffer, (n, dim) f32; one call per iteration
  lock_priorities(m)  the winner lock's priorities: a permutation of
                      range(m) as int32, one call per step

PyTorch cannot reproduce JAX's threefry draws, so the JAX package's key
schedule (a sampling, init, probe and seed key split off the run's key;
a lock key split off the state's key at every step) lives behind this
interface. ``TorchDraws`` is the default, drawing on the run's device.
A test can hand a session any object with these four methods — for
example one that replays the JAX package's draws — and get the same run.

Two more methods make a run restartable: ``state_dict()`` returns the
seam's position as a dict of tensors (or numpy arrays), and
``load_state_dict(d)`` puts it back, so a restored session draws the rows
the original would have drawn next. A fleet gives each network a seam of
its own.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch


class Draws(Protocol):
    def seed_points(self, n: int) -> torch.Tensor: ...

    def probes(self, n: int) -> torch.Tensor: ...

    def signals(self, n: int) -> torch.Tensor: ...

    def lock_priorities(self, m: int) -> torch.Tensor: ...

    def state_dict(self) -> dict: ...

    def load_state_dict(self, d: dict) -> None: ...


_STREAMS = ("signals", "probes", "seed_points", "lock")


class TorchDraws:
    """Draws from ``torch.Generator``s on ``device``, all seeded from
    ``seed``: one stream each for signals, probes, seed points and lock
    priorities, so a session that pauses and resumes draws the same
    signals as one that does not. ``sampler(gen, n)`` is the surface."""

    def __init__(self, seed: int, device, sampler):
        self.device = torch.device(device)
        self.sampler = sampler
        seeds = np.random.SeedSequence(seed).generate_state(4, np.uint32)
        self._sig, self._probe, self._seed, self._lock = (
            torch.Generator(device=self.device).manual_seed(int(s))
            for s in seeds)

    def seed_points(self, n: int) -> torch.Tensor:
        return self.sampler(self._seed, n)

    def probes(self, n: int) -> torch.Tensor:
        return self.sampler(self._probe, n)

    def signals(self, n: int) -> torch.Tensor:
        return self.sampler(self._sig, n)

    def lock_priorities(self, m: int) -> torch.Tensor:
        return torch.randperm(m, generator=self._lock, device=self.device,
                              dtype=torch.int32)

    def _generators(self):
        return dict(zip(_STREAMS, (self._sig, self._probe, self._seed,
                                   self._lock)))

    def state_dict(self) -> dict:
        """Each generator's state (``get_state()``: a CPU byte tensor, for
        a CUDA generator too)."""
        return {k: g.get_state() for k, g in self._generators().items()}

    def load_state_dict(self, d: dict) -> None:
        for k, g in self._generators().items():
            g.set_state(d[k].to("cpu", torch.uint8))
