"""The benchmark's inputs: seed points, probes, signals and lock priorities.

One job is a fleet of B fresh networks. ``JobInputs`` draws every input
of the job on the device, for all B networks at once, from generators
seeded by (``--seed``, job, stream, iteration): one call makes iteration
k's signals of every network, and network i reads row i. The same seed
gives the same inputs, whatever runs them.

The port takes its randomness through one seam (``repro_torch.rng.Draws``:
``seed_points``, ``probes``, ``signals``, ``lock_priorities``,
``state_dict``, ``load_state_dict``); ``JobInputs.draws()`` gives one
such object per network, which the harness passes as
``FleetSession(draws=...)``. Each network counts its own calls, so a
network that stops early (converged, quarantined) reads the rows of its
own iterations when it runs again.

``on_iteration(k)`` is called once, when the first network asks for
iteration k's signals: at that moment every running network of the job
holds its state from before iteration k. The correctness check uses it
to copy the states it will judge.

The surfaces are those of the port's ``core/gson/sampling.py`` (same
formulas, drawn in bulk here): ``sphere`` (genus 0) for the cells of
today, ``torus`` and the genus-2 ``eight`` for cells that a traffic file
alone can add.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SURFACES = ("sphere", "torus", "eight")
STREAMS = {"seed_points": 1, "probes": 2, "signals": 3, "priorities": 4}
_TWO_PI = 2 * math.pi


def stream_seed(seed: int, job: int, stream: str, k: int = 0) -> int:
    """A 63-bit generator seed from (seed, job, stream, iteration)."""
    words = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, int(job) + 1, STREAMS[stream],
         int(k)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


# --- surfaces: sampler(gen, n) -> (n, 3) f32 on gen.device ----------------

def _uniform(gen, n, hi=1.0):
    return torch.rand((n,), generator=gen, device=gen.device) * hi


def sphere(gen, n):
    v = torch.randn((n, 3), generator=gen, device=gen.device)
    return v / torch.linalg.norm(v, dim=1, keepdim=True)


def torus(gen, n, big_r=1.0, small_r=0.35):
    """Uniform-area torus: rejection on the minor angle, 4x oversampled,
    accepted values first (a shortfall reuses the first accepted)."""
    theta = _uniform(gen, n, _TWO_PI)
    phi = _uniform(gen, 4 * n, _TWO_PI)
    u = _uniform(gen, 4 * n)
    accept = u < (big_r + small_r * torch.cos(phi)) / (big_r + small_r)
    phi = phi[torch.argsort((~accept).to(torch.int32), stable=True)[:n]]
    ring = big_r + small_r * torch.cos(phi)
    return torch.stack([ring * torch.cos(theta), ring * torch.sin(theta),
                        small_r * torch.sin(phi)], dim=1)


_EIGHT_C, _EIGHT_R, _EIGHT_r, _EIGHT_EPS = 0.65, 0.55, 0.22, 0.02


def _torus_f_grad(p, cx):
    dx = p[:, 0] - cx
    rho = torch.sqrt(dx * dx + p[:, 1] ** 2)
    q = rho - _EIGHT_R
    f = q ** 2 + p[:, 2] ** 2 - _EIGHT_r ** 2
    k = 2.0 * q / rho.clamp(min=1e-12)
    return f, torch.stack([k * dx, k * p[:, 1], 2.0 * p[:, 2]], dim=1)


def eight(gen, n):
    """Genus 2: T1(p) T2(p) = eps, two tori blended; points near both
    tori, Newton-projected onto the surface (12 steps)."""
    p = torus(gen, n, _EIGHT_R, _EIGHT_r)
    side = torch.where(_uniform(gen, n) < 0.5, 1.0, -1.0)
    p[:, 0] += side * _EIGHT_C
    for _ in range(12):
        f1, g1 = _torus_f_grad(p, -_EIGHT_C)
        f2, g2 = _torus_f_grad(p, _EIGHT_C)
        val = f1 * f2 - _EIGHT_EPS
        g = f2[:, None] * g1 + f1[:, None] * g2
        p = p - val[:, None] * g / ((g * g).sum(dim=1, keepdim=True) + 1e-12)
    return p


SAMPLERS = {"sphere": sphere, "torus": torus, "eight": eight}


class JobInputs:
    """Every input of one job of B networks, drawn on ``device``."""

    def __init__(self, *, seed: int, job: int, batch: int, surface: str,
                 device):
        if surface not in SAMPLERS:
            raise ValueError(f"unknown surface {surface!r}; {SURFACES}")
        self.seed, self.job, self.batch = int(seed), int(job), int(batch)
        self.surface = surface
        self.device = torch.device(device)
        self.on_iteration = None         # see the module's docstring
        self.seed_points = None          # (B, n_seed, d), once drawn
        self.rows = None                 # the signal buffer's rows, once seen
        self._cache: dict = {}
        self._first_seen = -1
        # iteration -> (signals (R, M, d), priorities (R, M) i32) of the
        # rows ``keep_rows`` (R of them, default all), for the iterations
        # the check asked to keep (``keep``)
        self.kept: dict = {}
        self.keep: set = set()
        self.keep_rows = None
        # which iterations each network drew (a frozen network skips)
        self.drawn = [[] for _ in range(self.batch)]

    def _points(self, stream: str, n: int, k: int = 0) -> torch.Tensor:
        gen = generator(self.device,
                        stream_seed(self.seed, self.job, stream, k))
        pts = SAMPLERS[self.surface](gen, self.batch * n)
        return pts.to(torch.float32).view(self.batch, n, -1)

    def whole(self, stream: str, n: int) -> torch.Tensor:
        """Seed points or probes of the job: (B, n, d), drawn once."""
        key = (stream, n)
        if key not in self._cache:
            self._cache[key] = self._points(stream, n)
            if stream == "seed_points":
                self.seed_points = self._cache[key]
        return self._cache[key]

    def _draw(self, k: int, n: int):
        sig = self._points("signals", n, k)
        gen = generator(self.device,
                        stream_seed(self.seed, self.job, "priorities", k))
        keys = torch.rand((self.batch, n), generator=gen,
                          device=self.device, dtype=torch.float64)
        prio = torch.argsort(keys, dim=-1, stable=True).to(torch.int32)
        return sig, prio

    def iteration(self, k: int, n: int):
        """Iteration k's signals (B, n, d) and lock priorities (B, n):
        each network's a permutation of range(n)."""
        if k > self._first_seen:
            self._first_seen = k
            if self.on_iteration is not None:
                self.on_iteration(k)
        key = ("it", k, n)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        self.rows = n
        hit = self._cache[key] = self._draw(k, n)
        # hold this iteration and the one before it: a network frozen
        # for a while redraws its rows, the same rows
        for old in [x for x in self._cache if x[0] == "it"
                    and x[1] < k - 1]:
            del self._cache[old]
        if k in self.keep:
            self.kept[k] = hit if self.keep_rows is None else tuple(
                t.index_select(0, self.keep_rows) for t in hit)
        return hit

    def prefetch(self, ks) -> None:
        """Draw iterations ``ks`` now, at the buffer's rows seen so far,
        so that running them draws nothing on the device."""
        for k in ks:
            self._cache[("it", k, self.rows)] = self._draw(k, self.rows)

    def draws(self) -> list:
        return [NetworkDraws(self, i) for i in range(self.batch)]


class NetworkDraws:
    """Network i's view of a ``JobInputs``: the port's RNG seam."""

    def __init__(self, job: JobInputs, i: int):
        self.job, self.i = job, i
        self.k_signals = 0
        self.k_prio = 0

    def seed_points(self, n: int) -> torch.Tensor:
        return self.job.whole("seed_points", n)[self.i]

    def probes(self, n: int) -> torch.Tensor:
        return self.job.whole("probes", n)[self.i]

    def signals(self, n: int) -> torch.Tensor:
        k = self.k_signals
        self.k_signals += 1
        self.job.drawn[self.i].append(k)
        return self.job.iteration(k, n)[0][self.i]

    def lock_priorities(self, m: int) -> torch.Tensor:
        k = self.k_prio
        self.k_prio += 1
        return self.job.iteration(k, m)[1][self.i]

    def state_dict(self) -> dict:
        return {"k_signals": torch.tensor(self.k_signals),
                "k_prio": torch.tensor(self.k_prio)}

    def load_state_dict(self, d: dict) -> None:
        self.k_signals = int(d["k_signals"])
        self.k_prio = int(d["k_prio"])
