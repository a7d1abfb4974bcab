"""Configuration and m-schedule of the fused loop.

The PyTorch counterpart of ``repro.core.gson.superstep``'s config. The
loop itself, over a batch of networks with per-network budgets,
counters and freeze, is ``repro_torch.core.gson.fleet`` (as in the JAX
package, whose sessions step through its fleet core at B = 1): the signal
buffer has a static ``max_parallel`` rows and the paper's m-schedule is
computed on the device as a mask over the first ``m_t =
next_pow2(n_active)`` rows of each network, so an iteration reads
nothing back.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core.gson.state import GSONParams

_NO_POW = 1 << 30


def next_pow2(n: int) -> int:
    """Smallest power of two strictly greater than n (host-side)."""
    return 1 << max(int(n), 1).bit_length()


@dataclass(frozen=True)
class SuperstepConfig:
    """Configuration of the fused loop.

    ``max_parallel`` is the row count of the signal buffer; ``None``
    means "derive from capacity" via :meth:`resolve`.
    """

    length: int = 64              # iterations per call
    max_parallel: int | None = None   # signal buffer rows
    min_m: int = 4                # floor of the m-schedule
    fixed_m: int | None = None    # override the paper's m-schedule
    refresh_every: int = 5        # SOAM topo refresh cadence (iterations)
    check_every: int = 10         # convergence-check cadence (iterations)
    qe_threshold: float = 1e-3    # GNG/GWR convergence

    def __post_init__(self):
        if self.length < 1:
            raise ValueError(
                f"superstep length must be >= 1, got {self.length} "
                "(a zero-length superstep makes no progress)")

    def resolve(self, capacity: int, params: GSONParams) -> "SuperstepConfig":
        """Fill the derived buffer size: the m-schedule never exceeds
        ``next_pow2(capacity)`` nor the paper's ``max_parallel`` cap."""
        if self.max_parallel is not None:
            return self
        return dataclasses.replace(
            self,
            max_parallel=min(params.max_parallel, next_pow2(capacity)))


def device_m_schedule(n_active: torch.Tensor,
                      cfg: SuperstepConfig) -> torch.Tensor:
    """The paper's m-schedule per network, on the device: smallest power
    of two greater than ``n_active`` (B,), clipped to [min_m,
    max_parallel]. Returns (B,) int32."""
    cap = cfg.max_parallel
    dev = n_active.device
    if cfg.fixed_m is not None:
        return torch.full(n_active.shape, min(cfg.fixed_m, cap),
                          dtype=torch.int32, device=dev)
    pows = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=dev),
        torch.arange(max(cap.bit_length(), 1), dtype=torch.int32,
                     device=dev))
    above = torch.where(pows > n_active[..., None], pows, _NO_POW)
    m = above.min(dim=-1).values.clamp(max=cap)
    return m.clamp(min=min(cfg.min_m, cap))
