"""The fused loop: up to ``length`` multi-signal iterations per call.

The PyTorch counterpart of ``repro.core.gson.superstep`` and of the
fleet core's superstep at one network (``repro.core.gson.fleet``). The
loop is a Python loop, but it keeps the host out of the way of the
device: the signal buffer has a static ``max_parallel`` rows and the
paper's m-schedule is computed on the device as a mask over its first
``m_t = next_pow2(n_active)`` rows, so an iteration reads nothing back.
The host reads the convergence flag only on check iterations, which it
knows from its own iteration counter.

Order within an iteration (that of ``fleet.py``): draw the full signal
buffer and the lock priorities, run the masked step, refresh the SOAM
ladder when the counter *before* the increment is a multiple of
``refresh_every``, then check convergence when the counter *after* it is
a multiple of ``check_every``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.gson import metrics
from repro_torch.core.gson.multi import (FindWinnersFn, UpdatePhaseFn,
                                         multi_signal_step,
                                         refresh_topology, soam_converged)
from repro_torch.core.gson.state import GSONParams, NetworkState

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


class SuperstepResult(NamedTuple):
    state: NetworkState
    iterations: int         # iterations actually executed
    converged: bool
    qe: float               # last checked QE (nan if never checked)


def device_m_schedule(n_active: torch.Tensor,
                      cfg: SuperstepConfig) -> torch.Tensor:
    """The paper's m-schedule, on the device: smallest power of two
    greater than ``n_active``, clipped to [min_m, max_parallel]."""
    cap = cfg.max_parallel
    dev = n_active.device
    if cfg.fixed_m is not None:
        return torch.full((), min(cfg.fixed_m, cap), dtype=torch.int32,
                          device=dev)
    pows = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=dev),
        torch.arange(max(cap.bit_length(), 1), dtype=torch.int32,
                     device=dev))
    above = torch.where(pows > n_active, pows, _NO_POW)
    m = above.min().clamp(max=cap)
    return m.clamp(min=min(cfg.min_m, cap))


def iterate(state: NetworkState, signals: torch.Tensor, prio: torch.Tensor,
            it: int, *, params: GSONParams, cfg: SuperstepConfig,
            find_winners: FindWinnersFn | None = None,
            update_phase: UpdatePhaseFn | None = None) -> NetworkState:
    """One fused iteration: masked multi-signal step over the whole
    ``(max_parallel, dim)`` buffer, then the cadenced SOAM refresh.
    ``it`` is the global iteration counter before this iteration."""
    m_t = device_m_schedule(state.n_active, cfg)
    mask = torch.arange(cfg.max_parallel, device=signals.device) < m_t
    state = multi_signal_step(
        state, signals, params, prio, refresh_states=False,
        find_winners=find_winners, signal_mask=mask,
        update_phase=update_phase)
    if params.model == "soam" and it % cfg.refresh_every == 0:
        state = refresh_topology(state, params)
    return state


def convergence_check(state: NetworkState, probes: torch.Tensor, *,
                      params: GSONParams, qe_threshold: float):
    """(state, done, qe) as device scalars — SOAM topology criterion (on
    a fresh state ladder, which the state keeps) or quantization error
    (GNG, GWR)."""
    if params.model == "soam":
        state = refresh_topology(state, params)
        return (state, soam_converged(state),
                metrics.quantization_error(state, probes))
    done, qe = metrics.qe_convergence(state, probes, qe_threshold)
    return state, done, qe


def run_superstep(state: NetworkState, draws, probes: torch.Tensor,
                  it0: int, *, params: GSONParams, cfg: SuperstepConfig,
                  max_steps: int | None = None,
                  find_winners: FindWinnersFn | None = None,
                  update_phase: UpdatePhaseFn | None = None
                  ) -> SuperstepResult:
    """Up to ``min(cfg.length, max_steps)`` fused iterations.

    ``draws`` is the run's RNG seam (``repro_torch.rng``); ``probes`` the
    probe set of the convergence predicate; ``it0`` the global iteration
    counter at entry, which keeps the cadences continuous across calls.
    The loop stops at the first satisfied check (the JAX package's
    fixed-length form freezes the state there, to the same result).
    """
    if cfg.max_parallel is None:
        raise ValueError("SuperstepConfig.max_parallel unresolved — call "
                         "cfg.resolve(capacity, params) first")
    length = cfg.length if max_steps is None else min(cfg.length, max_steps)
    steps, done, qe = 0, False, float("nan")
    while steps < length and not done:
        signals = draws.signals(cfg.max_parallel)
        prio = draws.lock_priorities(cfg.max_parallel)
        state = iterate(state, signals, prio, it0 + steps, params=params,
                        cfg=cfg, find_winners=find_winners,
                        update_phase=update_phase)
        steps += 1
        if (it0 + steps) % cfg.check_every == 0:
            state, d, q = convergence_check(
                state, probes, params=params, qe_threshold=cfg.qe_threshold)
            done, qe = bool(d), float(q)
    return SuperstepResult(state, steps, done, qe)
