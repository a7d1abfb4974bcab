"""Quality / faithfulness metrics for reconstructed networks.

``quantization_error`` and ``qe_convergence`` work on tensors, per
network of a fleet (or on one network); ``edge_count`` and ``summary`` on
one network. The Euler characteristic and the topology
gate are host-side (numpy) reporting utilities, as in
``repro.core.gson.metrics``: for a converged SOAM triangulation V - E + F
must equal 2 - 2*genus of the sampled surface.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.gson.batch import batchable
from repro_torch.core.gson.state import STATE_NAMES, NetworkState


@batchable(3)
def quantization_error(state: NetworkState,
                       probes: torch.Tensor) -> torch.Tensor:
    """Mean squared distance from probe signals to their winner, per
    network: probes (B, P, d) -> (B,)."""
    x2 = (probes * probes).sum(dim=-1, keepdim=True)
    w2 = (state.w * state.w).sum(dim=-1)
    d2 = (x2 - torch.bmm(2.0 * probes, state.w.transpose(1, 2))
          + w2[:, None, :])
    d2 = torch.where(state.active[:, None, :], d2, torch.inf)
    return d2.min(dim=-1).values.clamp(min=0.0).mean(dim=-1)


@batchable(3)
def qe_convergence(state: NetworkState, probes: torch.Tensor,
                   threshold: float):
    """GNG/GWR termination predicate: (done, qe), both (B,) on the
    device."""
    qe = quantization_error(state, probes)
    done = (qe < threshold) & (state.n_active > 8)
    return done, qe


def edge_count(state: NetworkState) -> int:
    return int((state.nbr >= 0).sum()) // 2


def state_histogram(state: NetworkState) -> dict:
    st = state.topo_state.cpu().numpy()
    act = state.active.cpu().numpy()
    return {name: int(np.sum(act & (st == i)))
            for i, name in enumerate(STATE_NAMES)}


def euler_characteristic(state: NetworkState) -> tuple[int, int, int, int]:
    """(V, E, F, chi) from the neighbor lists; F = 3-cliques."""
    nbr = state.nbr.cpu().numpy()
    active = state.active.cpu().numpy()
    ids = np.nonzero(active)[0]
    v = len(ids)
    adj = {int(i): set(int(j) for j in nbr[i] if j >= 0) for i in ids}
    e = sum(len(s) for s in adj.values()) // 2
    f = 0
    for a, nb in adj.items():
        for b in nb:
            if b <= a:
                continue
            f += len([c for c in (adj[a] & adj[b]) if c > b])
    return v, e, f, v - e + f


class TopologyQuality(NamedTuple):
    """Verdict of :func:`topology_quality` (all host-side scalars)."""

    chi: int              # Euler characteristic of the candidate
    exact_chi: int        # Euler characteristic of the exact run
    chi_match: bool
    qe: float             # candidate quantization error (nan: no probes)
    exact_qe: float
    qe_rel: float         # (qe - exact_qe) / exact_qe, signed
    qe_ok: bool
    ok: bool              # chi_match and qe_ok


def topology_quality(state: NetworkState, exact_state: NetworkState,
                     probes=None, qe_tol: float = 0.05) -> TopologyQuality:
    """Quality-not-bitwise acceptance gate: equal Euler characteristic
    and quantization error within ``qe_tol`` of the exact run's
    (one-sided). ``probes=None`` skips the QE clause (chi only)."""
    _, _, _, chi = euler_characteristic(state)
    _, _, _, exact_chi = euler_characteristic(exact_state)
    chi_match = chi == exact_chi
    if probes is None:
        return TopologyQuality(chi, exact_chi, chi_match,
                               float("nan"), float("nan"), float("nan"),
                               True, chi_match)
    qe = float(quantization_error(state, probes))
    exact_qe = float(quantization_error(exact_state, probes))
    qe_rel = (qe - exact_qe) / max(exact_qe, 1e-30)
    qe_ok = qe <= exact_qe * (1.0 + qe_tol)
    return TopologyQuality(chi, exact_chi, chi_match, qe, exact_qe,
                           qe_rel, qe_ok, chi_match and qe_ok)


def summary(state: NetworkState) -> dict:
    return {
        "units": int(state.n_active),
        "edges": edge_count(state),
        "signals": int(state.signal_count),
        "discarded": int(state.discarded),
        "dropped_edges": int(state.dropped_edges),
        "dropped_units": int(state.dropped_units),
        "states": state_histogram(state),
    }
