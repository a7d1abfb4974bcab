"""State carried across between the JAX package and the port.

Both packages name the fields of ``NetworkState`` alike, so a state moves
between them as a dict of numpy arrays keyed by those names (the JAX
state's PRNG key is not a field here: see ``repro_torch.rng``). The
tests use this to run both packages from the same state. A fleet moves
the same way, every array with a leading batch axis, plus its run carry
(``iteration``, ``converged``, ``qe``); the JAX fleet's sampling keys stay
behind, as the port gives each network its own RNG seam.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gson.fleet import FleetState
from repro_torch.core.gson.state import FIELDS, GSONParams, NetworkState

_DTYPES = {
    "w": torch.float32, "active": torch.bool, "nbr": torch.int32,
    "age": torch.float32, "error": torch.float32, "firing": torch.float32,
    "threshold": torch.float32, "topo_state": torch.int32,
    "inconsistent_for": torch.int32,
}


def state_from_numpy(arrays: dict, device="cpu") -> NetworkState:
    """A ``NetworkState`` on ``device`` from arrays keyed by field name
    (scalar counters are 0-d int32; with a leading batch axis, a fleet's
    stacked state)."""
    return NetworkState(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=_DTYPES.get(name, torch.int32),
                           device=device)
        for name in FIELDS})


def state_to_numpy(state: NetworkState) -> dict:
    """Field name -> numpy array, on the host."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in FIELDS}


def fleet_from_numpy(arrays: dict, device="cpu") -> FleetState:
    """A ``FleetState`` from arrays keyed by field name, each with a
    leading batch axis (B,), plus ``iteration``, ``converged`` and
    ``qe`` — e.g. a JAX ``FleetState``'s ``nets`` fields and carry."""
    return FleetState(
        nets=state_from_numpy(arrays, device),
        iteration=np.asarray(arrays["iteration"]).astype(np.int64),
        converged=np.asarray(arrays["converged"]).astype(bool),
        qe=np.asarray(arrays["qe"]).astype(np.float32))


def fleet_to_numpy(fstate: FleetState) -> dict:
    """Field name -> numpy array with a leading batch axis, plus the run
    carry."""
    return {**state_to_numpy(fstate.nets), "iteration": fstate.iteration,
            "converged": fstate.converged, "qe": fstate.qe}


def params_from_fields(fields: dict) -> GSONParams:
    """``GSONParams`` from a dict of its fields (e.g. the JAX params'
    ``dataclasses.asdict``); unknown keys raise."""
    known = {f.name for f in dataclasses.fields(GSONParams)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown GSONParams fields: {sorted(unknown)}")
    return GSONParams(**fields)
