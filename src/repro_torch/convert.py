"""State carried across between the JAX package and the port.

Both packages name the fields of ``NetworkState`` alike, so a state moves
between them as a dict of numpy arrays keyed by those names (the JAX
state's PRNG key is not a field here: see ``repro_torch.rng``). The
tests use this to run both packages from the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gson.state import FIELDS, GSONParams, NetworkState

_DTYPES = {
    "w": torch.float32, "active": torch.bool, "nbr": torch.int32,
    "age": torch.float32, "error": torch.float32, "firing": torch.float32,
    "threshold": torch.float32, "topo_state": torch.int32,
    "inconsistent_for": torch.int32,
}


def state_from_numpy(arrays: dict, device="cpu") -> NetworkState:
    """A ``NetworkState`` on ``device`` from arrays keyed by field name
    (scalar counters are 0-d int32)."""
    return NetworkState(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=_DTYPES.get(name, torch.int32),
                           device=device)
        for name in FIELDS})


def state_to_numpy(state: NetworkState) -> dict:
    """Field name -> numpy array, on the host."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in FIELDS}


def params_from_fields(fields: dict) -> GSONParams:
    """``GSONParams`` from a dict of its fields (e.g. the JAX params'
    ``dataclasses.asdict``); unknown keys raise."""
    known = {f.name for f in dataclasses.fields(GSONParams)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown GSONParams fields: {sorted(unknown)}")
    return GSONParams(**fields)
