"""State carried across between the JAX package and the port.

Both packages name the fields of ``NetworkState`` alike, so a state moves
between them as a dict of numpy arrays keyed by those names (the JAX
state's PRNG key is not a field here: see ``repro_torch.rng``). The
tests use this to run both packages from the same state. A fleet moves
the same way, every array with a leading batch axis, plus its run carry
(``iteration``, ``converged``, ``qe``); the JAX fleet's sampling keys stay
behind, as the port gives each network its own RNG seam. The hash
grid of ``repro.ann`` (``GridAux``) comes across as its four arrays plus
its static ``dims``. An LM's parameters come across as a dict of numpy
arrays under the JAX parameter names (``layers/wq``, ...), and its
optimizer state as JAX's dict of such dicts (``m``/``v`` or ``vr``/``vc``)
plus the ``step`` counter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ann.grid import GridAux
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


_AUX_DTYPES = {"origin": torch.float32, "cell": torch.float32,
               "sorted_units": torch.int32, "cell_start": torch.int32}


def grid_aux_from_numpy(arrays: dict, dims, device="cpu") -> GridAux:
    """A ``GridAux`` on ``device`` from arrays keyed by its field names
    (e.g. the leaves of a JAX ``GridAux``: origin (dim,), cell (),
    sorted_units (C,), cell_start (n_cells + 1,), or each with a leading
    batch axis) and its static ``dims``."""
    return GridAux(**{
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                           device=device)
        for name, dtype in _AUX_DTYPES.items()}, dims=tuple(dims))



def lm_params_from_numpy(arrays: dict, cfg, device="cuda") -> dict:
    """An LM's parameters on ``device`` in ``cfg.param_dtype``, from numpy
    arrays keyed by the JAX parameter names (e.g. ``jax.device_get`` of a
    JAX bundle's params). A bf16 array goes through f32, which is exact;
    an f32 array rounds to a bf16 ``param_dtype`` to nearest even, as
    JAX's ``astype`` does."""
    return {name: torch.tensor(np.asarray(a, dtype=np.float32),
                               device=device).to(cfg.param_dtype)
            for name, a in arrays.items()}


def lm_params_to_numpy(params: dict) -> dict:
    """Parameter name -> numpy array on the host (bf16 as f32, exactly)."""
    return {name: (t.detach().float() if t.dtype == torch.bfloat16
                   else t.detach()).cpu().numpy()
            for name, t in params.items()}


def opt_state_from_numpy(arrays: dict, device="cuda") -> dict:
    """An LM optimizer's state on ``device`` from JAX's
    (``jax.device_get`` of ``init_opt_state``'s or ``apply_update``'s
    state): each moment dict in f32, ``step`` a 0-d int32 tensor."""
    return {key: (torch.tensor(np.asarray(v), dtype=torch.int32,
                               device=device) if key == "step" else
                  {name: torch.tensor(np.asarray(a, dtype=np.float32),
                                      device=device)
                   for name, a in v.items()})
            for key, v in arrays.items()}


def opt_state_to_numpy(state: dict) -> dict:
    """The optimizer state as numpy arrays on the host, in JAX's layout."""
    return {key: (np.asarray(v.detach().cpu().numpy()) if key == "step"
                  else lm_params_to_numpy(v))
            for key, v in state.items()}
