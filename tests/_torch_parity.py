"""Helpers for holding the PyTorch port against the JAX package.

* ``JaxReplayDraws`` — an RNG seam for ``repro_torch`` that replays the
  JAX package's own key schedule with ``jax.random``: the run key splits
  into (sampling, init, probe, seed) keys (``core/gson/fleet.py``
  ``fleet_init``), each iteration splits the sampling key and draws a
  full buffer (``fleet_iterate_impl``), and each step splits the state's
  key into the next key and the lock key, whose permutation over all
  ``m`` buffer rows gives the lock priorities (``multi.py``). A port run
  fed these draws sees the signals and priorities the JAX run drew.
* numpy round trips of ``NetworkState`` between the packages.
* ``grown_state`` / ``phase_inputs``: a pool grown by the port and the
  inputs of one Update phase, for both packages; ``relabel``: the same
  network at other unit ids, e.g. a pool fragmented across tiles.
* The host variants (``single``) draw one chunk per iteration with the
  same split as the fleet loop: ``split(rng) -> (rng, k_sig)``, then
  ``sampler(k_sig, chunk)``. ``JaxReplayDraws.signals(chunk)`` is that
  schedule, so it serves a ``single`` run as it serves ``multi``.
* field-by-field checkers for the numerics contract: discrete fields
  bitwise, floats within a stated tolerance.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.gson import state as jstate
from repro.core.gson.multi import find_winners_reference
from repro_torch import convert
from repro_torch.core.gson.multi import multi_signal_step
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import FIELDS, init_state

# one step: floats within 1e-6 relative (colliding neighbor sums are
# added in another order); multi-step runs drift a little further
STEP_TOL = dict(rtol=1e-6, atol=1e-7)
RUN_TOL = dict(rtol=1e-5, atol=1e-6)

DISCRETE = ("active", "nbr", "age", "topo_state", "inconsistent_for",
            "n_active", "signal_count", "discarded", "dropped_edges",
            "dropped_units")
FLOATS = ("w", "error", "firing", "threshold")


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


class JaxReplayDraws:
    """The JAX package's draws for ``Session(spec, seed=seed)`` (or any
    run key), served through the port's RNG seam on the CPU."""

    def __init__(self, surface: str, seed: int = 0, key=None):
        from repro.core.gson.sampling import make_sampler
        self._sample = jax.jit(make_sampler(surface), static_argnums=1)
        self._perm = jax.jit(jax.random.permutation, static_argnums=1)
        key = jax.random.key(seed) if key is None else key
        ks = jax.random.split(key, 4)
        self._sig_key, k_init, self._probe_key, self._seed_key = ks
        self._lock_key = jax.random.split(k_init)[0]  # init_state's split

    def seed_points(self, n: int) -> torch.Tensor:
        return t(self._sample(self._seed_key, n))

    def probes(self, n: int) -> torch.Tensor:
        return t(self._sample(self._probe_key, n))

    def signals(self, n: int) -> torch.Tensor:
        self._sig_key, k = jax.random.split(self._sig_key)
        return t(self._sample(k, n))

    def lock_priorities(self, m: int) -> torch.Tensor:
        self._lock_key, k = jax.random.split(self._lock_key)
        return t(self._perm(k, m), torch.int32)

    _KEYS = ("_sig_key", "_probe_key", "_seed_key", "_lock_key")

    def state_dict(self) -> dict:
        """The four keys' data, as numpy uint32 arrays."""
        return {k: np.asarray(jax.random.key_data(getattr(self, k)))
                for k in self._KEYS}

    def load_state_dict(self, d: dict) -> None:
        for k in self._KEYS:
            setattr(self, k, jax.random.wrap_key_data(
                jnp.asarray(d[k], jnp.uint32)))


def lock_priorities(k_lock, m: int) -> torch.Tensor:
    """The JAX lock priorities of one step, for the port."""
    return t(jax.random.permutation(k_lock, m), torch.int32)


def jax_state_arrays(st) -> dict:
    return {name: np.asarray(getattr(st, name)) for name in FIELDS}


def to_torch_state(st):
    """A JAX ``NetworkState`` -> the port's, on the CPU."""
    return convert.state_from_numpy(jax_state_arrays(st), "cpu")


def to_jax_state(st, rng=None):
    """The port's ``NetworkState`` -> a JAX one (``rng`` as its key)."""
    arrays = convert.state_to_numpy(st)
    rng = jax.random.key(0) if rng is None else rng
    return jstate.NetworkState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, rng=rng)


def torch_params(p):
    """JAX ``GSONParams`` -> the port's."""
    return convert.params_from_fields(dataclasses.asdict(p))


def grown_state(model: str, capacity=200, max_deg=12, iters=25, m=64,
                seed=0, device="cpu"):
    """A non-trivial network: ``iters`` plain port steps on the torus."""
    p = jstate.GSONParams(model=model, insertion_threshold=0.3)
    tp = torch_params(p)
    sampler = make_sampler("torus")
    g = torch.Generator(device=device).manual_seed(seed)
    st = init_state(sampler(g, 2), capacity=capacity, max_deg=max_deg,
                    init_threshold=tp.insertion_threshold)
    for i in range(iters):
        prio = torch.randperm(m, generator=g, device=device,
                              dtype=torch.int32)
        st = multi_signal_step(st, sampler(g, m), tp, prio,
                               refresh_states=(i % 5 == 0))
    return p, tp, st


_FILL = {"w": 0.0, "active": False, "nbr": -1, "age": 0.0, "error": 0.0,
         "firing": 1.0, "topo_state": 0, "inconsistent_for": 0}
UNIT_FIELDS = (*_FILL, "threshold")


def relabel(st, new_ids, capacity: int):
    """The port state ``st`` with unit i moved to ``new_ids[i]`` (distinct
    ids in a pool of ``capacity``) and its edges renamed to match; free
    slots as a fresh pool has them (threshold: unit 0's)."""
    src = convert.state_to_numpy(st)
    new_ids = np.asarray(new_ids)
    out = dict(src)
    for name in UNIT_FIELDS:
        a = src[name]
        fill = _FILL.get(name, a[0])
        out[name] = np.full((capacity, *a.shape[1:]), fill, a.dtype)
        out[name][new_ids] = a
    nbr = out["nbr"]
    out["nbr"] = np.where(nbr >= 0, new_ids[np.maximum(nbr, 0)],
                          -1).astype(np.int32)
    return convert.state_from_numpy(out, "cpu")


def phase_inputs(st, m=64, masked=None, seed=0):
    """numpy signals, JAX winners, the lock key and its priorities."""
    sig = make_sampler("torus")(
        torch.Generator().manual_seed(100 + seed), m).numpy()
    wid, sid, d2b, _ = find_winners_reference(
        jnp.asarray(sig), jnp.asarray(st.w.numpy()),
        jnp.asarray(st.active.numpy()))
    k_lock = jax.random.key(7 + seed)
    mask = None if masked is None else np.arange(m) < masked
    return sig, wid, sid, d2b, k_lock, mask


def assert_states_match(jst, tst, tol=STEP_TOL, tag=""):
    """Discrete fields bitwise, float fields within ``tol``."""
    got = convert.state_to_numpy(tst)
    for name in DISCRETE:
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      got[name], f"{tag} {name}")
    for name in FLOATS:
        np.testing.assert_allclose(np.asarray(getattr(jst, name)),
                                   got[name], err_msg=f"{tag} {name}",
                                   **tol)


def assert_update_out_match(jout, tout, tol=STEP_TOL, tag=""):
    """``UpdateOut``: decisions and ages bitwise, floats within ``tol``."""
    for name in ("selected", "adapt", "ins", "age"):
        np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                      getattr(tout, name).numpy(),
                                      f"{tag} {name}")
    for name in ("w", "firing", "error"):
        np.testing.assert_allclose(np.asarray(getattr(jout, name)),
                                   getattr(tout, name).numpy(),
                                   err_msg=f"{tag} {name}", **tol)


def assert_invariants(nbr, age, active=None):
    """Symmetric neighbor lists and ages, no self edges or duplicate
    slots, edges only between active units."""
    nbr = np.asarray(nbr)
    age = np.asarray(age)
    act = None if active is None else np.asarray(active)
    for i in range(nbr.shape[0]):
        row = [v for v in nbr[i] if v >= 0]
        assert len(row) == len(set(row)), f"dup neighbor in row {i}"
        assert i not in row, f"self edge at {i}"
        for slot, j in enumerate(nbr[i]):
            if j < 0:
                continue
            back = np.nonzero(nbr[j] == i)[0]
            assert back.size == 1, f"asymmetric edge ({i},{j})"
            assert age[i, slot] == age[j, back[0]], f"age mismatch ({i},{j})"
            if act is not None:
                assert act[i] and act[j], f"edge to inactive ({i},{j})"


def near_tie_free(signals, w, active, eps=1e-4):
    """(m,) bool: rows whose three smallest active distances (float64)
    are more than ``eps`` apart — where the top-2 ids are well defined
    under float32 rounding."""
    x = np.asarray(signals, np.float64)
    u = np.asarray(w, np.float64)
    d = ((x[:, None, :] - u[None, :, :]) ** 2).sum(-1)
    d = np.where(np.asarray(active)[None, :], d, np.inf)
    d = np.sort(d, axis=1)[:, :3]
    if d.shape[1] < 3:
        d = np.concatenate([d, np.full((d.shape[0], 3 - d.shape[1]),
                                       np.inf)], axis=1)
    with np.errstate(invalid="ignore"):       # inf - inf: no third unit
        gaps = np.diff(d, axis=1)
    return np.all(np.nan_to_num(gaps, nan=np.inf) > eps, axis=1)


# ---------------------------------------------------------------------------
# the LM: one set of JAX weights in both packages

def lm_pair(arch: str, key: int = 0, **overrides):
    """(JAX cfg, bundle, params; port cfg, bundle, params) of ``arch``'s
    smoke config from one set of weights, ``bundle.init(jax.random.key(
    key))`` carried across through numpy. ``overrides`` replace config
    fields in both (dtypes by name: ``compute_dtype="bfloat16"``)."""
    from repro.configs import get_config as jax_get_config
    from repro.models import registry as jreg
    from repro_torch.configs import get_config
    from repro_torch.models import registry

    def cfg_of(base, mod):
        return base.replace(**{
            k: getattr(mod, v) if isinstance(v, str) and k.endswith("dtype")
            else v for k, v in overrides.items()})

    jcfg = cfg_of(jreg.smoke_config(jax_get_config(arch)), jnp)
    jb = jreg.get_bundle(jcfg)
    arrays = jax.device_get(jb.init(jax.random.key(key)))
    cfg = cfg_of(registry.smoke_config(get_config(arch)), torch)
    tb = registry.get_bundle(cfg)
    return (jcfg, jb, {k: jnp.asarray(v) for k, v in arrays.items()},
            cfg, tb, convert.lm_params_from_numpy(arrays, cfg, device="cpu"))


def lm_batches(jcfg, shape, steps, seed: int = 0):
    """JAX's ``synthetic_batch`` for ``steps`` steps, in both packages:
    [(JAX batch, port batch)] (the port's own token draws differ)."""
    from repro.data.tokens import synthetic_batch
    out = []
    for i in steps:
        jbatch = synthetic_batch(jcfg, shape, step=i, seed=seed)
        out.append((jbatch, {k: torch.tensor(np.asarray(v))
                             for k, v in jbatch.items()}))
    return out
