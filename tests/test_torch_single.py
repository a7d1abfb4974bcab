"""The paper's sequential baseline in the port, against the JAX package.

* ``single_signal_scan`` is the multi-signal step at m = 1, signal by
  signal (mirrors ``tests/test_gson_behavior.py::
  test_single_equals_multi_at_m1``), for gng, gwr and soam.
* The port's ``single_signal_scan`` equals the JAX one on the same state
  and signals: ``nbr``, ``active`` and ``n_active`` bitwise, ``w`` within
  rtol=1e-5, atol=1e-6 (``RUN_TOL``: a run of steps drifts at ulp scale),
  over two chunks longer than ``refresh_every``, so that the SOAM refresh
  falls inside each chunk on a counter that restarts per chunk.
* ``Session(RunSpec(variant="single"))`` under the JAX draws emits the
  JAX ``Session``'s history rows (``units`` and ``signals`` exactly,
  ``qe`` within 1e-5).
* ``single`` is not fleet-capable: ``FleetSession`` raises the JAX
  package's error.
* The legacy ``EngineConfig`` / ``GSONEngine`` shim (mirrors
  ``tests/test_gson_api.py``).
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (RUN_TOL, JaxReplayDraws,  # noqa: E402
                           grown_state, t, to_jax_state, torch_params)
from repro import gson as jgson  # noqa: E402
from repro.core.gson.single import \
    single_signal_scan as jax_scan  # noqa: E402
from repro.core.gson.state import GSONParams as JaxParams  # noqa: E402
from repro_torch import gson  # noqa: E402
from repro_torch.core.gson.engine import EngineConfig, GSONEngine  # noqa
from repro_torch.core.gson.multi import multi_signal_step  # noqa: E402
from repro_torch.core.gson.sampling import make_sampler  # noqa: E402
from repro_torch.core.gson.single import single_signal_scan  # noqa: E402
from repro_torch.core.gson.state import FIELDS, init_state  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("model", ["gng", "gwr", "soam"])
def test_single_equals_multi_at_m1(model):
    p = gson.GSONParams(model=model, insertion_threshold=0.35)
    sampler = make_sampler("sphere")
    g = torch.Generator().manual_seed(1)
    st0 = init_state(sampler(g, 2), capacity=256, max_deg=16,
                     init_threshold=p.insertion_threshold)
    signals = sampler(g, 40)
    st_m = st0
    one = torch.zeros((1,), dtype=torch.int32)    # the lone signal's lock
    for i in range(signals.shape[0]):
        st_m = multi_signal_step(st_m, signals[i:i + 1], p, one,
                                 refresh_states=False)
    st_s = single_signal_scan(st0, signals, p, refresh_every=10**9)
    for name in FIELDS:
        assert torch.equal(getattr(st_m, name), getattr(st_s, name)), name
    assert int(st_s.n_active) > 2 or model == "gng"
    assert int(st_s.discarded) == 0                 # m = 1 never discards


@pytest.mark.parametrize("model", ["gng", "gwr", "soam"])
def test_single_signal_scan_matches_jax(model):
    p, tp, st = grown_state(model, capacity=160, iters=8)
    jst = to_jax_state(st)
    sampler = make_sampler("torus")
    g = torch.Generator().manual_seed(9)
    for chunk in range(2):           # the refresh counter restarts per chunk
        sig = sampler(g, 40)
        st = single_signal_scan(st, sig, tp, refresh_every=25)
        jst = jax_scan(jst, jnp.asarray(sig.numpy()), p, refresh_every=25)
        tag = f"{model} chunk {chunk}"
        for name in ("nbr", "active", "n_active", "topo_state",
                     "signal_count"):
            np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                          getattr(st, name).numpy(),
                                          f"{tag} {name}")
        np.testing.assert_allclose(np.asarray(jst.w), st.w.numpy(),
                                   err_msg=f"{tag} w", **RUN_TOL)


SPEC = dict(variant="single", model="soam", sampler="sphere", capacity=256,
            max_iterations=4, check_every=2, n_probe=256)
CFG = dict(chunk=64, refresh_every=50)


def test_single_session_rows_match_jax():
    jsess = jgson.Session(jgson.RunSpec(
        **SPEC, variant_config=jgson.SingleConfig(**CFG)), seed=3)
    jsess.run()
    jrows = jsess.stats.history
    spec = gson.RunSpec(**SPEC, variant_config=gson.SingleConfig(**CFG),
                        device="cpu")
    assert spec.backend == "cuda-full"    # the kernels' plain versions here
    sess = gson.Session(spec, JaxReplayDraws("sphere", seed=3))
    rows = list(sess.stream())
    assert len(rows) == len(jrows) == 2
    for row, jrow in zip(rows, jrows):
        assert row["iteration"] == jrow["iteration"]
        assert row["units"] == jrow["units"]
        assert row["signals"] == jrow["signals"] == 64 * row["iteration"]
        assert row["qe"] == pytest.approx(jrow["qe"], rel=1e-5, abs=1e-7)
    st, stats = sess.result()
    np.testing.assert_array_equal(st.nbr.numpy(),
                                  np.asarray(jsess.result()[0].nbr))
    assert stats.discarded == 0


def test_single_is_not_fleet_capable_as_in_jax():
    jspec = jgson.RunSpec(**SPEC)
    with pytest.raises(ValueError) as jerr:
        jgson.FleetSession(jgson.FleetSpec.broadcast(jspec, seeds=range(2)))
    spec = gson.RunSpec(**SPEC, device="cpu")
    for B in (2, 1):
        with pytest.raises(ValueError) as err:
            gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(B)))
        assert str(err.value) == str(jerr.value)
    assert gson.Session(spec).started is False     # a Session takes it


def test_variant_registry():
    assert {"single", "indexed", "multi", "multi-fused"} == set(
        gson.VARIANTS.names())
    with pytest.raises(KeyError, match="unknown variant 'warp'"):
        gson.Session(gson.RunSpec(variant="warp", device="cpu"))


# ---------------------------------------------------------------------------
# the legacy engine shim


def test_engine_config_maps_to_typed_variant_configs():
    cfg = EngineConfig(variant="multi-fused", fixed_m=32,
                       superstep=gson.SuperstepConfig(length=7))
    vc = cfg.variant_config()
    assert isinstance(vc, gson.FusedConfig)
    assert vc.superstep.length == 7 and vc.fixed_m == 32
    single = EngineConfig(variant="single", chunk=128,
                          single_refresh_every=30).variant_config()
    assert single == gson.SingleConfig(chunk=128, refresh_every=30)
    assert isinstance(EngineConfig().variant_config(), gson.MultiConfig)
    indexed = EngineConfig(variant="indexed", chunk=64,
                           single_refresh_every=30, grid_per_axis=12,
                           per_cell_cap=8, index_rebuild_every=16)
    assert indexed.variant_config(((-2.0,) * 3, (2.0,) * 3)) == \
        gson.IndexedConfig(chunk=64, refresh_every=30, grid_per_axis=12,
                           per_cell_cap=8, rebuild_every=16,
                           bbox=((-2.0,) * 3, (2.0,) * 3))
    assert indexed.variant_config().bbox == gson.DEFAULT_BBOX
    a, b = EngineConfig(), EngineConfig()
    assert a.params is not b.params and a.superstep is not b.superstep


@pytest.mark.parametrize("variant", ["multi", "multi-fused", "single"])
def test_shim_parity_with_new_api(variant):
    cfg = EngineConfig(
        params=gson.GSONParams(model="gwr", insertion_threshold=0.5),
        capacity=128, max_deg=12, variant=variant,
        superstep=gson.SuperstepConfig(length=16), chunk=32,
        single_refresh_every=20,
        max_iterations=(4 if variant == "single" else 40),
        check_every=(2 if variant == "single" else 10), qe_threshold=0.05,
        n_probe=256)
    with pytest.deprecated_call():
        eng = GSONEngine(cfg, "sphere", device="cpu")
    state_old, stats_old = eng.run(42)
    state_new, stats_new = gson.run(cfg.to_spec("sphere", device="cpu"),
                                    seed=42)
    assert stats_old.units == stats_new.units
    assert stats_old.signals == stats_new.signals
    assert stats_old.iterations == stats_new.iterations
    assert stats_old.history == stats_new.history
    assert stats_old.quantization_error == stats_new.quantization_error
    assert torch.equal(state_old.nbr, state_new.nbr)
    assert eng.spec.backend == "reference"
