"""The JAX package's acceptance-gate configuration, run by the port.

The SOAM sphere run that ``tests/test_ann.py`` gates on (capacity 768,
supersteps of 64, refresh every 2 iterations, up to 1500 iterations, the
gate's ``GSONParams``, run key 42) goes through the JAX ``Session`` on
its ``reference`` backend and through the port's ``Session`` on the CPU
under the same draws (``JaxReplayDraws``). The port must converge at
the same iteration with the same history rows, the same neighbor table
and a ``topology_quality`` verdict of ok against the JAX state: this is
the long-horizon counterpart of ``tests/test_torch_session.py``.
"""
from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import JaxReplayDraws, t, to_torch_state  # noqa: E402
from repro import gson as jgson  # noqa: E402
from repro.core.gson.sampling import make_sampler as jax_sampler  # noqa: E402
from repro_torch import gson  # noqa: E402
from repro_torch.core.gson import metrics  # noqa: E402

torch.set_num_threads(1)

PARAMS = dict(model="soam", insertion_threshold=0.35, age_max=64.0,
              eps_b=0.1, eps_n=0.01, stuck_window=60)


def _spec(pkg, **extra):
    return pkg.RunSpec(
        variant="multi-fused", model=pkg.GSONParams(**PARAMS),
        sampler="sphere",
        variant_config=pkg.FusedConfig(
            superstep=pkg.SuperstepConfig(length=64), refresh_every=2),
        capacity=768, max_deg=16, check_every=25, max_iterations=1500,
        **extra)


def test_gate_configuration_matches_jax():
    jst, jstats = jgson.run(_spec(jgson, backend="reference"),
                            jax.random.key(42))
    sess = gson.Session(_spec(gson, device="cpu"),
                        JaxReplayDraws("sphere", key=jax.random.key(42)))
    sess.run()
    st, stats = sess.result()

    assert stats.converged == jstats.converged
    assert stats.iterations == jstats.iterations
    assert len(stats.history) == len(jstats.history) > 0
    for row, jrow in zip(stats.history, jstats.history):
        assert (row["iteration"], row["units"], row["signals"]) == (
            jrow["iteration"], jrow["units"], jrow["signals"])
        assert row["qe"] == pytest.approx(jrow["qe"], rel=1e-5, abs=1e-7)
    np.testing.assert_array_equal(st.nbr.numpy(), np.asarray(jst.nbr))

    probes = t(jax_sampler("sphere")(jax.random.key(123), 2048))
    tq = metrics.topology_quality(st, to_torch_state(jst), probes,
                                  qe_tol=0.05)
    assert tq.ok and tq.chi == tq.exact_chi, tq
    assert tq.qe == pytest.approx(tq.exact_qe, rel=1e-5)
