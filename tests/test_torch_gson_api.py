"""The port's ``repro_torch.gson`` facade against the JAX one.

Mirrors ``tests/test_gson_api.py``'s registry, custom-variant,
convergence-mode and point-cloud tests, and holds each public behaviour
of the JAX facade that the port's lacked before: the decorator form of
``Registry.register``, its ``items`` / iteration / length / repr,
``resolve_variant`` instantiating a class, ``ModelDef.convergence`` and
``check_convergence``, ``resolve_sampler`` taking ``as_sampler()``,
``resolve_backend(None)`` and a bare Find Winners callable, and
``metrics.genus``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from _torch_parity import to_jax_state  # noqa: E402
from repro import gson as jgson  # noqa: E402
from repro.core.gson import metrics as jmetrics  # noqa: E402
from repro.data.pointclouds import \
    PointCloudStream as JaxStream  # noqa: E402
from repro_torch import gson  # noqa: E402
from repro_torch.configs import soam_paper  # noqa: E402
from repro_torch.core.gson import metrics  # noqa: E402
from repro_torch.core.gson.multi import find_winners_reference  # noqa: E402
from repro_torch.core.gson.sampling import make_sampler  # noqa: E402
from repro_torch.core.gson.state import GSONParams  # noqa: E402
from repro_torch.data.pointclouds import (NoisySampler,  # noqa: E402
                                          PointCloudStream)
from repro_torch.gson.variants import MultiVariant  # noqa: E402

torch.set_num_threads(1)


def short_spec(variant="multi", **kw) -> gson.RunSpec:
    base = dict(
        variant=variant,
        model=GSONParams(model="gwr", insertion_threshold=0.5),
        sampler="sphere", backend="reference",
        capacity=128, max_deg=12, max_iterations=40, check_every=10,
        qe_threshold=0.05, n_probe=256, device="cpu")
    base.update(kw)
    return gson.RunSpec(**base)


# ---------------------------------------------------------------------------
# registries


@pytest.fixture
def scratch_variants():
    """Names a test registers in the port's VARIANTS, removed after it, so
    no other test sees them."""
    names = []
    yield names
    for name in names:
        gson.VARIANTS._entries.pop(name, None)


BUILT_IN = {"single", "indexed", "multi", "multi-fused"}


def test_registries_expose_the_jax_axes():
    assert BUILT_IN <= set(gson.VARIANTS) and BUILT_IN <= set(jgson.VARIANTS)
    assert set(gson.MODELS) == set(jgson.MODELS.names())
    assert set(gson.SAMPLERS) == set(jgson.SAMPLERS.names())
    assert {"reference", "ann-windowed", "ann-grid", "indexed"} <= set(
        gson.BACKENDS)


def test_registry_roundtrip_and_misses():
    strat = gson.VARIANTS.get("multi")
    assert strat.name == "multi"
    assert strat.config_cls is gson.MultiConfig
    with pytest.raises(KeyError, match="multi-fused"):
        gson.VARIANTS.get("warp")   # a miss lists the registered options
    with pytest.raises(ValueError, match="duplicate"):
        gson.VARIANTS.register("multi", strat)


def test_registry_iterates_counts_and_prints_like_jax():
    assert list(gson.VARIANTS) == list(gson.VARIANTS.names())
    assert len(gson.VARIANTS) == len(gson.VARIANTS.names())
    assert len(gson.MODELS) == len(jgson.MODELS) == 3
    assert repr(gson.MODELS) == repr(jgson.MODELS) == (
        "Registry('model': gng, gwr, soam)")
    assert [k for k, _ in gson.MODELS.items()] == ["gng", "gwr", "soam"]
    assert gson.MODELS.items()[2][1] is gson.MODELS.get("soam")


def test_register_doubles_as_a_decorator():
    reg = gson.Registry("thing")

    @reg.register("a")
    def a():
        return 1

    assert reg.get("a") is a and a() == 1
    assert reg.register("b", 2) == 2
    with pytest.raises(ValueError, match="duplicate"):
        reg.register("a")(a)


class HalfMulti(MultiVariant):
    """``multi`` with half the signal buffer."""

    name = "half-multi-test"

    def fleet_cfg(self, spec, params, vcfg):
        cfg = super().fleet_cfg(spec, params, vcfg)
        return dataclasses.replace(cfg, max_parallel=cfg.max_parallel // 2)


def test_custom_variant_registers_and_runs(scratch_variants):
    scratch_variants.append("half-multi-test")
    gson.VARIANTS.register("half-multi-test", HalfMulti())
    state, stats = gson.run(short_spec("half-multi-test", max_iterations=20),
                            seed=0)
    assert stats.iterations == 20
    assert int(state.n_active) > 2
    assert "half-multi-test" in gson.VARIANTS.names()


def test_resolve_variant_instantiates_a_registered_class(scratch_variants):
    scratch_variants.append("class-multi-test")

    @gson.VARIANTS.register("class-multi-test")
    class ClassMulti(MultiVariant):
        name = "class-multi-test"

    strategy = gson.resolve_variant("class-multi-test")
    assert isinstance(strategy, MultiVariant)
    assert isinstance(gson.resolve_variant(HalfMulti), HalfMulti)
    state, stats = gson.run(short_spec("class-multi-test",
                                       max_iterations=10), seed=0)
    assert stats.iterations == 10
    with pytest.raises(TypeError, match="VariantStrategy"):
        gson.resolve_variant(3)


def test_model_convergence_mode_comes_from_registry():
    for name in ("gng", "gwr", "soam"):
        assert gson.MODELS.get(name).convergence == \
            jgson.MODELS.get(name).convergence
    assert gson.MODELS.get("soam").convergence == "topology"
    assert gson.MODELS.get("gwr").convergence == "qe"
    for model in ("soam", "gwr"):
        spec = short_spec(model=model, max_iterations=12, check_every=4)
        sess = gson.Session(spec, seed=0)
        sess.run()
        state, _ = sess.result()
        # the registered mode is the one the run loop checks with
        assert sess.cohorts[0].cfg.convergence == \
            gson.MODELS.get(model).convergence
        done, qe, state2 = gson.check_convergence(sess.rt, state)
        assert isinstance(done, bool) and np.isfinite(qe)
        assert qe == pytest.approx(sess.stats.history[-1]["qe"], rel=1e-6)
        assert int(state2.n_active) == int(state.n_active)


# ---------------------------------------------------------------------------
# samplers: point-cloud streams


def test_pointcloud_stream_is_a_valid_sampler():
    _, rt = gson.resolve(short_spec(sampler=PointCloudStream("sphere")))
    pts = rt.sampler(torch.Generator().manual_seed(0), 8)
    assert pts.shape == (8, 3)
    _, jrt = jgson.resolve(jgson.RunSpec(sampler=JaxStream("sphere")))
    assert type(rt.sampler).__name__ == type(jrt.sampler).__name__


def test_pointcloud_stream_noise_survives_resolution():
    _, rt = gson.resolve(short_spec(
        sampler=PointCloudStream("sphere", noise=0.05)))
    pts = rt.sampler(torch.Generator().manual_seed(0), 512).numpy()
    r = np.linalg.norm(pts, axis=1)
    # a noiseless sphere sampler would give ||p|| == 1 exactly
    assert float(np.std(r)) > 0.01
    _, rt2 = gson.resolve(short_spec(
        sampler=PointCloudStream("sphere", noise=0.05)))
    assert rt.sampler == rt2.sampler
    assert hash(rt.sampler) == hash(rt2.sampler)


def test_pointcloud_stream_signals_are_a_function_of_seed_and_iteration():
    s = PointCloudStream("torus", seed=3, noise=0.02, device="cpu")
    a, b = s.signals(7, 64), s.signals(7, 64)
    assert torch.equal(a, b) and a.shape == (64, 3)
    assert not torch.equal(a, s.signals(8, 64))
    assert not torch.equal(
        a, PointCloudStream("torus", seed=4, noise=0.02,
                            device="cpu").signals(7, 64))
    # the noise comes from the same generator, after the points
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    noisy = NoisySampler(make_sampler("torus"), 0.02)(g1, 16)
    clean = make_sampler("torus")(g2, 16)
    assert torch.equal(noisy, clean + 0.02 * torch.randn(16, 3,
                                                         generator=g2))


def test_a_noisy_stream_runs_in_a_session():
    state, stats = gson.run(short_spec(
        sampler=PointCloudStream("sphere", noise=0.01), max_iterations=20),
        seed=0)
    assert stats.iterations == 20 and int(state.n_active) > 2


# ---------------------------------------------------------------------------
# backends: None and a bare Find Winners


def test_resolve_backend_none_and_bare_callable_follow_jax():
    for pkg in (gson, jgson):
        none = pkg.resolve_backend(None)
        assert (none.name, none.find_winners, none.update_phase) == (
            "reference", None, None)
    custom = gson.resolve_backend(find_winners_reference)
    jcustom = jgson.resolve_backend(jgson.BACKENDS.get("reference")()
                                    .find_winners)
    assert (custom.name, custom.update_phase) == (jcustom.name,
                                                  jcustom.update_phase)
    assert custom.find_winners is find_winners_reference
    with pytest.raises(TypeError, match="FindWinnersFn"):
        gson.resolve_backend(3)


@pytest.mark.parametrize("backend", [None, find_winners_reference])
def test_none_and_bare_callable_runs_equal_the_reference(backend):
    spec = short_spec(model="soam", max_iterations=20)
    st, stats = gson.run(spec.replace(backend=backend), seed=1)
    ref, ref_stats = gson.run(spec, seed=1)
    assert stats.history == ref_stats.history
    for name in ("w", "nbr", "active", "age"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name


# ---------------------------------------------------------------------------
# metrics and the paper's configuration


def test_genus_matches_jax():
    spec = short_spec(model="soam", max_iterations=30)
    st, _ = gson.run(spec, seed=2)
    chi = metrics.euler_characteristic(st)[3]
    assert metrics.genus(st) == (2 - chi) / 2.0
    assert metrics.genus(st) == jmetrics.genus(to_jax_state(st))


def test_paper_spec_matches_jax():
    from repro.configs import soam_paper as jpaper
    assert soam_paper.CAPACITY == jpaper.CAPACITY == 32768
    assert (soam_paper.MAX_DEG, soam_paper.DIM) == (jpaper.MAX_DEG,
                                                    jpaper.DIM)
    assert dataclasses.asdict(soam_paper.config) == dataclasses.asdict(
        jpaper.config)
    spec, jspec = soam_paper.paper_spec("torus", "indexed"), \
        jpaper.paper_spec("torus", "indexed")
    for f in ("variant", "sampler", "capacity", "dim", "max_deg"):
        assert getattr(spec, f) == getattr(jspec, f), f
    assert (spec.backend, spec.device) == ("cuda-full", "cuda")
    assert isinstance(gson.resolve(spec)[0], type(
        gson.VARIANTS.get("indexed")))
