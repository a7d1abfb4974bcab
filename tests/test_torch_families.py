"""The SSM (mamba2-2.7b), hybrid (zamba2-2.7b) and enc-dec
(whisper-medium) families of the port against the JAX package's.

Each smoke config (the hybrid's shared block every 2 layers) runs in both
packages from one set of JAX weights carried across with
``lm_params_from_numpy``; the parameters that init to constants (the
norms' gains, ``A_log``, ``dt_bias``, ``Dskip``) get values of their own,
so a wrong sign or a missing ``exp`` shows. At f32: forward logits, the
loss, prefill (logits and every cache entry) and three decode steps
within rtol = atol = 1e-4; a prompt of three SSD chunks likewise; one
train step's loss and gradients within 1e-5 relative; ``ServeEngine``'s
greedy tokens equal the JAX engine's. The full configs' parameter and
cache tables equal JAX's. A bf16 run is checked finite.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jreg
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.tokens import synthetic_batch
from repro_torch.models import registry
from repro_torch.models.common import SMOKE_SHAPES
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.training.trainer import grad_fn

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium")
B, T0, STEPS = 2, 6, 3
OWN_VALUES = {"A_log": 0.0, "dt_bias": 0.0, "Dskip": 1.0}


@functools.lru_cache(maxsize=None)
def carried(arch: str, **overrides):
    """(JAX cfg, bundle, params; port cfg, bundle, params) from one set of
    JAX weights, the constant-init parameters given values of their own:
    the norms' gains and ``Dskip`` around 1, ``A_log`` and ``dt_bias``
    around 0 (A = -exp(A_log) about -1, dt about softplus(0) = 0.69)."""
    jcfg = jreg.smoke_config(jax_get_config(arch)).replace(
        **{k: getattr(jnp, v) if isinstance(v, str) else v
           for k, v in overrides.items()})
    jb = jreg.get_bundle(jcfg)
    arrays = jax.device_get(jb.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    for k, v in arrays.items():
        leaf = k.rsplit("/", 1)[-1]
        if "norm" in leaf or leaf.startswith("ln") or leaf in OWN_VALUES:
            base = OWN_VALUES.get(leaf, 1.0)
            arrays[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    cfg = registry.smoke_config(get_config(arch)).replace(
        **{k: getattr(torch, v) if isinstance(v, str) else v
           for k, v in overrides.items()})
    tb = registry.get_bundle(cfg)
    tp = lm_params_from_numpy(arrays, cfg, device="cpu")
    return jcfg, jb, jp, cfg, tb, tp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return carried(request.param)


def inputs(cfg, seed=0, steps=STEPS, t0=T0):
    """Tokens (B, t0 + steps) and, for enc-dec, stub frames, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (B, t0 + steps)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model))).astype(np.float32)
    return toks, extra


def jbatch(toks, extra, **more):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in {**extra, **more}.items()}}


def tbatch(toks, extra, **more):
    return {"tokens": torch.from_numpy(toks),
            **{k: torch.from_numpy(v) for k, v in {**extra, **more}.items()}}


def close(port, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), err_msg=msg, **tol)


def close_cache(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for name, ref in jcache.items():
        assert tuple(cache[name].shape) == ref.shape, name
        if name == "length":
            assert cache[name].tolist() == np.asarray(ref).tolist()
        else:
            close(cache[name], ref, msg=name)


def test_forward_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, extra = inputs(cfg)
    ref, _ = jb.forward(jp, jbatch(toks, extra))
    logits, aux = tb.forward(tp, tbatch(toks, extra))
    assert logits.shape == ref.shape and float(aux) == 0.0
    close(logits, ref)


def test_loss_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, extra = inputs(cfg, seed=1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1                       # masked positions
    ref, rm = jb.loss(jp, jbatch(toks, extra, labels=labels))
    loss, m = tb.loss(tp, tbatch(toks, extra, labels=labels))
    close(loss, ref)
    close(m["ce"], rm["ce"])


def test_prefill_and_decode_match_jax(pair):
    """Prefill (logits and every cache entry), then three decode steps,
    the cache again after them."""
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, extra = inputs(cfg, seed=2)
    jcache, jl = jb.prefill(jp, jbatch(toks[:, :T0], extra),
                            max_len=T0 + STEPS)
    cache, logits = tb.prefill(tp, tbatch(toks[:, :T0], extra),
                               max_len=T0 + STEPS)
    close(logits, jl)
    close_cache(cache, jcache)
    for j in range(STEPS):
        tok = toks[:, T0 + j:T0 + j + 1]
        jcache, jl = jb.decode_step(jp, jcache, jnp.asarray(tok))
        cache, logits = tb.decode_step(tp, cache, torch.from_numpy(tok))
        close(logits, jl, msg=f"decode step {j}")
    close_cache(cache, jcache)


def test_prefill_decode_matches_forward(pair):
    """The port alone: prefill + decode reproduce the teacher-forced
    forward logits within 2e-3 (``tests/test_models_smoke.py``'s
    check)."""
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, extra = inputs(cfg, seed=3)
    cache, logits = tb.prefill(tp, tbatch(toks[:, :T0], extra),
                               max_len=T0 + STEPS)
    ref, _ = tb.forward(tp, tbatch(toks, extra))
    torch.testing.assert_close(logits, ref[:, T0 - 1], rtol=2e-3, atol=2e-3)
    for j in range(STEPS):
        cache, logits = tb.decode_step(
            tp, cache, torch.from_numpy(toks[:, T0 + j:T0 + j + 1]))
        torch.testing.assert_close(logits, ref[:, T0 + j], rtol=2e-3,
                                   atol=2e-3, msg=f"decode step {j}")


def test_decode_step_updates_the_given_cache_in_place(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, extra = inputs(cfg, seed=4)
    cache, _ = tb.prefill(tp, tbatch(toks[:, :T0], extra), max_len=T0 + 1)
    before = {k: v.clone() for k, v in cache.items()}
    new, logits = tb.decode_step(tp, cache, torch.from_numpy(toks[:, T0:T0 + 1]))
    moved = [k for k in cache if k != "length"
             and not torch.equal(cache[k], before[k])]
    assert all(new[k] is cache[k] for k in cache if k != "length")
    want = {"ssm": {"ssm", "hx", "hb", "hc"},
            "hybrid": {"ssm", "hx", "hb", "hc", "k", "v"},
            "encdec": {"k", "v"}}[cfg.family]
    assert set(moved) == want                # written in place
    assert cache["length"].tolist() == [T0] * B
    assert new["length"].tolist() == [T0 + 1] * B
    assert logits.shape == (B, cfg.vocab)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_multi_chunk_prefill_carries_the_state(arch):
    """A prompt of three SSD chunks (48 tokens, chunk 16) carries the state
    across chunks: prefill's logits and cache against JAX's and against
    the port's own forward over four chunks, then one decode step against
    both."""
    jcfg, jb, jp, cfg, tb, tp = carried(arch)
    assert cfg.ssm_chunk == 16
    toks, extra = inputs(cfg, seed=5, t0=48, steps=16)
    jcache, jl = jb.prefill(jp, jbatch(toks[:, :48], extra), max_len=49)
    cache, logits = tb.prefill(tp, tbatch(toks[:, :48], extra), max_len=49)
    close(logits, jl)
    close_cache(cache, jcache)
    ref, _ = tb.forward(tp, tbatch(toks, extra))
    torch.testing.assert_close(logits, ref[:, 47], rtol=2e-3, atol=2e-3)
    tok = toks[:, 48:49]
    jcache, jl = jb.decode_step(jp, jcache, jnp.asarray(tok))
    cache, logits = tb.decode_step(tp, cache, torch.from_numpy(tok))
    close(logits, jl)
    torch.testing.assert_close(logits, ref[:, 48], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_a_prompt_of_partial_chunks_raises(arch):
    """20 tokens past a chunk of 16 is not whole chunks: JAX raises, and
    so does the port (nothing is padded)."""
    jcfg, jb, jp, cfg, tb, tp = carried(arch)
    toks, extra = inputs(cfg, t0=20, steps=0)
    with pytest.raises(TypeError):
        jb.prefill(jp, jbatch(toks, extra))
    with pytest.raises(ValueError, match="whole number of chunks"):
        tb.prefill(tp, tbatch(toks, extra))


def test_train_step_matches_jax(pair):
    """The loss and every gradient against ``jax.value_and_grad`` within
    1e-5 relative (each gradient against its parameter's largest). Over
    32 tokens the SSD's chunks hold 16, where |cum_i - cum_j| stays near
    16 * 0.69 * 1 = 11, far below f32's exp overflow at 88.7 (the
    gradient through a longer chunk is NaN in both packages)."""
    jcfg, jb, jp, cfg, tb, tp = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(2, cfg.vocab, (B, 33)).astype(np.int32)
    _, extra = inputs(cfg, seed=6)
    labels = toks[:, 1:].copy()
    labels[:, -3:] = -1
    (jl, jm), jg = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jp, jbatch(toks[:, :-1], extra, labels=labels))
    (loss, m), grads = grad_fn(tb)(
        tp, tbatch(toks[:, :-1].copy(), extra, labels=labels))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert sorted(grads) == sorted(jg)
    for k in grads:
        ref = np.asarray(jg[k])
        assert np.isfinite(ref).all() and torch.isfinite(grads[k]).all(), k
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


def test_greedy_serving_equals_the_jax_engine(pair):
    """Seven requests (prompts of 1-8 tokens) through three slots, greedy,
    in both engines (whisper on the engines' zero frames): every
    ``Request.out`` equal token for token."""
    jcfg, jb, jp, cfg, tb, tp = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(1, 9)))
               for _ in range(7)]
    jeng = JaxServeEngine(jb, jp, JaxServeConfig(batch=3, max_len=24,
                                                 eos_id=-1))
    eng = ServeEngine(tb, tp, ServeConfig(batch=3, max_len=24, eos_id=-1))
    for i, p in enumerate(prompts):
        jeng.submit(p, rid=i, max_tokens=5)
        eng.submit(p, rid=i, max_tokens=5)
    jdone = {r.rid: r.out for r in jeng.run()}
    done = {r.rid: r.out for r in eng.run()}
    assert done == jdone
    assert (eng.prefills, eng.decode_steps) == (jeng.prefills,
                                                jeng.decode_steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_is_finite(arch):
    """bf16 compute from f32 weights: forward, prefill and decode finite,
    and the greedy serve finishes every request."""
    *_, cfg, tb, tp = carried(arch, compute_dtype="bfloat16")
    toks, extra = inputs(cfg, seed=8)
    logits, _ = tb.forward(tp, tbatch(toks, extra))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    cache, logits = tb.prefill(tp, tbatch(toks[:, :T0], extra),
                               max_len=T0 + STEPS)
    assert torch.isfinite(logits).all()
    for j in range(STEPS):
        cache, logits = tb.decode_step(
            tp, cache, torch.from_numpy(toks[:, T0 + j:T0 + j + 1]))
        assert torch.isfinite(logits).all()
    eng = ServeEngine(tb, tp, ServeConfig(batch=2, max_len=16, eos_id=-1))
    for i in range(3):
        eng.submit(toks[i % B, :4], rid=i, max_tokens=3)
    assert sorted(len(r.out) for r in eng.run()) == [3, 3, 3]


# ---------------------------------------------------------------------------
# tables and inputs (meta tensors: nothing allocated)


def _table(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")
                if isinstance(v, torch.Tensor) else jnp.dtype(v.dtype).name)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_and_cache_tables_match_jax(arch):
    jb = jreg.get_bundle(jax_get_config(arch))
    tb = registry.get_bundle(get_config(arch))
    assert _table(tb.param_shapes()) == _table(jb.param_shapes())
    assert _table(tb.cache_shapes(8, 256)) == _table(jb.cache_shapes(8, 256))


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, kind):
    jb = jreg.get_bundle(jreg.smoke_config(jax_get_config(arch)))
    tb = registry.get_bundle(registry.smoke_config(get_config(arch)))
    shape = SMOKE_SHAPES[kind]
    js, ts = jb.input_specs(shape), tb.input_specs(shape)
    if kind == "decode_32k":
        assert _table(ts.pop("cache")) == _table(js.pop("cache"))
    assert _table(ts) == _table(js)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_matches_input_specs(arch):
    """The token stream's batch, with the enc-dec ``frames`` stub (0.02 *
    N(0, 1) from the port's own generator), has the specs' table and
    gives a finite loss."""
    cfg = registry.smoke_config(get_config(arch))
    tb = registry.get_bundle(cfg)
    shape = SMOKE_SHAPES["train_4k"]
    batch = synthetic_batch(cfg, shape, step=0, seed=0, device="cpu")
    assert _table(batch) == _table(tb.input_specs(shape))
    if cfg.family == "encdec":
        again = synthetic_batch(cfg, shape, step=0, seed=0, device="cpu")
        assert torch.equal(batch["frames"], again["frames"])
        assert abs(float(batch["frames"].std()) - 0.02) < 2e-3
    loss, _ = tb.loss(tb.init(0, device="cpu"), batch)
    assert torch.isfinite(loss) and float(loss) > 0


def test_the_engine_gives_whisper_zero_frames():
    cfg = registry.smoke_config(get_config("whisper-medium"))
    tb = registry.get_bundle(cfg)
    eng = ServeEngine(tb, tb.init(0, device="cpu"), ServeConfig(batch=2))
    stub = eng._modality_stub(2)
    assert sorted(stub) == ["frames"]
    assert stub["frames"].shape == (2, cfg.encoder_ctx, cfg.d_model)
    assert stub["frames"].dtype == torch.float32
    assert not stub["frames"].any()


def test_every_config_builds():
    """``get_bundle`` builds every config of ``repro_torch.configs``, and
    each of them decodes."""
    from repro_torch.configs import all_configs
    for name, cfg in all_configs().items():
        tb = registry.get_bundle(cfg)
        assert tb.can_decode and tb.param_shapes(), name
