"""The port's LM substrate (``repro_torch.models``, ``configs``,
``data.tokens``) against the JAX package's.

The smoke configs of qwen1.5-0.5b (MHA, QKV bias), granite-3-2b (GQA)
and internvl2-76b (the vlm image prefix) run in both packages from the
same weights: JAX's ``bundle.init(jax.random.key(0))`` carried across
with ``lm_params_from_numpy``. At f32, forward logits, the loss, prefill
(logits and cache) and three decode steps agree within rtol = atol =
1e-4. The full configs' tables (parameters, caches, fields) equal JAX's.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenStream as JaxTokenStream
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data.tokens import TokenStream, synthetic_batch
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import placement, registry
from repro_torch.models.common import (SMOKE_SHAPES, cast_params,
                                       rules_for_mesh)
from repro_torch.utils import tree_bytes, tree_param_count

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
SMOKE_ARCHS = ("qwen1.5-0.5b", "granite-3-2b", "internvl2-76b")
FULL_DECODERS = ("qwen1.5-0.5b", "granite-3-2b", "yi-34b", "llama3-405b",
                 "internvl2-76b")
B, T0, STEPS = 2, 6, 3


def carried(arch: str, **overrides):
    """(JAX cfg, bundle, params; port cfg, bundle, params) from one set of
    JAX weights."""
    jcfg = jreg.smoke_config(jax_get_config(arch)).replace(
        **{k: getattr(jnp, v) if isinstance(v, str) else v
           for k, v in overrides.items()})
    jb = jreg.get_bundle(jcfg)
    arrays = jax.device_get(jb.init(jax.random.key(0)))
    # the norms' gains (init ones) and the QKV biases (init zeros) get
    # values of their own, so the products and sums with them are held
    rng = np.random.default_rng(0)
    for k, v in arrays.items():
        if "norm" in k or "/ln" in k or "/b" in k:
            base = 1.0 if "norm" in k or "/ln" in k else 0.0
            arrays[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    cfg = registry.smoke_config(get_config(arch)).replace(
        **{k: getattr(torch, v) if isinstance(v, str) else v
           for k, v in overrides.items()})
    tb = registry.get_bundle(cfg)
    tp = lm_params_from_numpy(arrays, cfg, device="cpu")
    return jcfg, jb, jp, cfg, tb, tp


@pytest.fixture(scope="module", params=SMOKE_ARCHS)
def pair(request):
    return carried(request.param)


def inputs(cfg, seed=0, steps=STEPS):
    """Tokens (B, T0 + steps) and, for vlm, an image prefix, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (B, T0 + steps)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = (0.1 * rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model))).astype(np.float32)
    return toks, img


def jbatch(toks, img, **extra):
    out = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v)
                                           for k, v in extra.items()}}
    if img is not None:
        out["img_embeds"] = jnp.asarray(img)
    return out


def tbatch(toks, img, **extra):
    out = {"tokens": torch.from_numpy(toks),
           **{k: torch.from_numpy(v) for k, v in extra.items()}}
    if img is not None:
        out["img_embeds"] = torch.from_numpy(img)
    return out


def close(port, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), err_msg=msg, **tol)


def test_forward_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, img = inputs(cfg)
    ref, _ = jb.forward(jp, jbatch(toks, img))
    logits, aux = tb.forward(tp, tbatch(toks, img))
    assert logits.shape == ref.shape and float(aux) == 0.0
    close(logits, ref)


def test_loss_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, img = inputs(cfg, seed=1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1                       # masked positions
    ref, rm = jb.loss(jp, jbatch(toks, img, labels=labels))
    loss, m = tb.loss(tp, tbatch(toks, img, labels=labels))
    close(loss, ref)
    close(m["ce"], rm["ce"])


def test_prefill_and_decode_match_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, img = inputs(cfg, seed=2)
    off = cfg.n_img_tokens if cfg.family == "vlm" else 0
    max_len = off + T0 + STEPS
    jcache, jl = jb.prefill(jp, jbatch(toks[:, :T0], img), max_len=max_len)
    cache, logits = tb.prefill(tp, tbatch(toks[:, :T0], img), max_len=max_len)
    close(logits, jl)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        close(cache[name], jcache[name], msg=name)
    assert cache["length"].tolist() == np.asarray(jcache["length"]).tolist()
    for j in range(STEPS):
        tok = toks[:, T0 + j:T0 + j + 1]
        jcache, jl = jb.decode_step(jp, jcache, jnp.asarray(tok))
        cache, logits = tb.decode_step(tp, cache, torch.from_numpy(tok))
        close(logits, jl, msg=f"decode step {j}")
    for name in ("k", "v"):
        close(cache[name], jcache[name], msg=name)
    assert cache["length"].tolist() == np.asarray(jcache["length"]).tolist()


def test_decode_step_updates_the_given_cache_in_place(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    cache = tb.init_cache(2, 8, device="cpu")
    before = cache["k"].clone()
    new, logits = tb.decode_step(tp, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert new["k"] is cache["k"] and new["v"] is cache["v"]
    assert not torch.equal(cache["k"], before)          # written in place
    assert cache["length"].tolist() == [0, 0] and new["length"].tolist() == [1, 1]
    assert logits.shape == (2, cfg.vocab)


def test_prefill_decode_matches_forward(pair):
    """The port alone: prefill + decode reproduce the teacher-forced
    forward logits within 2e-3 (``tests/test_models_smoke.py``'s check)."""
    jcfg, jb, jp, cfg, tb, tp = pair
    toks, img = inputs(cfg, seed=3)
    off = cfg.n_img_tokens if cfg.family == "vlm" else 0
    cache, logits = tb.prefill(tp, tbatch(toks[:, :T0], img),
                               max_len=off + T0 + STEPS)
    ref, _ = tb.forward(tp, tbatch(toks, img))
    torch.testing.assert_close(logits, ref[:, off + T0 - 1], rtol=2e-3, atol=2e-3)
    for j in range(STEPS):
        cache, logits = tb.decode_step(
            tp, cache, torch.from_numpy(toks[:, T0 + j:T0 + j + 1]))
        torch.testing.assert_close(logits, ref[:, off + T0 + j], rtol=2e-3,
                                   atol=2e-3, msg=f"decode step {j}")


# The full configs' dtypes (f32 parameters, bf16 compute) at smoke size.
# The port rounds to bf16 after every op, as the JAX program is written;
# XLA keeps f32 between the elementwise ops it fuses (its
# ``xla_allow_excess_precision``, on by default) and orders the f32 sums
# of each product its own way. A logit can therefore land a few bf16 ulps
# from JAX's. Bound: 16 ulps, |port - jax| <= 2^-3 * max(|jax|, 1) (an
# ulp being 2^-7 relative); measured: at most 7 over qwen,
# granite and internvl at four input seeds each, where JAX's own bf16
# logits lay 0.037-0.091 from its f32 logits. The greedy token must agree
# wherever JAX's top-2 margin exceeds the bound.
def bf16_bound(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** -3 * np.maximum(np.abs(ref), 1.0)


def assert_bf16_close(got, ref, msg=""):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    over = np.abs(got - ref) - bf16_bound(ref)
    assert over.max() <= 0, f"{msg}: {over.max()} over the bound"
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > bf16_bound(top2[..., 1])
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  ref.argmax(-1)[clear], err_msg=msg)
    return clear


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
def test_bf16_compute_matches_jax(arch):
    jcfg, jb, jp, cfg, tb, tp = carried(arch, compute_dtype="bfloat16")
    assert cfg.compute_dtype == torch.bfloat16
    toks, img = inputs(cfg, seed=4)
    ref, _ = jb.forward(jp, jbatch(toks, img))
    logits, _ = tb.forward(tp, tbatch(toks, img))
    assert logits.dtype == torch.bfloat16
    clear = assert_bf16_close(logits, ref, "forward")
    assert clear.mean() >= 0.25        # the token check holds on many rows

    jcache, jl = jb.prefill(jp, jbatch(toks[:, :T0], img), max_len=T0 + STEPS)
    cache, tl = tb.prefill(tp, tbatch(toks[:, :T0], img), max_len=T0 + STEPS)
    assert_bf16_close(tl, jl, "prefill")
    for j in range(STEPS):
        tok = toks[:, T0 + j:T0 + j + 1]
        jcache, jl = jb.decode_step(jp, jcache, jnp.asarray(tok))
        cache, tl = tb.decode_step(tp, cache, torch.from_numpy(tok))
        assert_bf16_close(tl, jl, f"decode step {j}")


def test_cast_params_returns_a_tree_already_in_dtype_as_it_is(pair):
    *_, cfg, tb, tp = pair
    same = cast_params(tp, torch.float32)
    assert all(same[k] is tp[k] for k in tp)
    half = cast_params(tp, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())
    assert all(cast_params(half, torch.bfloat16)[k] is half[k] for k in half)


# ---------------------------------------------------------------------------
# tables at the published widths (meta tensors: nothing allocated)


def _table(tree):
    return {k: (tuple(v.shape), jnp.dtype(v.dtype).name if not isinstance(
        v, torch.Tensor) else str(v.dtype).removeprefix("torch."))
        for k, v in tree.items()}


@pytest.mark.parametrize("arch", FULL_DECODERS)
def test_full_width_param_and_cache_tables_match_jax(arch):
    jb = jreg.get_bundle(jax_get_config(arch))
    tb = registry.get_bundle(get_config(arch))
    shapes = tb.param_shapes()
    assert all(v.device.type == "meta" for v in shapes.values())
    assert _table(shapes) == _table(jb.param_shapes())
    assert _table(tb.cache_shapes(8, 256)) == _table(jb.cache_shapes(8, 256))
    assert tree_param_count(shapes) == sum(
        int(np.prod(v.shape)) for v in jb.param_shapes().values())


def test_qwen_full_width_sizes():
    """Qwen1.5-0.5B at full width: 0.620 B parameters, 2.48 GB in f32,
    a 201 MB KV cache at B = 8, T = 256."""
    tb = registry.get_bundle(get_config("qwen1.5-0.5b"))
    shapes = tb.param_shapes()
    assert round(tree_param_count(shapes) / 1e9, 3) == 0.620
    assert round(tree_bytes(shapes) / 1e9, 2) == 2.48
    assert round(tree_bytes(tb.cache_shapes(8, 256)) / 1e6) == 201


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-76b"])
def test_input_specs_match_jax(arch, kind):
    jb = jreg.get_bundle(jreg.smoke_config(jax_get_config(arch)))
    tb = registry.get_bundle(registry.smoke_config(get_config(arch)))
    shape = SMOKE_SHAPES[kind]
    js, ts = jb.input_specs(shape), tb.input_specs(shape)
    if kind == "decode_32k":
        assert _table(ts.pop("cache")) == _table(js.pop("cache"))
    assert _table(ts) == _table(js)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.dtype):
            v = str(v).removeprefix("torch.")
        elif f.name in ("param_dtype", "compute_dtype"):
            v = jnp.dtype(v).name
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    assert ARCHS == JAX_ARCHS
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert _fields(cfg) == _fields(jcfg)
    assert _fields(registry.smoke_config(cfg)) == _fields(
        jreg.smoke_config(jcfg))
    alias = jcfg.name
    assert _fields(get_config(alias)) == _fields(jax_get_config(alias))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_the_other_families_build_with_jax_tables(arch):
    """The SSM, hybrid and enc-dec families build at smoke size and at
    full width, where their parameter table equals JAX's."""
    tb = registry.get_bundle(registry.smoke_config(get_config(arch)))
    assert tb.can_decode and sorted(tb.init(0, device="cpu")) == sorted(
        tb.param_shapes())
    full = registry.get_bundle(get_config(arch)).param_shapes()
    jb = jreg.get_bundle(jax_get_config(arch))
    assert _table(full) == _table(jb.param_shapes())
    assert tree_param_count(full) == sum(
        int(np.prod(v.shape)) for v in jb.param_shapes().values())


def test_mesh_and_param_specs_raise(pair):
    """A mesh that is no ``LMMesh`` raises ``TypeError``; the parameters'
    specs are JAX's; on a 1 x 1 ``LMMesh`` (whose collectives are the
    identity) the forward from ``shard_params`` equals the unmeshed one."""
    jcfg, jb, _, cfg, tb, tp = pair
    toks, img = inputs(cfg)
    with pytest.raises(TypeError, match="LMMesh"):
        tb.forward(tp, tbatch(toks, img), mesh=object())
    shape = SimpleNamespace(axis_names=("data", "model"),
                            devices=np.empty((16, 16)))
    specs = tb.param_specs(rules_for_mesh(shape))
    assert {k: tuple(v) for k, v in specs.items()} == {
        k: tuple(v) for k, v in jb.param_specs(
            jcommon.rules_for_mesh(shape)).items()}
    mesh = LMMesh(("data", "model"), {"data": 1, "model": 1},
                  {"data": 0, "model": 0}, {})
    sharded = placement.shard_params(tp, tb.param_specs(rules_for_mesh(mesh)),
                                     mesh)
    want, _ = tb.forward(tp, tbatch(toks, img))
    got, _ = tb.forward(sharded, tbatch(toks, img), mesh=mesh)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_params_round_trip_through_numpy(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    back = lm_params_to_numpy(tp)
    assert sorted(back) == sorted(jp)
    for k in back:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))
    bf = lm_params_from_numpy(back, cfg.replace(param_dtype=torch.bfloat16),
                              device="cpu")
    for k in back:
        np.testing.assert_array_equal(
            lm_params_to_numpy({k: bf[k]})[k],
            np.asarray(jnp.asarray(jp[k]).astype(jnp.bfloat16), np.float32))


def test_init_draws_from_its_seed():
    tb = registry.get_bundle(registry.smoke_config(get_config("qwen1.5-0.5b")))
    a, b = tb.init(3, device="cpu"), tb.init(3, device="cpu")
    c = tb.init(torch.Generator().manual_seed(4), device="cpu")
    assert sorted(a) == sorted(tb.param_shapes())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/wq"], c["layers/wq"])
    assert torch.equal(a["layers/ln1"], torch.ones_like(a["layers/ln1"]))
    assert torch.equal(a["layers/bq"], torch.zeros_like(a["layers/bq"]))
    # JAX's scales: 0.02 for the embedding, 1/sqrt(fan_in) elsewhere
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert abs(float(a["layers/w_down"].std()) - 128 ** -0.5) < 1e-2


# ---------------------------------------------------------------------------
# the token pipeline


def test_token_stream_table_is_jax_bitwise():
    for seed in (0, 5):
        a = TokenStream(256, 16, 4, seed=seed, device="cpu")._table()
        b = JaxTokenStream(256, 16, 4, seed=seed)._table()
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_token_stream_batch_is_a_pure_function_of_seed_and_step():
    s = TokenStream(256, 32, 4, seed=1, device="cpu")
    b0, b0again, b1 = s.batch(0), s.batch(0), s.batch(1)
    assert torch.equal(b0["tokens"], b0again["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert not torch.equal(b0["tokens"],
                           TokenStream(256, 32, 4, seed=2,
                                       device="cpu").batch(0)["tokens"])
    for b in (b0, b1):
        assert b["tokens"].shape == b["labels"].shape == (4, 32)
        assert b["tokens"].dtype == torch.int32
        assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < 64
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_token_stream_follows_its_chain():
    """Transitions drawn follow the table: the empirical next-state
    frequencies of the most visited state match its row."""
    s = TokenStream(256, 512, 16, seed=0, device="cpu")
    b = s.batch(0)
    x, y = b["tokens"].flatten().numpy(), b["labels"].flatten().numpy()
    state = np.bincount(x).argmax()
    counts = np.bincount(y[x == state], minlength=s.n_states)
    p = s._table()[state]
    n = counts.sum()
    assert np.abs(counts / n - p).max() < 4 * np.sqrt(p.max() / n) + 1e-3


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-76b"])
def test_synthetic_batch_matches_input_specs(arch):
    cfg = registry.smoke_config(get_config(arch))
    tb = registry.get_bundle(cfg)
    shape = SMOKE_SHAPES["train_4k"]
    batch = synthetic_batch(cfg, shape, step=0, seed=0, device="cpu")
    assert _table(batch) == _table(tb.input_specs(shape))
    loss, _ = tb.loss(tb.init(0, device="cpu"), batch)
    assert torch.isfinite(loss) and float(loss) > 0


def test_timing_and_tree_helpers():
    from repro_torch.utils import span, summary, timed, tracing
    from repro_torch.utils.timing import clear, spans
    clear()
    with tracing(True):
        for _ in range(3):
            with span("a"):
                with span("b"):
                    pass
    with span("a"):                      # off again: not recorded
        pass
    log, text = spans(), summary()
    clear()
    assert [x[0] for x in log] == ["b", "a"] * 3
    assert [x[3] for x in log] == [1, 0] * 3
    rows = {r.split()[0]: r.split() for r in text.splitlines()[1:]}
    assert set(rows) == {"a", "b"} and rows["a"][-1] == "3"
    assert 0 <= float(rows["a"][2]) <= float(rows["a"][1])
    out, sec = timed(lambda x: {"y": [x * 2]}, torch.ones(3), n=2)
    assert torch.equal(out["y"][0], torch.full((3,), 2.0)) and sec >= 0
    tree = {"a": torch.zeros(2, 3), "b": [torch.zeros(4, dtype=torch.bfloat16),
                                          (torch.empty(5, device="meta"),)]}
    assert tree_param_count(tree) == 6 + 4 + 5
    assert tree_bytes(tree) == 6 * 4 + 4 * 2 + 5 * 4
