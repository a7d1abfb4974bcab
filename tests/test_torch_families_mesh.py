"""The SSM, hybrid and enc-dec families on a mesh, on the CPU (gloo),
against the JAX package's on the same host mesh.

One JAX subprocess on 4 host devices (``run_with_devices``) and one world
of 4 gloo ranks (``run_world``, whose rank functions live here and import
no JAX) start from the same JAX weights, for each of the smoke
``mamba2-2.7b``, ``zamba2-2.7b`` and ``whisper-medium`` on (data 2,
model 2):

* prefill of a two-chunk prompt and four decode steps through
  ``build_prefill_step`` / ``build_decode_step`` under the decode
  deployment (the SSD state split on heads, the conv tail on channels,
  the K/V on positions and the cross K/V on kv heads over ``model``),
  logits within 1e-5 of JAX's steps and of the port without a mesh, the
  gathered cache within 1e-5 of JAX's and of the unsharded one;
* the train step under the cell's deployment (``train_4k``: tp none):
  the loss within 1e-6 relative and the gathered gradients within 1e-5
  of JAX's;
* ``ServeEngine(mesh=)``: greedy tokens equal to the unmeshed engine's,
  alike on every rank;
* the hybrid's ``flash_decode`` with a fully masked seq shard (a prompt
  that ends in the first shard);
* a ``max_len`` that ``model`` does not divide: the K/V families raise
  ``ValueError``; the SSM, whose cache has no sequence axis, decodes as
  without a mesh;
* the SSM decode step from a state held whole on every rank while the
  conv tail is split on channels: ``hx`` gathered, within 1e-5.
"""
from __future__ import annotations

import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.gson.distributed import run_world
from repro_torch.models import registry

torch.set_num_threads(1)

WORLD = 4
ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium")
# a prompt of two SSD chunks (16 at smoke size), a cache whose seq shards
# over model = 2 are 24 positions; the masked case's prompt ends in the
# first shard
PROMPT, MAX_LEN, DECODE, SHORT = 32, 48, 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)

JAX_CODE = """
import os
# one thread per op: the subprocess runs beside the other test workers
os.environ["XLA_FLAGS"] += (" --xla_cpu_multi_thread_eigen=false"
                            " intra_op_parallelism_threads=1")
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_debug_mesh
from repro.launch import steps
from repro.configs import get_config
from repro.models.common import SMOKE_SHAPES, ShapeCfg
from repro.models.registry import get_bundle, smoke_config
from repro.data.tokens import synthetic_batch
from repro.training.trainer import _accumulate, _grad_fn

out = {}
mesh = make_debug_mesh((2, 2), ("data", "model"))
shape = SMOKE_SHAPES["train_4k"]


def save(prefix, tree):
    for k, v in tree.items():
        out[prefix + k] = np.asarray(v)


def serve(b, params, rules, dep, batch, plen, tag):
    with jax.set_mesh(mesh):
        pstep, _ = steps.build_prefill_step(
            b, mesh, rules, ShapeCfg("p", MAX_LEN, 4, "prefill"), dep)
        dstep, _ = steps.build_decode_step(
            b, mesh, rules, ShapeCfg("d", MAX_LEN, 4, "decode"), dep)
        pb = dict(batch, tokens=jnp.asarray(toks[:, :plen]))
        cache, logits = pstep(params, pb)
        outs = [np.asarray(logits)]
        for j in range(DECODE):
            at = plen + j
            cache, logits = dstep(params, cache,
                                  jnp.asarray(toks[:, at:at + 1]))
            outs.append(np.asarray(logits))
    out[tag + "logits"] = np.stack(outs)
    save(tag + "cache/", cache)


for i, arch in enumerate(ARCHS):
    cfg = smoke_config(get_config(arch))
    b = get_bundle(cfg)
    params = b.init(jax.random.key(11 + i))
    save(arch + "/p0/", params)
    rng = np.random.default_rng(20 + i)
    toks = rng.integers(2, cfg.vocab, (4, PROMPT + DECODE)).astype(np.int32)
    out[arch + "/tokens"] = toks
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = (0.5 * rng.standard_normal(
            (4, cfg.encoder_ctx, cfg.d_model))).astype(np.float32)
        out[arch + "/frames"] = extra["frames"]
    dep = steps.deploy_for(arch, "decode_32k")
    rules = steps.rules_for_deploy(mesh, dep)
    serve(b, params, rules, dep, extra, PROMPT, arch + "/dec/")
    if cfg.family == "hybrid":
        serve(b, params, rules, dep, extra, SHORT, arch + "/masked/")

    dep = steps.resolve_deploy(steps.deploy_for(arch, "train_4k"), shape, mesh)
    rules = steps.rules_for_deploy(mesh, dep)
    batch = synthetic_batch(cfg, shape, 0)
    save(arch + "/batch/", batch)
    with jax.set_mesh(mesh):
        acc = "bf16" == dep.accum_dtype
        loss, _, g = jax.jit(lambda p, bt: _accumulate(
            _grad_fn(b, mesh), p, bt, dep.microbatches,
            jnp.bfloat16 if acc else jnp.float32))(params, batch)
    save(arch + "/g/", g)
    out[arch + "/loss"] = np.asarray(loss)
    out[arch + "/mb"] = np.asarray(dep.microbatches)
np.savez(PATH, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jx(devices8, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("families_mesh") / "jax.npz")
    code = (f"PATH = {path!r}\nARCHS = {ARCHS!r}\n"
            f"PROMPT, MAX_LEN, DECODE, SHORT = {PROMPT}, {MAX_LEN}, "
            f"{DECODE}, {SHORT}\n" + textwrap.dedent(JAX_CODE))
    assert "OK" in devices8(code, n_devices=WORLD, timeout=560)
    return dict(np.load(path))


def tree(jx: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in jx.items() if k.startswith(prefix)}


def smoke_bundle(arch: str):
    return registry.get_bundle(registry.smoke_config(get_config(arch)))


def _requests(vocab: int):
    rng = np.random.default_rng(11)
    return [rng.integers(2, vocab, size=int(rng.integers(3, 9)))
            for _ in range(6)]


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:  # noqa: PERF203
        return f"{type(e).__name__}: {e}"
    return "no error"


def serve_steps(b, params, mesh, jx, arch, plen):
    """Prefill of ``plen`` tokens and ``DECODE`` steps through the step
    factories under the decode deployment (``mesh=None``: one device):
    (logits (steps + 1, rows, V), the cache after them)."""
    from repro_torch.launch import steps
    from repro_torch.models.common import ShapeCfg
    dep = steps.deploy_for(arch, "decode_32k")
    rules = steps.rules_for_deploy(mesh, dep) if mesh is not None else None
    pstep, _ = steps.build_prefill_step(
        b, mesh, rules, ShapeCfg("p", MAX_LEN, 4, "prefill"), dep)
    dstep, _ = steps.build_decode_step(
        b, mesh, rules, ShapeCfg("d", MAX_LEN, 4, "decode"), dep)
    toks = torch.from_numpy(jx[arch + "/tokens"])
    batch = {"tokens": toks[:, :plen]}
    if arch + "/frames" in jx:
        batch["frames"] = torch.from_numpy(jx[arch + "/frames"])
    cache, logits = pstep(params, batch)
    outs = [logits]
    for j in range(DECODE):
        at = plen + j
        cache, logits = dstep(params, cache, toks[:, at:at + 1])
        outs.append(logits)
    return torch.stack(outs).numpy(), cache


def engine_tokens(b, params, mesh=None):
    from repro_torch.serving import ServeConfig, ServeEngine
    eng = ServeEngine(b, params, ServeConfig(batch=4, max_len=32), mesh=mesh)
    for i, p in enumerate(_requests(b.cfg.vocab)):
        eng.submit(p, rid=i, max_tokens=5)
    return (sorted((r.rid, list(r.out)) for r in eng.run()), eng.prefills,
            eng.decode_steps)


# ---------------------------------------------------------------------------
# the world


def _world(rank, jx):
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import placement
    from repro_torch.models.common import SMOKE_SHAPES
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import trainer
    torch.set_num_threads(1)
    out = {}
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    shape = SMOKE_SHAPES["train_4k"]

    def whole(x):
        return {k: v.numpy() for k, v in placement.gather_params(x).items()}

    for arch in ARCHS:
        b = smoke_bundle(arch)
        full = convert.lm_params_from_numpy(tree(jx, arch + "/p0/"), b.cfg,
                                            "cpu")
        dep = steps.deploy_for(arch, "decode_32k")
        rules = steps.rules_for_deploy(mesh, dep)
        params = placement.shard_params(full, b.param_specs(rules), mesh)
        logits, cache = serve_steps(b, params, mesh, jx, arch, PROMPT)
        out[arch + "/dec"] = (mesh.index("data"), logits, whole(cache),
                              {k: tuple(v.shape) for k, v in cache.items()})
        if b.cfg.family == "hybrid":
            logits, cache = serve_steps(b, params, mesh, jx, arch, SHORT)
            out[arch + "/masked"] = (logits, whole(cache))
        out[arch + "/engine"] = engine_tokens(b, params, mesh)
        if b.cfg.family == "ssm":
            out[arch + "/hx_split"] = _hx_split(b, full, params, mesh, jx)

        # a max_len that model = 2 does not divide
        cache = placement.shard_cache(
            b.init_cache(4, 5, device="cpu"),
            steps.cache_specs(b.cfg, b.cache_shapes(4, 5), mesh, 4), mesh)
        tok = torch.full((4, 1), 3, dtype=torch.int32)
        if "k" in cache:
            out[arch + "/odd"] = _raises(
                lambda: b.decode_step(params, cache, tok, mesh=mesh),
                ValueError)
        else:
            out[arch + "/odd"] = b.decode_step(params, cache, tok,
                                               mesh=mesh)[1].numpy()

        dep = steps.resolve_deploy(steps.deploy_for(arch, "train_4k"), shape,
                                   mesh)
        rules = steps.rules_for_deploy(mesh, dep)
        params = placement.shard_params(full, b.param_specs(rules), mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in tree(jx, arch + "/batch/").items()}
        acc = torch.bfloat16 if dep.accum_dtype == "bf16" else torch.float32
        loss, _, g = trainer._accumulate(trainer.grad_fn(b, mesh), params,
                                         batch, dep.microbatches, acc)
        grads = placement.gather_params(g, params.specs, mesh)
        step, _, tcfg = steps.build_train_step(b, mesh, rules, dep)
        _, _, m = step(params, opt_lib.init_opt_state(tcfg.opt, params),
                       batch)
        out[arch + "/train"] = (float(loss), float(m["loss"]),
                                dep.microbatches,
                                {k: v.numpy() for k, v in grads.items()})
    return out


def _hx_split(b, full, params, mesh, jx):
    """A decode step from a cache whose SSD state is whole on each rank
    while ``hx`` is split on channels over ``model`` (what ``cache_specs``
    gives when ``model`` divides d_inner but not the heads): the rank
    gathers ``hx`` and runs every head. Its rows' largest distance from
    the unmeshed step."""
    from repro_torch.launch import steps
    from repro_torch.models import placement
    from repro_torch.models.common import P
    toks = torch.from_numpy(jx["mamba2-2.7b/tokens"])
    cache, _ = b.prefill(full, {"tokens": toks[:, :PROMPT]}, max_len=MAX_LEN)
    specs = steps.cache_specs(b.cfg, cache, mesh, 4)
    specs["ssm"] = P(None, specs["ssm"][1], None, None, None)
    sharded = placement.shard_cache(cache, specs, mesh)
    tok = toks[:, PROMPT:PROMPT + 1]
    got = b.decode_step(params, sharded, tok, mesh=mesh)[1]
    want = b.decode_step(full, cache, tok)[1]
    d = mesh.index("data")
    return float((got - want[2 * d:2 * d + 2]).abs().max())


@pytest.fixture(scope="module")
def world(jx):
    return run_world(_world, WORLD, (jx,), timeout_s=400)


@pytest.fixture(scope="module")
def unmeshed(jx):
    """The port without a mesh, from the same weights: the serving
    steps' logits and cache, the masked case's, the engine's tokens, the
    odd max_len's logits."""
    from repro_torch import convert
    out = {}
    for arch in ARCHS:
        b = smoke_bundle(arch)
        params = convert.lm_params_from_numpy(tree(jx, arch + "/p0/"),
                                              b.cfg, "cpu")
        logits, cache = serve_steps(b, params, None, jx, arch, PROMPT)
        out[arch + "/dec"] = (logits, {k: v.numpy() for k, v in
                                       cache.items()})
        if b.cfg.family == "hybrid":
            logits, cache = serve_steps(b, params, None, jx, arch, SHORT)
            out[arch + "/masked"] = (logits, {k: v.numpy() for k, v in
                                              cache.items()})
        out[arch + "/engine"] = engine_tokens(b, params)
        tok = torch.full((4, 1), 3, dtype=torch.int32)
        out[arch + "/odd"] = b.decode_step(
            params, b.init_cache(4, 5, device="cpu"), tok)[1].numpy()
    return out


# ---------------------------------------------------------------------------
# prefill, decode and the cache


def assert_rows(got, want, d, ctx):
    np.testing.assert_allclose(got, want[:, 2 * d:2 * d + 2], **TOL,
                               err_msg=ctx)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_jax(jx, world, unmeshed, arch):
    want_jax = jx[arch + "/dec/logits"]
    want_port = unmeshed[arch + "/dec"][0]
    for rank in range(WORLD):
        d, got, _, shapes = world[rank][arch + "/dec"]
        assert np.all(np.isfinite(got))
        assert_rows(got, want_jax, d, (arch, rank, "jax"))
        assert_rows(got, want_port, d, (arch, rank, "unmeshed"))
        # the blocks cache_specs gives: heads, channels, positions and
        # kv heads over model = 2, rows over data = 2
        cfg = smoke_bundle(arch).cfg
        if "ssm" in shapes:
            assert shapes["ssm"][1:3] == (2, cfg.ssm_heads // 2)
            assert shapes["hx"][1::2] == (2, cfg.d_inner // 2)
        if "k" in shapes:
            assert shapes["k"][1:3] == (2, MAX_LEN // 2)
        if "ck" in shapes:
            assert shapes["ck"][1:4:2] == (2, cfg.n_kv // 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gathered_cache_equals_unsharded(jx, world, unmeshed, arch):
    want_jax = tree(jx, arch + "/dec/cache/")
    want_port = unmeshed[arch + "/dec"][1]
    for rank in range(WORLD):
        got = world[rank][arch + "/dec"][2]
        assert sorted(got) == sorted(want_port) == sorted(want_jax)
        for k in got:
            if k == "length":
                np.testing.assert_array_equal(got[k], want_port[k])
                continue
            np.testing.assert_allclose(got[k], want_port[k], **TOL,
                                       err_msg=(arch, rank, k))
            np.testing.assert_allclose(got[k], want_jax[k], **TOL,
                                       err_msg=(arch, rank, k, "jax"))


def test_hybrid_flash_decode_with_a_masked_shard(jx, world, unmeshed):
    """A prompt of ``SHORT`` tokens plus ``DECODE`` steps never reaches
    the second seq shard (positions 24-47): its ranks' partial softmax
    is all masked and weighs nothing in the merge."""
    arch = "zamba2-2.7b"
    want_jax = jx[arch + "/masked/logits"]
    want_port, cache_port = unmeshed[arch + "/masked"]
    assert SHORT + DECODE <= MAX_LEN // 2
    for rank in range(WORLD):
        d = world[rank][arch + "/dec"][0]
        got, cache = world[rank][arch + "/masked"]
        assert np.all(np.isfinite(got))
        assert_rows(got, want_jax, d, (rank, "jax"))
        assert_rows(got, want_port, d, (rank, "unmeshed"))
        assert not np.any(cache["k"][:, :, MAX_LEN // 2:])
        np.testing.assert_allclose(cache["k"], cache_port["k"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_max_len_the_model_axis_does_not_divide(world, unmeshed, arch):
    for rank in range(WORLD):
        got = world[rank][arch + "/odd"]
        if arch == "mamba2-2.7b":   # no sequence axis: decodes as unmeshed
            d = world[rank][arch + "/dec"][0]
            assert_rows(got[None], unmeshed[arch + "/odd"][None], d,
                        (arch, rank))
        else:
            assert got.startswith("ValueError") and \
                "divisible by the model axis" in got, got


def test_ssm_decode_gathers_hx_where_the_heads_are_whole(world):
    for rank in range(WORLD):
        assert world[rank]["mamba2-2.7b/hx_split"] <= 1e-5, rank


# ---------------------------------------------------------------------------
# the train step and the engine


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_jax(jx, world, arch):
    want = tree(jx, arch + "/g/")
    for rank in range(WORLD):
        loss, step_loss, mb, grads = world[rank][arch + "/train"]
        assert mb == int(jx[arch + "/mb"])
        assert loss == pytest.approx(float(jx[arch + "/loss"]), rel=1e-6)
        assert step_loss == pytest.approx(loss, rel=1e-6)
        assert sorted(grads) == sorted(want)
        for k in want:
            np.testing.assert_allclose(grads[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=(arch, rank, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_engine_equals_unmeshed(world, unmeshed, arch):
    want = unmeshed[arch + "/engine"]
    assert want[1] == 2
    for rank in range(WORLD):
        assert world[rank][arch + "/engine"] == want, (arch, rank)
