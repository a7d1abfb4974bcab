"""The LM's train, pod-manual, prefill and decode steps and the meshed
``ServeEngine`` on the CPU (gloo), against the JAX package's on the same
host meshes.

One JAX subprocess on 4 host devices (``run_with_devices``) and one world
of 4 gloo ranks (``run_world``, whose rank functions live here and import
no JAX) start from the same JAX weights:

* ``build_train_step`` with the cell's deployment on (data 2, model 2)
  for qwen1.5-0.5b (tp none, one sequence per rank) and qwen2-moe-a2.7b
  (two microbatches, the MoE through expert parallelism, as JAX's);
* the pod-manual step (``compress_pods`` and ``straggler_masking``, health
  [1.0, 0.5]) on (pod 2, data 1, model 2) for granite-3-2b (JAX's
  parameter specs name ``data``, so its step needs that axis, of size 1);
* prefill and four decode steps on (data 2, model 2) through
  ``build_prefill_step`` / ``build_decode_step`` (the cache seq-sharded
  over ``model``, flash decode), logits within 1e-5 of JAX's;
* ``ServeEngine(mesh=)``: greedy tokens equal the port's unmeshed
  engine's, and alike on every rank.

Tolerances: the loss within 1e-6 relative; the parameters under the rule
of ``test_torch_training.py`` (within 1e-5 wherever |g| exceeds the
gradient tolerance, within 2 lr + 1e-6 elsewhere: AdamW's first step
moves a parameter by about lr sign(g)); ``ef`` (pod 0's: JAX's step
returns the pods' residuals as one replicated value, which reads as pod
0's) within 1e-6, or 2e-6 of the leaf's largest gradient where that is
larger (the gradients' own float noise), except where a quantization
flips: where g / scale lies within float noise of a half-integer, the two
packages may round it to neighbouring integers, and ``ef`` then differs
by one quantum there (asserted: those elements are few, and each sits at
a rounding boundary).
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
LR = 3e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_ARCHS = ("qwen1.5-0.5b", "qwen2-moe-a2.7b")
PROMPT, MAX_LEN, DECODE = 8, 16, 4

JAX_CODE = """
import os
# one thread per op: the subprocess runs beside the other test workers
os.environ["XLA_FLAGS"] += (" --xla_cpu_multi_thread_eigen=false"
                            " intra_op_parallelism_threads=1")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_debug_mesh
from repro.launch import steps
from repro.configs import get_config
from repro.models.common import SMOKE_SHAPES, ShapeCfg, rules_for_mesh
from repro.models.registry import get_bundle, smoke_config
from repro.data.tokens import synthetic_batch
from repro.training import optimizer as opt_lib
from repro.training.compression import init_ef_state
from repro.training.trainer import _accumulate, _grad_fn

out = {}
mesh = make_debug_mesh((2, 2), ("data", "model"))
shape = SMOKE_SHAPES["train_4k"]


def save(prefix, tree):
    for k, v in tree.items():
        out[prefix + k] = np.asarray(v)


for i, arch in enumerate(TRAIN_ARCHS):
    cfg = smoke_config(get_config(arch))
    b = get_bundle(cfg)
    params = b.init(jax.random.key(1 + i))
    save(arch + "/p0/", params)
    dep = steps.resolve_deploy(steps.deploy_for(arch, "train_4k"), shape, mesh)
    rules = steps.rules_for_deploy(mesh, dep)
    batch = synthetic_batch(cfg, shape, 0)
    save(arch + "/batch/", batch)
    with jax.set_mesh(mesh):
        step, _, tcfg = steps.build_train_step(b, mesh, rules, dep)
        acc = "bf16" == dep.accum_dtype
        _, _, g = jax.jit(lambda p, bt: _accumulate(
            _grad_fn(b, mesh), p, bt, dep.microbatches,
            jnp.bfloat16 if acc else jnp.float32))(params, batch)
        specs = b.param_specs(rules)
        ospecs = opt_lib.match_opt_specs(tcfg.opt, b.param_shapes(), specs)
        opt = opt_lib.init_opt_state(tcfg.opt, params)
        put = lambda t, sp: {k: jax.device_put(v, NamedSharding(mesh, sp[k]))
                             for k, v in t.items()}
        opt = {"m": put(opt["m"], ospecs["m"]),
               "v": put(opt["v"], ospecs["v"]),
               "step": jax.device_put(opt["step"], NamedSharding(mesh, P()))}
        p2, o2, m = step(put(params, specs), opt, batch)
    save(arch + "/g/", g)
    save(arch + "/p1/", p2)
    out[arch + "/loss"] = np.asarray(m["loss"])
    out[arch + "/gnorm"] = np.asarray(m["gnorm"])
    out[arch + "/mb"] = np.asarray(dep.microbatches)

# the pod-manual step on (pod 2, data 1, model 2): JAX's param specs name
# 'data', which a (pod, model) mesh lacks
pmesh = make_debug_mesh((2, 1, 2), ("pod", "data", "model"))
cfg = smoke_config(get_config("granite-3-2b"))
b = get_bundle(cfg)
params = b.init(jax.random.key(5))
save("pod/p0/", params)
dep = steps.DeployCfg(microbatches=1, compress_pods=True,
                      straggler_masking=True)
batch = synthetic_batch(cfg, shape, 0)
save("pod/batch/", batch)
health = jnp.asarray([1.0, 0.5], jnp.float32)
with jax.set_mesh(pmesh):
    step, _, tcfg = steps.build_train_step(b, pmesh, rules_for_mesh(pmesh),
                                           dep)
    p2, o2, ef, m = step(params, opt_lib.init_opt_state(tcfg.opt, params),
                         batch, init_ef_state(params), health)
save("pod/p1/", p2)
save("pod/ef/", ef)
out["pod/loss"] = np.asarray(m["loss"])
# each pod's gradient on its rows, for the rounding boundaries
for pod in range(2):
    rows = {k: v[2 * pod:2 * pod + 2] for k, v in batch.items()}
    (_, _), g = jax.jit(jax.value_and_grad(b.loss, has_aux=True))(params, rows)
    save(f"pod/g{pod}/", g)

# prefill + decode on (data 2, model 2), the decode deployment's rules
cfg = smoke_config(get_config("qwen1.5-0.5b"))
b = get_bundle(cfg)
params = b.init(jax.random.key(7))
save("dec/p0/", params)
dep = steps.deploy_for("qwen1.5-0.5b", "decode_32k")
rules = steps.rules_for_deploy(mesh, dep)
rng = np.random.default_rng(3)
toks = rng.integers(2, cfg.vocab, (4, PROMPT + DECODE)).astype(np.int32)
out["dec/tokens"] = toks
with jax.set_mesh(mesh):
    pstep, _ = steps.build_prefill_step(
        b, mesh, rules, ShapeCfg("p", MAX_LEN, 4, "prefill"), dep)
    dstep, _ = steps.build_decode_step(
        b, mesh, rules, ShapeCfg("d", MAX_LEN, 4, "decode"), dep)
    cache, logits = pstep(params, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    outs = [np.asarray(logits)]
    for j in range(DECODE):
        at = PROMPT + j
        cache, logits = dstep(params, cache, jnp.asarray(toks[:, at:at + 1]))
        outs.append(np.asarray(logits))
out["dec/logits"] = np.stack(outs)
np.savez(PATH, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jx(devices8, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_mesh_train") / "jax.npz")
    code = (f"PATH = {path!r}\nTRAIN_ARCHS = {TRAIN_ARCHS!r}\n"
            f"PROMPT, MAX_LEN, DECODE = {PROMPT}, {MAX_LEN}, {DECODE}\n"
            + textwrap.dedent(JAX_CODE))
    assert "OK" in devices8(code, n_devices=WORLD, timeout=560)
    return dict(np.load(path))


def tree(jx: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in jx.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the world


def _requests(vocab: int):
    rng = np.random.default_rng(11)
    return [rng.integers(2, vocab, size=int(rng.integers(3, 9)))
            for _ in range(6)]


def _world(rank, jx):
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import placement
    from repro_torch.models.common import (SMOKE_SHAPES, ShapeCfg,
                                           rules_for_mesh)
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.compression import init_ef_state
    torch.set_num_threads(1)
    out = {}
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    pmesh = make_debug_mesh((2, 1, 2), ("pod", "data", "model"))
    shape = SMOKE_SHAPES["train_4k"]

    def batch_of(prefix):
        return {k: torch.from_numpy(v) for k, v in tree(jx, prefix).items()}

    for arch in TRAIN_ARCHS:
        cfg = registry.smoke_config(get_config(arch))
        b = registry.get_bundle(cfg)
        dep = steps.resolve_deploy(steps.deploy_for(arch, "train_4k"), shape,
                                   mesh)
        rules = steps.rules_for_deploy(mesh, dep)
        step, _, tcfg = steps.build_train_step(b, mesh, rules, dep)
        params = placement.shard_params(convert.lm_params_from_numpy(
            tree(jx, arch + "/p0/"), cfg, "cpu"), b.param_specs(rules), mesh)
        p2, _, m = step(params, opt_lib.init_opt_state(tcfg.opt, params),
                        batch_of(arch + "/batch/"))
        out[arch] = (float(m["loss"]), float(m["gnorm"]), dep.microbatches,
                     {k: v.numpy() for k, v in
                      placement.gather_params(p2).items()})

    out["adafactor"] = _adafactor_step(mesh, jx)

    cfg = registry.smoke_config(get_config("granite-3-2b"))
    b = registry.get_bundle(cfg)
    rules = rules_for_mesh(pmesh)
    dep = steps.DeployCfg(microbatches=1, compress_pods=True,
                          straggler_masking=True)
    step, _, tcfg = steps.build_train_step(b, pmesh, rules, dep)
    specs = b.param_specs(rules)
    params = placement.shard_params(convert.lm_params_from_numpy(
        tree(jx, "pod/p0/"), cfg, "cpu"), specs, pmesh)
    p2, _, ef, m = step(params, opt_lib.init_opt_state(tcfg.opt, params),
                        batch_of("pod/batch/"), init_ef_state(params),
                        torch.tensor([1.0, 0.5]))
    out["pod"] = (float(m["loss"]),
                  {k: v.numpy() for k, v in
                   placement.gather_params(p2).items()},
                  {k: v.numpy() for k, v in
                   placement.gather_params(ef, specs, pmesh).items()},
                  {k: bool(torch.isfinite(v).all()) for k, v in p2.items()})

    cfg = registry.smoke_config(get_config("qwen1.5-0.5b"))
    b = registry.get_bundle(cfg)
    dep = steps.deploy_for("qwen1.5-0.5b", "decode_32k")
    rules = steps.rules_for_deploy(mesh, dep)
    full = convert.lm_params_from_numpy(tree(jx, "dec/p0/"), cfg, "cpu")
    params = placement.shard_params(full, b.param_specs(rules), mesh)
    pstep, _ = steps.build_prefill_step(
        b, mesh, rules, ShapeCfg("p", MAX_LEN, 4, "prefill"), dep)
    dstep, (_, acache, _) = steps.build_decode_step(
        b, mesh, rules, ShapeCfg("d", MAX_LEN, 4, "decode"), dep)
    toks = torch.from_numpy(jx["dec/tokens"])
    cache, logits = pstep(params, {"tokens": toks[:, :PROMPT]})
    assert cache.specs == acache.specs and all(
        cache[k].shape == acache[k].shape for k in cache)
    outs = [logits]
    for j in range(DECODE):
        at = PROMPT + j
        cache, logits = dstep(params, cache, toks[:, at:at + 1])
        outs.append(logits)
    out["dec"] = (mesh.index("data"),
                  torch.stack(outs).numpy(), tuple(cache["k"].shape))

    eng = ServeEngine(b, params, ServeConfig(batch=4, max_len=32),
                      mesh=mesh)
    for i, p in enumerate(_requests(cfg.vocab)):
        eng.submit(p, rid=i, max_tokens=5)
    done = eng.run()
    out["engine"] = (sorted((r.rid, list(r.out)) for r in done),
                     eng.prefills, eng.decode_steps)
    return out


def _adafactor_step(mesh, jx, lr=1e-3):
    """One Adafactor step of the qwen1.5-0.5b smoke config (leaves of 16
    or more rows and columns factored, so that the factored moments' means
    run over sharded dimensions) on ``mesh``, or on one device without
    one; the parameters after it, whole."""
    from repro_torch import convert
    from repro_torch.launch.steps import rules_for_deploy, DeployCfg
    from repro_torch.models import placement
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.trainer import TrainConfig, make_train_step
    cfg = registry.smoke_config(get_config("qwen1.5-0.5b"))
    b = registry.get_bundle(cfg)
    params = convert.lm_params_from_numpy(tree(jx, "qwen1.5-0.5b/p0/"), cfg,
                                          "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in tree(jx, "qwen1.5-0.5b/batch/").items()}
    tcfg = TrainConfig(opt=opt_lib.OptConfig(name="adafactor", lr=lr,
                                             min_dim_factored=16))
    rules = None
    if mesh is not None:
        rules = rules_for_deploy(mesh, DeployCfg())
        params = placement.shard_params(params, b.param_specs(rules), mesh)
    p2, _, m = make_train_step(b, mesh, rules, tcfg)(
        params, opt_lib.init_opt_state(tcfg.opt, params), batch)
    whole = placement.gather_params(p2) if mesh is not None else p2
    return float(m["loss"]), {k: v.numpy() for k, v in whole.items()}


@pytest.fixture(scope="module")
def world(jx):
    return run_world(_world, WORLD, (jx,), timeout_s=400)


def assert_step_params(got: dict, want: dict, grads: dict, ctx):
    for k in want:
        g = np.abs(grads[k])
        clear = g > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * g.max()
        np.testing.assert_allclose(got[k][clear], want[k][clear], rtol=0,
                                   atol=1e-5, err_msg=f"{ctx} {k}")
        assert np.abs(got[k] - want[k]).max() <= 2 * LR + 1e-6, (ctx, k)


# ---------------------------------------------------------------------------
# the train steps


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_train_step_matches_jax(jx, world, arch):
    for rank in range(WORLD):
        loss, gnorm, mb, params = world[rank][arch]
        assert mb == int(jx[arch + "/mb"])
        assert loss == pytest.approx(float(jx[arch + "/loss"]), rel=1e-6)
        assert gnorm == pytest.approx(float(jx[arch + "/gnorm"]), rel=1e-5)
        assert_step_params(params, tree(jx, arch + "/p1/"),
                           tree(jx, arch + "/g/"), (arch, rank))


def test_mesh_adafactor_step_equals_unmeshed(jx, world):
    """Adafactor's factored moments and update RMS on (data 2, model 2),
    with leaves split along the reduced dimensions, against the port's
    step on one device: the loss within 1e-6, the parameters within 1e-5
    (the update is clipped to RMS 1: about lr per element)."""
    loss, want = _adafactor_step(None, jx)
    for rank in range(WORLD):
        got_loss, got = world[rank]["adafactor"]
        assert got_loss == pytest.approx(loss, rel=1e-6)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_pod_manual_step_matches_jax(jx, world):
    want_p, want_ef = tree(jx, "pod/p1/"), tree(jx, "pod/ef/")
    g0, g1 = tree(jx, "pod/g0/"), tree(jx, "pod/g1/")
    health = (1.0, 0.5)
    for rank in range(WORLD):
        loss, params, ef, finite = world[rank]["pod"]
        assert all(finite.values()), rank
        assert loss == pytest.approx(float(jx["pod/loss"]), rel=1e-6)
        # the pods' combined gradient, up to the quantization: its scale
        wsum = sum(health)
        grads = {k: (g0[k] * health[0] + g1[k] * health[1]) / wsum
                 for k in g0}
        assert_step_params(params, want_p, grads, ("pod", rank))
        if rank // 2:      # JAX reports the ef of pod 0 (its replica)
            continue
        flips = 0
        for k in want_ef:
            scale = max(np.abs(g0[k] * health[0]).max(),
                        np.abs(g1[k] * health[1]).max(), 1e-12) / 127.0
            # g's own noise, relative to the leaf's largest gradient
            noise = 2e-6 * max(np.abs(g0[k]).max(), np.abs(g1[k]).max())
            bad = np.abs(ef[k] - want_ef[k]) > max(noise, 1e-6)
            flips += int(bad.sum())
            frac = np.abs(g0[k] * health[0] / scale) % 1.0
            assert np.all(np.abs(frac[bad] - 0.5) < 1e-3), (k, rank)
            np.testing.assert_allclose(np.abs(ef[k] - want_ef[k])[bad],
                                       scale, rtol=1e-3)
        assert flips <= 8, flips
    # every rank of a pod holds the same parameters, all pods alike
    for rank in range(1, WORLD):
        for k, v in world[0]["pod"][1].items():
            np.testing.assert_array_equal(world[rank]["pod"][1][k], v)


# ---------------------------------------------------------------------------
# prefill, decode and the engine


def test_mesh_prefill_and_decode_match_jax(jx, world):
    want = jx["dec/logits"]
    for rank in range(WORLD):
        d, got, kshape = world[rank]["dec"]
        assert kshape == (2, 2, MAX_LEN // 2, 4, 16)   # seq over model
        np.testing.assert_allclose(got, want[:, 2 * d:2 * d + 2], rtol=1e-5,
                                   atol=1e-5)


def test_meshed_engine_equals_unmeshed(jx, world):
    from repro_torch import convert
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg = registry.smoke_config(get_config("qwen1.5-0.5b"))
    b = registry.get_bundle(cfg)
    params = convert.lm_params_from_numpy(tree(jx, "dec/p0/"), cfg, "cpu")
    eng = ServeEngine(b, params, ServeConfig(batch=4, max_len=32))
    for i, p in enumerate(_requests(cfg.vocab)):
        eng.submit(p, rid=i, max_tokens=5)
    want = (sorted((r.rid, list(r.out)) for r in eng.run()), eng.prefills,
            eng.decode_steps)
    assert want[1] == 2
    for rank in range(WORLD):
        assert world[rank]["engine"] == want, rank
