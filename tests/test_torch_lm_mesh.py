"""The LM's sharding logic and explicit collectives on a mesh, on the CPU
(gloo), against the JAX package's on the same host meshes.

* Specs, in process with no device: ``ShardingRules.spec_for`` through
  ``param_specs``, ``match_opt_specs`` (adamw and adafactor),
  ``rules_for_deploy`` for every ``DEPLOY`` entry, ``batch_axes_for``,
  ``batch_specs``, ``resolve_deploy``'s microbatch count, ``cache_specs``
  for every family's cache and ``residual_spec``, exactly JAX's, for the
  ten registry configs and their smoke configs on (data 16, model 16),
  (pod 2, data 16, model 16), (pod 2, data 2, model 2) and (data 2,
  model 2). JAX's rules read only ``axis_names`` and ``devices.shape``,
  so one ``SimpleNamespace`` stands in for the mesh on both sides.
* One world of 4 gloo ranks (``run_world``; its rank functions live here
  and import no JAX) against one JAX subprocess on 4 host devices
  (``run_with_devices``): ``flash_decode`` on (data 2, model 2), JAX's
  ``length = [32, 17, 8, 25]`` case and a fully masked shard, within 1e-5
  of JAX's ``flash_decode`` and ``decode_attention``; ``moe_ffn_ep`` on
  (data 2, model 2) without drops (``capacity_factor`` 8) within 2e-3 of
  the dense reference (aux within 1e-2, JAX's own tolerances), with drops
  (1.0) and at S = 1 within 1e-5 of JAX's expert-parallel path, so the
  drop set is JAX's; ``compressed_psum`` over ``pod = 4``, two rounds
  bitwise JAX's, with JAX's own asserts; ``shard_params`` then
  ``gather_params`` bitwise, each rank holding the total over the
  spec's shard count; the errors the mesh paths owe (a mesh larger
  than the world, ``max_len`` the model axis does not divide, a mesh
  that is no ``LMMesh``); and the SSM family's forward on the mesh, its
  rows within 1e-5 of the unmeshed forward (it raised until the
  families' mesh paths were ported).
"""
from __future__ import annotations

import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.models import act_sharding as jact
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro.training import optimizer as jopt
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.gson.distributed import run_world
from repro_torch.launch import steps
from repro_torch.models import act_sharding, common, registry
from repro_torch.training import optimizer as opt_lib

torch.set_num_threads(1)

WORLD = 4
MESHES = {"d16m16": ((16, 16), ("data", "model")),
          "p2d16m16": ((2, 16, 16), ("pod", "data", "model")),
          "p2d2m2": ((2, 2, 2), ("pod", "data", "model")),
          "d2m2": ((2, 2), ("data", "model"))}


def norm(spec) -> tuple:
    """A spec's entries as axis tuples (JAX writes a one-axis tuple as
    the name)."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else tuple(e) if isinstance(e, tuple)
                   else (e,))
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def norm_tree(tree):
    if isinstance(tree, dict):
        return {k: norm_tree(v) for k, v in tree.items()}
    return norm(tree)


def configs():
    out = []
    for a in ARCHS:
        jc, tc = jax_get_config(a), get_config(a)
        out += [(jc, tc), (jreg.smoke_config(jc), registry.smoke_config(tc))]
    return out


# ---------------------------------------------------------------------------
# specs, in process


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_equal_jax(mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    sizes = dict(zip(axes, shape))
    assert steps.axis_sizes(mesh) == jsteps.axis_sizes(mesh) == sizes
    jrules, rules = jcommon.rules_for_mesh(mesh), common.rules_for_mesh(mesh)
    for b in (1, 2, 3, 4, 8, 32, 128, 256, 512):
        for im in (False, True):
            assert steps.batch_axes_for(mesh, b, im) == \
                jsteps.batch_axes_for(mesh, b, im), (b, im)
    for jc, tc in configs():
        jb, tb = jreg.get_bundle(jc), registry.get_bundle(tc)
        ctx = (mesh_name, tc.name, tc.n_layers)
        deps = [jsteps.DEFAULT_DEPLOY] + [
            d for (a, _), d in sorted(jsteps.DEPLOY.items(),
                                      key=lambda kv: str(kv[0]))
            if a == jc.name]
        for jdep in deps:
            dep = steps.DeployCfg(**vars(jdep))
            jr, tr = (jsteps.rules_for_deploy(mesh, jdep),
                      steps.rules_for_deploy(mesh, dep))
            assert (tr.tensor_axis, norm((tr.fsdp_axis,)), tr.batch_axes,
                    tr.vocab_axis) == (jr.tensor_axis, norm((jr.fsdp_axis,)),
                                       jr.batch_axes, jr.vocab_axis), ctx
            jspecs, tspecs = jb.param_specs(jr), tb.param_specs(tr)
            assert norm_tree(tspecs) == norm_tree(jspecs), (ctx, jdep)
        jspecs, tspecs = jb.param_specs(jrules), tb.param_specs(rules)
        assert norm_tree(tspecs) == norm_tree(jspecs), ctx
        jshapes, tshapes = jb.param_shapes(), tb.param_shapes()
        for opt in ("adamw", "adafactor"):
            j = jopt.match_opt_specs(jopt.OptConfig(name=opt), jshapes, jspecs)
            t = opt_lib.match_opt_specs(opt_lib.OptConfig(name=opt),
                                        tshapes, tspecs)
            assert norm_tree(t) == norm_tree(j), (ctx, opt)
        jshp = jcommon.SHAPES if tc.n_layers > 2 else jcommon.SMOKE_SHAPES
        for sname, jshape in jshp.items():
            shape = common.ShapeCfg(**vars(jshape))
            for jdep in deps:
                dep = steps.DeployCfg(**vars(jdep))
                assert steps.resolve_deploy(dep, shape, mesh).microbatches \
                    == jsteps.resolve_deploy(jdep, jshape,
                                             mesh).microbatches, ctx
            for im in (False, True):
                assert norm_tree(steps.batch_specs(tc, shape, mesh, im)) == \
                    norm_tree(jsteps.batch_specs(jc, jshape, mesh, im)), ctx
            b = jshape.global_batch
            for max_len in (jshape.seq_len, 6):
                jcs = jb.cache_shapes(b, max_len)
                tcs = tb.cache_shapes(b, max_len)
                assert norm_tree(steps.cache_specs(tc, tcs, mesh, b)) == \
                    norm_tree(jsteps.cache_specs(jc, jcs, mesh, b)), ctx
        for bat in (("pod", "data"), ("pod", "data", "model"), ("data",)):
            for seq in (None, "model"):
                ja = jact.ActivationSharding(batch_axes=bat, seq_axis=seq)
                ta = act_sharding.ActivationSharding(batch_axes=bat,
                                                     seq_axis=seq)
                for shp in ((256, 4096, 16), (1, 3, 2), (32, 8, 4), (4, 4)):
                    j, t = (ja.residual_spec(shp, sizes),
                            ta.residual_spec(shp, sizes))
                    assert (j is None) == (t is None), shp
                    if j is not None:
                        assert norm(t) == norm(j), (bat, seq, shp)


# ---------------------------------------------------------------------------
# the JAX side: one subprocess on 4 host devices


JAX_CODE = """
import os
# one thread per op: the subprocess runs beside the other test workers
os.environ["XLA_FLAGS"] += (" --xla_cpu_multi_thread_eigen=false"
                            " intra_op_parallelism_threads=1")
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_debug_mesh
from repro.configs import get_config
from repro.models.registry import get_bundle, smoke_config
from repro.models import attention as attn
from repro.models.moe import moe_ffn_ep, moe_ffn_reference
from repro.training.compression import compressed_psum

out = {}
mesh = make_debug_mesh((2, 2), ("data", "model"))
rng = np.random.default_rng(0)
q = rng.normal(size=(4, 1, 8, 16)).astype(np.float32)
k = rng.normal(size=(4, 32, 2, 16)).astype(np.float32)
v = rng.normal(size=(4, 32, 2, 16)).astype(np.float32)
out.update(fd_q=q, fd_k=k, fd_v=v)
fd = jax.jit(lambda q, k, v, l: attn.flash_decode(mesh, q, k, v, l))
for name, length in (("lens", [32, 17, 8, 25]), ("masked", [5, 16, 3, 1])):
    ln = np.asarray(length, np.int32)
    with jax.set_mesh(mesh):
        out["fd_" + name] = np.asarray(fd(q, k, v, ln))
    out["fd_" + name + "_ref"] = np.asarray(attn.decode_attention(q, k, v, ln))
    out["fd_" + name + "_len"] = ln

cfg = smoke_config(get_config("qwen2-moe-a2.7b"))
params = get_bundle(cfg).init(jax.random.key(0))
lp = {k[len("layers/"):]: np.asarray(v[0]) for k, v in params.items()
      if k.startswith("layers/") and k not in ("layers/ln1", "layers/ln2")}
for name, a in lp.items():
    out["moe_lp_" + name] = a
for case, cf, s in (("cf8", 8.0, 16), ("cf1", 1.0, 16), ("s1", 1.25, 1)):
    c = cfg.replace(capacity_factor=cf)
    x = np.asarray(0.5 * jax.random.normal(jax.random.key(1),
                                           (8, s, cfg.d_model)))
    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda lp, x: moe_ffn_ep(lp, x, c, mesh))(lp, x)
    yr, auxr = moe_ffn_reference(lp, x, c)
    out.update({"moe_x_" + case: x, "moe_y_" + case: np.asarray(y),
                "moe_aux_" + case: np.asarray(aux),
                "moe_yref_" + case: np.asarray(yr),
                "moe_auxref_" + case: np.asarray(auxr)})

pmesh = make_debug_mesh((4,), ("pod",))
g_global = jax.random.normal(jax.random.key(0), (4, 64))

@partial(jax.shard_map, mesh=pmesh, in_specs=(P("pod"), P("pod")),
         out_specs=(P("pod"), P("pod")), check_vma=False)
def run(g, e):
    grads, ef = compressed_psum({"w": g[0]}, {"w": e[0]}, "pod", 4)
    return grads["w"][None], ef["w"][None]

g1, ef1 = run(g_global, jnp.zeros((4, 64)))
g2, ef2 = run(g_global, ef1)
out.update(cp_g=np.asarray(g_global), cp_g1=np.asarray(g1),
           cp_ef1=np.asarray(ef1), cp_g2=np.asarray(g2),
           cp_ef2=np.asarray(ef2))
np.savez(PATH, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jx(devices8, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_mesh") / "jax.npz")
    out = devices8(f"PATH = {path!r}\n" + textwrap.dedent(JAX_CODE),
                   n_devices=WORLD)
    assert "OK" in out
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# the world: every rank runs this, the pytest process compares


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _world(rank, jx):
    from repro_torch.launch.mesh import build_mesh, make_debug_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import placement, transformer
    from repro_torch.models.moe import moe_ffn_ep
    from repro_torch.training.compression import compressed_psum
    torch.set_num_threads(1)
    out = {}
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    pods = build_mesh((4,), ("pod",))
    t = {k: torch.from_numpy(v) for k, v in jx.items()}

    # flash_decode: this rank's rows (data) of its seq shard (model)
    d, m = mesh.index("data"), mesh.index("model")
    rows, seq = slice(2 * d, 2 * d + 2), slice(16 * m, 16 * m + 16)
    for name in ("lens", "masked"):
        out["fd_" + name] = attn.flash_decode(
            mesh, t["fd_q"][rows], t["fd_k"][rows, seq], t["fd_v"][rows, seq],
            t[f"fd_{name}_len"][rows]).numpy()

    # moe_ffn_ep: the layer's weights whole, x this rank's rows
    cfg = registry.smoke_config(get_config("qwen2-moe-a2.7b"))
    lp = {k[len("moe_lp_"):]: v for k, v in t.items()
          if k.startswith("moe_lp_")}
    for case, cf in (("cf8", 8.0), ("cf1", 1.0), ("s1", 1.25)):
        x = t["moe_x_" + case]
        y, aux = moe_ffn_ep(lp, x[4 * d:4 * d + 4],
                            cfg.replace(capacity_factor=cf), mesh,
                            bat=("data",))
        out["moe_" + case] = (y.numpy(), float(aux))

    # compressed_psum over four pods, two rounds with the same gradient
    g = {"w": t["cp_g"][rank]}
    g1, ef = compressed_psum(g, {"w": torch.zeros(64)}, pods.group("pod"), 4)
    g2, ef2 = compressed_psum(g, ef, pods.group("pod"), 4)
    out["cp"] = [a["w"].numpy() for a in (g1, ef, g2, ef2)]

    # shard_params then gather_params, for the rules of every deploy
    out["round"] = []
    for arch in ("qwen1.5-0.5b", "qwen2-moe-a2.7b", "yi-34b"):
        b = registry.get_bundle(registry.smoke_config(get_config(arch)))
        full = b.init(3, device="cpu")
        for dep in (steps.DeployCfg(), steps.DeployCfg(tp="none"),
                    steps.DeployCfg(tp="none", fsdp_wide=True),
                    steps.DeployCfg(fsdp=False)):
            specs = b.param_specs(steps.rules_for_deploy(mesh, dep))
            sh = placement.shard_params(full, specs, mesh)
            back = placement.gather_params(sh)
            out["round"].append((
                arch, all(torch.equal(back[k], full[k]) for k in full),
                all(sh[k].numel() * placement.shard_count(specs[k], mesh)
                    == full[k].numel() for k in full)))

    # the errors the mesh paths owe: raised alike on every rank
    out["err_world"] = _raises(lambda: build_mesh((4, 2), ("data", "model")),
                               RuntimeError)
    dense = registry.get_bundle(registry.smoke_config(get_config(
        "qwen1.5-0.5b")))
    rules = common.rules_for_mesh(mesh)
    params = placement.shard_params(dense.init(0, device="cpu"),
                                    dense.param_specs(rules), mesh)
    cache = placement.shard_cache(
        dense.init_cache(4, 5, device="cpu"),
        steps.cache_specs(dense.cfg, dense.cache_shapes(4, 5), mesh, 4), mesh)
    tok = torch.zeros((4, 1), dtype=torch.int32)
    out["err_max_len"] = _raises(
        lambda: dense.decode_step(params, cache, tok, mesh=mesh), ValueError)
    # the SSM family runs on the mesh now: its forward's rows there
    # against the same weights without a mesh
    ssm = registry.get_bundle(registry.smoke_config(get_config(
        "mamba2-2.7b")))
    full = ssm.init(0, device="cpu")
    toks = torch.arange(4 * 16, dtype=torch.int32).reshape(4, 16) % 200 + 2
    got = ssm.forward(placement.shard_params(full, ssm.param_specs(rules),
                                             mesh),
                      {"tokens": toks}, mesh=mesh)[0]
    want = ssm.forward(full, {"tokens": toks})[0][2 * d:2 * d + 2]
    out["err_family"] = float((got - want).abs().max())
    out["err_type"] = _raises(
        lambda: transformer.forward(params, dense.cfg, tok, mesh=object()),
        TypeError)
    out["err_plain"] = _raises(
        lambda: transformer.forward(dict(params), dense.cfg, tok, mesh=mesh),
        TypeError)
    return out


@pytest.fixture(scope="module")
def world(jx):
    return run_world(_world, WORLD, (jx,), timeout_s=300)


# ---------------------------------------------------------------------------
# flash decode, expert parallelism, the compressed psum


@pytest.mark.parametrize("case", ["lens", "masked"])
def test_flash_decode_matches_jax(jx, world, case):
    for rank in range(WORLD):
        d = rank // 2
        got = world[rank]["fd_" + case]
        assert np.all(np.isfinite(got))
        for want in (jx["fd_" + case], jx[f"fd_{case}_ref"]):
            np.testing.assert_allclose(got, want[2 * d:2 * d + 2],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["cf8", "cf1", "s1"])
def test_moe_expert_parallel_matches_jax(jx, world, case):
    """cf8: no drops, against the dense reference at JAX's tolerances;
    cf1 (drops) and s1 (replicated routing): against JAX's EP path."""
    for rank in range(WORLD):
        d = rank // 2
        y, aux = world[rank]["moe_" + case]
        if case == "cf8":
            np.testing.assert_allclose(y, jx["moe_yref_cf8"][4 * d:4 * d + 4],
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(aux, jx["moe_auxref_cf8"], rtol=1e-2)
        np.testing.assert_allclose(y, jx["moe_y_" + case][4 * d:4 * d + 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, jx["moe_aux_" + case], rtol=1e-5)
    if case == "cf1":   # the capacity really drops assignments
        assert np.abs(jx["moe_y_cf1"] - jx["moe_yref_cf1"]).max() > 1e-3


def test_compressed_psum_matches_jax(jx, world):
    g_global = jx["cp_g"]
    for rank in range(WORLD):
        g1, ef1, g2, ef2 = world[rank]["cp"]
        for got, key in ((g1, "cp_g1"), (ef1, "cp_ef1"), (g2, "cp_g2"),
                         (ef2, "cp_ef2")):
            np.testing.assert_array_equal(got, jx[key][rank], key)
    # JAX's own asserts: one dequantized mean on every pod, within two
    # quanta of the truth, and the two-step average no further from it
    true_mean = g_global.mean(axis=0)
    g1 = [world[r]["cp"][0] for r in range(WORLD)]
    assert all(np.array_equal(g1[0], g) for g in g1)
    err1 = np.abs(g1[0] - true_mean).max()
    assert err1 <= 2 * np.abs(g_global).max() / 127.0
    two = (g1[0] + world[0]["cp"][2]) / 2
    assert np.abs(two - true_mean).max() <= err1 + 1e-6


# ---------------------------------------------------------------------------
# placement and the errors


def test_shard_then_gather_is_bitwise(world):
    for rank in range(WORLD):
        for arch, bitwise, bytes_split in world[rank]["round"]:
            assert bitwise and bytes_split, (rank, arch)


def test_mesh_errors(world):
    for rank in range(WORLD):
        w = world[rank]
        assert "needs 8 ranks, found 4" in w["err_world"]
        assert w["err_max_len"].startswith("ValueError") and \
            "divisible by the model axis" in w["err_max_len"]
        assert w["err_family"] <= 1e-5      # the SSM family on the mesh
        assert w["err_type"].startswith("TypeError") and \
            "LMMesh" in w["err_type"]
        assert w["err_plain"].startswith("TypeError") and \
            "shard_params" in w["err_plain"]
