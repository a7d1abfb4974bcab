"""The port's training (``repro_torch.training``, ``launch.steps``) against
the JAX package's: mirrors of ``tests/test_training.py``'s eight tests,
each held against JAX where the JAX test asserts only a property, and
the parity of one step taken apart.

Both packages start from one set of JAX weights (the smoke qwen1.5-0.5b
config, f32) and read JAX's ``synthetic_batch`` arrays (the port's own
token draws differ). Tolerances:
  * loss and gradients against ``jax.value_and_grad``: rtol 1e-6 and
    rtol = 1e-4, atol = 1e-6 (measured: at most 1.2e-6 absolute, 1e-6
    relative to the largest gradient of each parameter);
  * ``apply_update`` on the same numpy gradients: rtol 1e-6, atol 1e-7;
  * a whole step's parameters: within 1e-5 wherever |g_jax| exceeds the
    gradient tolerance, within 2 lr + 1e-6 elsewhere (AdamW's first step
    moves a parameter by about lr sign(g), so a gradient whose sign is
    rounding noise can land 2 lr away);
  * ten steps' losses: rel 1e-5 (measured: at most 5e-7).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lm_batches, lm_pair
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.models.common import SHAPES as JSHAPES
from repro.models.common import ShapeCfg as JShapeCfg
from repro.models.common import rules_for_mesh
from repro.training import optimizer as jopt
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.tokens import TokenStream, synthetic_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import placement, registry, transformer
from repro_torch.models import common as tcommon
from repro_torch.models.common import SHAPES, ShapeCfg
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.trainer import (TrainConfig, grad_fn,
                                          init_train_state, make_train_step)
from repro_torch.utils import tree_bytes

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)
ARCH = "qwen1.5-0.5b"


def mesh1():
    return jax.sharding.Mesh(
        np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def setup():
    """JAX and port of the smoke qwen1.5-0.5b from JAX's key 1, and a
    cache of JAX's jitted train steps (one compile per config)."""
    pair = lm_pair(ARCH, key=1)
    mesh = mesh1()
    rules = rules_for_mesh(mesh)

    @functools.lru_cache(maxsize=None)
    def jstep(**kw):
        return jax_make_train_step(pair[1], mesh, rules,
                                   JTrainConfig(donate=False, **kw))

    return pair, lambda **kw: jstep(**kw)


def fresh(pair):
    """The port's parameters anew (a step may write them in place)."""
    return {k: v.clone() for k, v in pair[5].items()}


def jopt_cfg(ocfg: OptConfig) -> jopt.OptConfig:
    return jopt.OptConfig(**vars(ocfg))


# ---------------------------------------------------------------------------
# mirrors of tests/test_training.py


@pytest.fixture(scope="module")
def markov(setup):
    """30 steps at lr 3e-3 on JAX's Markov batches of shape (64, 8) in
    both packages, from one set of weights: (JAX losses, port losses)."""
    (jcfg, jb, jp, cfg, tb, _), jstep = setup
    ocfg = OptConfig(lr=3e-3)
    shape = JShapeCfg("t", 64, 8, "train")
    step = jstep(opt=jopt_cfg(ocfg))
    jo = jopt.init_opt_state(jopt_cfg(ocfg), jp)
    tp = fresh(setup[0])
    tstep = make_train_step(tb, tcfg=TrainConfig(opt=ocfg))
    to = opt_lib.init_opt_state(ocfg, tp)
    jl, tl = [], []
    for jbatch, tbatch in lm_batches(jcfg, shape, range(30)):
        jp, jo, m = step(jp, jo, jbatch)
        tp, to, n = tstep(tp, to, tbatch)
        jl.append(float(m["loss"]))
        tl.append(float(n["loss"]))
    return np.asarray(jl), np.asarray(tl)


def test_loss_decreases_on_markov_stream(setup, markov):
    """JAX's margin on JAX's batches, and on the port's own stream from
    the port's own initialisation."""
    _, losses = markov
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
    cfg, tb = setup[0][3], setup[0][4]
    ocfg = OptConfig(lr=3e-3)
    params = tb.init(0, device="cpu")
    opt = opt_lib.init_opt_state(ocfg, params)
    step = make_train_step(tb, tcfg=TrainConfig(opt=ocfg))
    own = []
    for i in range(30):
        batch = synthetic_batch(cfg, ShapeCfg("t", 64, 8, "train"), step=i,
                                seed=0, device="cpu")
        params, opt, m = step(params, opt, batch)
        own.append(float(m["loss"]))
    assert np.mean(own[-5:]) < np.mean(own[:5]) - 0.5, own


def test_loss_trajectory_matches_jax(markov):
    jl, tl = markov
    np.testing.assert_allclose(tl[:10], jl[:10], rtol=1e-5)


def test_microbatch_accumulation_equivalent(setup):
    (jcfg, jb, jp, cfg, tb, _), jstep = setup
    shape = JShapeCfg("t", 32, 8, "train")
    [(jbatch, batch)] = lm_batches(jcfg, shape, [0])
    outs = {}
    for mb in (1, 2, 8):
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3), microbatches=mb)
        step = make_train_step(tb, tcfg=tcfg)
        params = fresh(setup[0])
        opt = opt_lib.init_opt_state(tcfg.opt, params)
        p2, _, m = step(params, opt, batch)
        outs[mb] = (p2, float(m["loss"]))
        _, _, jm = jstep(opt=jopt.OptConfig(lr=1e-3), microbatches=mb)(
            jp, jopt.init_opt_state(jopt.OptConfig(), jp), jbatch)
        assert outs[mb][1] == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-4)
    assert outs[1][1] == pytest.approx(outs[8][1], rel=1e-4)
    for k in outs[1][0]:
        torch.testing.assert_close(outs[1][0][k], outs[8][0][k], rtol=2e-4,
                                   atol=2e-5)


def test_adamw_matches_reference_math():
    ocfg = OptConfig(name="adamw", lr=0.1, b1=0.9, b2=0.99,
                     weight_decay=0.0, eps=1e-8)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    st = opt_lib.init_opt_state(ocfg, p)
    p1, st = opt_lib.apply_update(ocfg, p, g, st)
    m = 0.1 * np.asarray([0.5, 0.25])
    v = 0.01 * np.asarray([0.5, 0.25]) ** 2
    mh, vh = m / (1 - 0.9), v / (1 - 0.99)
    ref = np.asarray([1.0, -2.0]) - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(p1["w"].numpy(), ref, rtol=1e-6)
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0]))   # not in place
    assert int(st["step"]) == 1


def _opt_tree(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"big": (256, 192), "mid": (8, 16), "small": (3,),
              "stack": (2, 130, 128)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_apply_update_matches_jax_on_the_same_grads(name):
    """Three updates from the same numpy gradients: parameters and state
    equal JAX's within rtol 1e-6; in place and not alike."""
    ocfg = OptConfig(name=name, lr=1e-2, weight_decay=0.1)
    jcfg = jopt_cfg(ocfg)
    params = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tq = {k: v.clone() for k, v in tp.items()}
    js = jopt.init_opt_state(jcfg, jp)
    ts = opt_lib.init_opt_state(ocfg, tp)
    tqs = opt_lib.init_opt_state(ocfg, tq)
    for i in range(3):
        grads = _opt_tree(10 + i)
        jp, js = jopt.apply_update(jcfg, jp, {k: jnp.asarray(v) for k, v
                                              in grads.items()}, js)
        tg = {k: torch.tensor(v) for k, v in grads.items()}
        tp, ts = opt_lib.apply_update(ocfg, tp, tg, ts)
        out, tqs2 = opt_lib.apply_update(ocfg, tq, tg, tqs, inplace=True)
        assert all(out[k] is tq[k] for k in tq)
        assert tqs2["step"] is tqs["step"]
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **UPDATE_TOL, err_msg=f"{k} {i}")
            assert torch.equal(tq[k], tp[k])
        for key in js:
            if key == "step":
                assert int(ts["step"]) == int(js["step"]) == i + 1
                continue
            for k in params:
                np.testing.assert_allclose(
                    ts[key][k].numpy(), np.asarray(js[key][k]),
                    **UPDATE_TOL, err_msg=f"{key} {k} {i}")
                assert torch.equal(tqs[key][k], ts[key][k])


def test_adafactor_factored_state_shapes():
    ocfg = OptConfig(name="adafactor", min_dim_factored=4)
    p = {"big": torch.zeros((8, 16)), "small": torch.zeros((3,))}
    st = opt_lib.init_opt_state(ocfg, p)
    assert st["vr"]["big"].shape == (8,)
    assert st["vc"]["big"].shape == (16,)
    assert st["vr"]["small"].shape == (3,)
    g = {"big": torch.ones((8, 16)), "small": torch.ones((3,))}
    p1, st = opt_lib.apply_update(ocfg, p, g, st)
    for leaf in p1.values():
        assert bool(torch.isfinite(leaf).all())
    # the same state as JAX's, shape for shape and value for value
    jc = jopt.OptConfig(name="adafactor", min_dim_factored=4)
    jp = {"big": jnp.zeros((8, 16)), "small": jnp.zeros((3,))}
    js = jopt.init_opt_state(jc, jp)
    jp1, js = jopt.apply_update(jc, jp, {"big": jnp.ones((8, 16)),
                                         "small": jnp.ones((3,))}, js)
    for key in ("vr", "vc"):
        for k in p:
            np.testing.assert_allclose(st[key][k].numpy(),
                                       np.asarray(js[key][k]), **UPDATE_TOL)
    for k in p:
        np.testing.assert_allclose(p1[k].numpy(), np.asarray(jp1[k]),
                                   **UPDATE_TOL)


def test_adafactor_memory_is_sublinear():
    p = {"w": torch.zeros((512, 512))}
    a = opt_lib.init_opt_state(OptConfig(name="adamw"), p)
    f = opt_lib.init_opt_state(OptConfig(name="adafactor"), p)
    assert tree_bytes(f) < tree_bytes(a) / 50


def test_global_norm_clip():
    g = {"a": torch.tensor([3.0, 4.0])}           # norm 5
    clipped, gn = opt_lib.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(5.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-5)
    # under the limit: unchanged
    clipped2, _ = opt_lib.clip_by_global_norm(g, 10.0)
    np.testing.assert_allclose(clipped2["a"].numpy(), [3.0, 4.0], rtol=1e-6)
    # JAX's on a tree of several leaves, f32 and bf16
    tree = _opt_tree(3)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        tc, tn = opt_lib.clip_by_global_norm(
            {k: torch.tensor(v).to(dt) for k, v in tree.items()}, 1.0)
        jc, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v, jdt) for k, v in tree.items()}, 1.0)
        # a sum of 88k squares in another order: within 1e-5
        assert float(tn) == pytest.approx(float(jn), rel=1e-5)
        for k in tree:
            assert tc[k].dtype == dt
            np.testing.assert_allclose(tc[k].float().numpy(),
                                       np.asarray(jc[k], np.float32),
                                       rtol=1e-6 if dt == torch.float32
                                       else 1e-2)


def test_bf16_accumulation_error_bounded(setup):
    """bf16 gradient accumulation stays within 2e-2 of the f32
    accumulator in gnorm; the f32 gnorm is JAX's."""
    (jcfg, jb, jp, cfg, tb, _), jstep = setup
    shape = JShapeCfg("t", 32, 8, "train")
    [(jbatch, batch)] = lm_batches(jcfg, shape, [0])
    gn = {}
    for dt in ("f32", "bf16"):
        tcfg = TrainConfig(opt=OptConfig(lr=0.0, weight_decay=0.0),
                           microbatches=8, accum_dtype=dt)
        params = fresh(setup[0])
        opt = opt_lib.init_opt_state(tcfg.opt, params)
        _, _, m = make_train_step(tb, tcfg=tcfg)(params, opt, batch)
        gn[dt] = float(m["gnorm"])
    assert gn["bf16"] == pytest.approx(gn["f32"], rel=2e-2)
    _, _, jm = jstep(opt=jopt.OptConfig(lr=0.0, weight_decay=0.0),
                     microbatches=8)(jp, jopt.init_opt_state(
                         jopt.OptConfig(), jp), jbatch)
    assert gn["f32"] == pytest.approx(float(jm["gnorm"]), rel=1e-5)


def test_markov_stream_is_learnable_signal():
    s = TokenStream(vocab=256, seq_len=8, global_batch=1, seed=0,
                    device="cpu")
    t = s._table()
    row_ent = -np.sum(t * np.log(t + 1e-12), axis=1)
    assert np.mean(row_ent) < 0.7 * np.log(s.n_states)


# ---------------------------------------------------------------------------
# one step, taken apart


def test_loss_and_grads_match_jax(setup):
    (jcfg, jb, jp, cfg, tb, tp), _ = setup
    [(jbatch, batch)] = lm_batches(jcfg, JShapeCfg("t", 32, 4, "train"), [0])
    (jl, jm), jg = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jp, jbatch)
    (loss, m), grads = grad_fn(tb)(tp, batch)
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    assert float(m["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-6)
    assert sorted(grads) == sorted(jg)
    for k in grads:
        assert grads[k].dtype == tp[k].dtype and not grads[k].requires_grad
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)


def test_whole_step_matches_jax(setup):
    """The loss, the clip and the update of one AdamW step against JAX's
    ``make_train_step``: the update on JAX's own clipped gradients within
    rtol 1e-6, the step's parameters under the rule of the docstring."""
    (jcfg, jb, jp, cfg, tb, _), jstep = setup
    ocfg = OptConfig(lr=1e-3)
    [(jbatch, batch)] = lm_batches(jcfg, JShapeCfg("t", 32, 4, "train"), [1])
    jo = jopt.init_opt_state(jopt_cfg(ocfg), jp)
    jp2, jo2, jm = jstep(opt=jopt_cfg(ocfg))(jp, jo, jbatch)
    params = fresh(setup[0])
    p2, o2, m = make_train_step(tb, tcfg=TrainConfig(opt=ocfg))(
        params, opt_lib.init_opt_state(ocfg, params), batch)
    assert all(p2[k] is params[k] for k in params)   # donated: in place
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)
    (_, _), jg = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jp, jbatch)
    jg, _ = jopt.clip_by_global_norm(jg, ocfg.grad_clip)
    # the update alone, on JAX's clipped gradients
    q, qs = opt_lib.apply_update(
        ocfg, fresh(setup[0]), {k: torch.tensor(np.asarray(v))
                                for k, v in jg.items()},
        opt_lib.init_opt_state(ocfg, fresh(setup[0])))
    for k in q:
        np.testing.assert_allclose(q[k].numpy(), np.asarray(jp2[k]),
                                   **UPDATE_TOL, err_msg=k)
        np.testing.assert_allclose(qs["m"][k].numpy(),
                                   np.asarray(jo2["m"][k]), **UPDATE_TOL)
    # the whole step
    for k in p2:
        got, want = p2[k].numpy(), np.asarray(jp2[k])
        g = np.abs(np.asarray(jg[k]))
        clear = g > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * g.max()
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=1e-5, err_msg=k)
        assert np.abs(got - want).max() <= 2 * ocfg.lr + 1e-6, k
    assert int(o2["step"]) == 1


def test_remat_gives_the_same_grads(setup, monkeypatch):
    """``remat="full"`` checkpoints each layer while gradients are taken
    (and only then) and changes no gradient."""
    cfg, tb, tp = setup[0][3:]
    [(_, batch)] = lm_batches(setup[0][0], JShapeCfg("t", 32, 4, "train"),
                              [2])
    calls = []
    real = transformer.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    (l0, _), g0 = grad_fn(tb)(tp, batch)
    assert calls == []
    rb = registry.get_bundle(cfg.replace(remat="full"))
    (l1, _), g1 = grad_fn(rb)(tp, batch)
    assert calls == [False] * cfg.n_layers
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    with torch.no_grad():                     # serving: no checkpoint
        rb.forward(tp, batch)
    tracked = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    rb.forward(tracked, batch)
    assert len(calls) == 2 * cfg.n_layers


def test_train_state_resumes_bitwise_from_a_checkpoint(setup, tmp_path):
    """(params, opt_state) saved after two steps through the port's
    ``CheckpointManager`` and restored into a fresh tree take the next
    two steps bitwise as the uninterrupted run does (the CPU)."""
    (jcfg, _, _, cfg, tb, _), _ = setup
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3), microbatches=2)
    step = make_train_step(tb, tcfg=tcfg)
    batches = [b for _, b in lm_batches(jcfg, JShapeCfg("t", 32, 4, "train"),
                                         range(4))]
    params = fresh(setup[0])
    opt = opt_lib.init_opt_state(tcfg.opt, params)
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for i, batch in enumerate(batches):
        params, opt, _ = step(params, opt, batch)
        if i == 1:
            ckpt.save_async((params, opt), 2)   # in flight during step 3
    ckpt.wait()
    target = init_train_state(tb, tcfg=tcfg, rng=5, device="cpu")[:2]
    (p, o), at, _ = ckpt.restore(target)
    assert at == 2 and int(o["step"]) == 2
    for batch in batches[2:]:
        p, o, _ = step(p, o, batch)
    for k in params:
        assert torch.equal(p[k], params[k]), k
        assert torch.equal(o["m"][k], opt["m"][k])
        assert torch.equal(o["v"][k], opt["v"][k])
    assert int(o["step"]) == int(opt["step"]) == 4


def test_opt_state_moves_between_the_packages(setup):
    """JAX's optimizer state after a step, carried across through numpy,
    takes the next update as JAX's does; and back again bitwise."""
    ocfg = OptConfig(name="adafactor", min_dim_factored=4, lr=1e-2)
    jc = jopt_cfg(ocfg)
    params = _opt_tree(4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_opt_state(jc, jp)
    g = _opt_tree(5)
    jp, js = jopt.apply_update(jc, jp, {k: jnp.asarray(v)
                                        for k, v in g.items()}, js)
    ts = convert.opt_state_from_numpy(jax.device_get(js), device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    back = convert.opt_state_to_numpy(ts)
    for key in ("vr", "vc"):
        for k in params:
            np.testing.assert_array_equal(back[key][k], np.asarray(js[key][k]))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    jp2, js2 = jopt.apply_update(jc, jp, {k: jnp.asarray(v)
                                          for k, v in g.items()}, js)
    tp2, ts2 = opt_lib.apply_update(ocfg, tp, {k: torch.tensor(v)
                                               for k, v in g.items()}, ts)
    for k in params:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   **UPDATE_TOL)


# ---------------------------------------------------------------------------
# launch/steps.py: the deployment table on one device


def test_deploy_table_equals_jax():
    assert sorted(steps.DEPLOY, key=str) == sorted(jsteps.DEPLOY, key=str)
    for key, dep in steps.DEPLOY.items():
        assert vars(dep) == vars(jsteps.DEPLOY[key]), key
    assert vars(steps.DEFAULT_DEPLOY) == vars(jsteps.DEFAULT_DEPLOY)
    mesh = mesh1()
    for arch in ARCHS:
        name = get_config(arch).name
        for shape in SHAPES:
            dep = steps.deploy_for(name, shape)
            assert vars(dep) == vars(jsteps.deploy_for(name, shape))
            # one device: one shard, one sequence per microbatch
            ours = steps.resolve_deploy(dep, SHAPES[shape])
            theirs = jsteps.resolve_deploy(jsteps.deploy_for(name, shape),
                                           JSHAPES[shape], mesh)
            assert vars(ours) == vars(theirs), (arch, shape)
            assert steps.applicable(get_config(arch), shape) == \
                jsteps.applicable(jax_get_config(arch), shape)
    assert steps.resolve_deploy(steps.deploy_for(
        "qwen1.5-0.5b", "train_4k"), SHAPES["train_4k"]).microbatches == 256


def test_build_train_step_on_one_device(setup):
    """``build_train_step``'s abstract arguments are ``meta`` tensors of
    the parameter and optimizer tables; the step it returns is the
    trainer's."""
    (jcfg, _, _, cfg, tb, _), _ = setup
    dep = steps.resolve_deploy(steps.deploy_for(cfg.name, "train_4k"),
                               ShapeCfg("t", 32, 4, "train"))
    assert dep.microbatches == 4 and dep.accum_dtype == "bf16"
    step, (params, opt), tcfg = steps.build_train_step(tb, None, None, dep)
    assert tcfg == TrainConfig(opt=OptConfig(name="adamw", lr=dep.lr),
                               microbatches=4, accum_dtype="bf16")
    assert all(v.device.type == "meta" for v in params.values())
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in tb.param_shapes().items()}
    assert all(v.device.type == "meta" and v.dtype == torch.float32
               for v in opt["m"].values())
    spec = steps.train_batch_abstract(tb, ShapeCfg("t", 32, 4, "train"))
    assert {k: tuple(v.shape) for k, v in spec.items()} == {
        "tokens": (4, 32), "labels": (4, 32)}
    [(_, batch)] = lm_batches(jcfg, JShapeCfg("t", 32, 4, "train"), [0])
    p = fresh(setup[0])
    _, o, m = step(p, opt_lib.init_opt_state(tcfg.opt, p), batch)
    assert np.isfinite(float(m["loss"])) and int(o["step"]) == 1


def test_what_waits_for_the_meshes_raises(setup):
    """What raises: a mesh that is no ``LMMesh`` (``TypeError``), the
    pod-manual step without a mesh that has a pod axis. What runs since
    the families' mesh paths and the dry run were ported: the SSM, hybrid
    and enc-dec losses on a one-rank mesh, equal to their unmeshed
    losses, and ``lower_cell``, which gives the cell's dry-run row. The
    step factories run without a mesh, as on one device."""
    (_, _, _, cfg, tb, tp), _ = setup
    for kw in ({"compress_pods": True}, {"straggler_masking": True}):
        with pytest.raises(ValueError, match="pod"):
            make_train_step(tb, tcfg=TrainConfig(**kw))
    with pytest.raises(TypeError, match="LMMesh"):
        make_train_step(tb, mesh=object())
    mesh = LMMesh(("data", "model"), {"data": 1, "model": 1},
                  {"data": 0, "model": 0}, {})
    with pytest.raises(ValueError, match="pod"):
        make_train_step(tb, mesh, tcommon.rules_for_mesh(mesh),
                        TrainConfig(compress_pods=True))
    ef = init_train_state(tb, tcfg=TrainConfig(compress_pods=True),
                          abstract=True)[2]
    assert sorted(ef) == sorted(tp) and all(
        v.dtype == torch.float32 for v in ef.values())
    for arch in ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium"):
        b = registry.get_bundle(registry.smoke_config(get_config(arch)))
        full = b.init(0, device="cpu")
        batch = {"tokens": torch.full((1, 4), 3, dtype=torch.int32),
                 "labels": torch.full((1, 4), 5, dtype=torch.int32),
                 "frames": torch.ones((1, b.cfg.encoder_ctx, b.cfg.d_model))}
        got, _ = b.loss(placement.shard_params(
            full, b.param_specs(tcommon.rules_for_mesh(mesh)), mesh), batch,
            mesh=mesh)
        want, _ = b.loss(full, batch)
        assert torch.isfinite(got) and float(got) == pytest.approx(
            float(want), rel=1e-6), arch
    assert steps.axis_sizes(None) == {} and steps.batch_axes_for(None, 4) == ()
    assert steps.cache_specs(cfg, {"length": (4,)}, mesh, 4) == {
        "length": (("data",),)}
    row = steps.lower_cell(cfg, "train_4k", None,
                           shapes={"train_4k": ShapeCfg("t", 32, 4, "train")})
    assert row["status"] == "ok" and row["chips"] == 1 and \
        row["step_flops"] > 0 and row["coll_bytes"] == 0
    with pytest.raises(TypeError, match="LMMesh"):
        transformer.forward(tp, cfg, torch.zeros((1, 2), dtype=torch.int32),
                            mesh=object())
