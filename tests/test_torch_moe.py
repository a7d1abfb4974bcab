"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package's dense reference path.

The smoke configs of qwen2-moe-a2.7b (60 -> 8 routed experts top-4 -> 2,
shared experts, QKV bias) and qwen3-moe-235b-a22b (GQA, no shared
experts) run in both packages from the same weights (JAX's
``bundle.init(jax.random.key(0))`` carried across). At f32: the
router's gates and statistics, ``moe_ffn_reference``'s output and aux,
the forward logits, the loss (ce + aux), prefill and decode agree within
rtol = atol = 1e-4; routed expert ids agree on every row whose top-k
margin (the gap between the k-th and the (k+1)-th probability) exceeds
that tolerance, as ``jax.lax.top_k`` and ``torch.topk`` may order a tie
differently. Padded experts never receive weight. The full-width
parameter tables equal JAX's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lm_pair
from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.models import moe, registry
from repro_torch.models.registry import smoke_config

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
B, T0, STEPS = 2, 6, 3


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    return lm_pair(request.param)


def close(port, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), err_msg=msg,
                               **tol)


def test_moe_reference_vs_padded_router():
    """Padded (null) experts never receive routing weight (the JAX test's
    check), and the router equals JAX's on the same inputs."""
    cfg = smoke_config(get_config("qwen2-moe-a2.7b"))
    rng = np.random.default_rng(0)
    e_pad = 16  # > cfg.n_experts == 8
    w = rng.standard_normal((32, e_pad)).astype(np.float32)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    gates, experts, stats = moe._router(torch.from_numpy(w), cfg,
                                        torch.from_numpy(x))
    assert int(experts.max()) < cfg.n_experts
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(stats[0][cfg.n_experts:].sum()) == 0.0
    assert float(stats[1][cfg.n_experts:].sum()) == 0.0   # exactly 0
    jcfg = jreg.smoke_config(jax_get_config("qwen2-moe-a2.7b"))
    jg, je, jstats = jmoe._router(jnp.asarray(w), jcfg, jnp.asarray(x))
    close(gates, jg)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(je))
    for got, want in zip(stats, jstats):
        close(torch.as_tensor(got), want)


def _tie_free(probs: np.ndarray, k: int, eps: float) -> np.ndarray:
    top = -np.sort(-probs, axis=-1)
    return (top[:, k - 1] - top[:, k]) > eps


def test_router_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((96, cfg.d_model)).astype(np.float32)
    w = np.array(jp["layers/router"][0])
    gates, experts, stats = moe._router(torch.from_numpy(w), cfg,
                                        torch.from_numpy(x))
    jg, je, jstats = jmoe._router(jnp.asarray(w), jcfg, jnp.asarray(x))
    close(gates, jg)
    probs = np.array(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w)))
    probs[:, cfg.n_experts:] = 0.0
    ok = _tie_free(probs, cfg.top_k, TOL["atol"])
    assert ok.sum() > 0.9 * len(ok)
    np.testing.assert_array_equal(experts.numpy()[ok], np.asarray(je)[ok])
    assert experts.dtype == torch.int32 and gates.dtype == torch.float32
    for got, want in zip(stats, jstats):
        close(torch.as_tensor(got), want)
    close(moe._aux_from_stats(cfg, stats), jmoe._aux_from_stats(jcfg, jstats))


def _layer(params: dict, i: int = 0) -> dict:
    return {k[len("layers/"):]: v[i] for k, v in params.items()
            if k.startswith("layers/")}


def test_moe_ffn_reference_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((B, 7, cfg.d_model))).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(_layer(jp), jnp.asarray(x), jcfg)
    y, aux = moe.moe_ffn(_layer(tp), torch.from_numpy(x), cfg)
    assert y.shape == x.shape and aux.dtype == torch.float32
    close(y, jy)
    close(aux, jaux)


def test_forward_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks = np.random.default_rng(3).integers(
        2, cfg.vocab, (B, T0 + STEPS)).astype(np.int32)
    ref, jaux = jb.forward(jp, {"tokens": jnp.asarray(toks)})
    logits, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    close(logits, ref)
    close(aux, jaux)
    assert float(aux) > 0.0                 # the router's balance loss


def test_loss_with_aux_matches_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks = np.random.default_rng(4).integers(
        2, cfg.vocab, (B, T0 + STEPS)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1
    ref, rm = jb.loss(jp, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(labels)})
    loss, m = tb.loss(tp, {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels)})
    close(loss, ref)
    close(m["ce"], rm["ce"])
    close(m["aux"], rm["aux"])
    close(loss, m["ce"] + cfg.router_aux_weight * m["aux"])


def test_prefill_and_decode_match_jax(pair):
    jcfg, jb, jp, cfg, tb, tp = pair
    toks = np.random.default_rng(5).integers(
        2, cfg.vocab, (B, T0 + STEPS)).astype(np.int32)
    jcache, jl = jb.prefill(jp, {"tokens": jnp.asarray(toks[:, :T0])},
                            max_len=T0 + STEPS)
    cache, logits = tb.prefill(tp, {"tokens": torch.from_numpy(toks[:, :T0])},
                               max_len=T0 + STEPS)
    close(logits, jl)
    for j in range(STEPS):
        tok = toks[:, T0 + j:T0 + j + 1]
        jcache, jl = jb.decode_step(jp, jcache, jnp.asarray(tok))
        cache, logits = tb.decode_step(tp, cache, torch.from_numpy(tok))
        close(logits, jl, msg=f"decode step {j}")
    for name in ("k", "v"):
        close(cache[name], jcache[name], msg=name)
    # and the port alone: prefill + decode reproduce its forward
    ref, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(logits, ref[:, -1], rtol=2e-3, atol=2e-3)


def test_train_step_matches_jax(pair):
    """The loss (ce + aux) and its gradients, router included, against
    ``jax.value_and_grad`` of the reference path (rtol = 1e-4, atol =
    1e-6), then one AdamW step through the port's trainer."""
    from repro.training import optimizer as jopt
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.trainer import (TrainConfig, grad_fn,
                                              make_train_step)
    jcfg, jb, jp, cfg, tb, tp = pair
    toks = np.random.default_rng(6).integers(
        2, cfg.vocab, (4, 17)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    batch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jp, jbatch)
    (loss, _), grads = grad_fn(tb)(tp, batch)
    close(loss, jl, tol=dict(rtol=1e-6, atol=0))
    assert float(grads["layers/router"].abs().max()) > 0
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    ocfg = opt_lib.OptConfig(lr=1e-3)
    params = {k: v.clone() for k, v in tp.items()}
    p2, _, m = make_train_step(tb, tcfg=TrainConfig(opt=ocfg))(
        params, opt_lib.init_opt_state(ocfg, params), batch)
    jg, jn = jopt.clip_by_global_norm(jg, ocfg.grad_clip)
    assert float(m["gnorm"]) == pytest.approx(float(jn), rel=1e-5)
    jp2, _ = jopt.apply_update(jopt.OptConfig(lr=1e-3), jp, jg,
                               jopt.init_opt_state(jopt.OptConfig(), jp))
    for k in p2:
        got, want = p2[k].numpy(), np.asarray(jp2[k])
        assert np.abs(got - want).max() <= 2 * ocfg.lr + 1e-6, k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_width_param_table_matches_jax(arch):
    """60 experts pad to 64 (the 16-way EP width), shapes as JAX's."""
    cfg = get_config(arch)
    ours = {k: tuple(v.shape) for k, v in
            registry.get_bundle(cfg).param_shapes().items()}
    jb = jreg.get_bundle(jax_get_config(arch))
    theirs = {k: tuple(v.shape) for k, v in jb.param_shapes().items()}
    assert ours == theirs
    assert ours["layers/router"][-1] == moe.padded_experts(cfg, 16) == (
        jmoe.padded_experts(jax_get_config(arch), 16))
    if arch == "qwen2-moe-a2.7b":
        assert ours["layers/we_gate"] == (24, 64, 2048, 1408)
        assert ours["layers/ws_gate"] == (24, 2048, 4 * 1408)


def test_moe_greedy_outputs_equal_the_jax_engine():
    """The smoke qwen2-moe through both ``ServeEngine``s from the same
    weights (eight requests, four slots, greedy): every ``Request.out``
    equal token for token, the smallest top-2 margin over 1e-4; and
    ``python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --smoke``
    serves every request."""
    from repro.serving.engine import ServeConfig as JaxServeConfig
    from repro.serving.engine import ServeEngine as JaxServeEngine
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import ServeConfig, ServeEngine
    jcfg, jb, jp, cfg, tb, tp = lm_pair("qwen2-moe-a2.7b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(1, 9)))
               for _ in range(8)]
    jeng = JaxServeEngine(jb, jp, JaxServeConfig(batch=4, max_len=32,
                                                 eos_id=-1))
    eng = ServeEngine(tb, tp, ServeConfig(batch=4, max_len=32, eos_id=-1))
    margins = []
    sample = eng._sample

    def recording(logits):
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return sample(logits)

    eng._sample = recording
    for i, p in enumerate(prompts):
        jeng.submit(p, rid=i, max_tokens=5)
        eng.submit(p, rid=i, max_tokens=5)
    assert ({r.rid: r.out for r in eng.run()}
            == {r.rid: r.out for r in jeng.run()})
    assert min(margins) > 1e-4, min(margins)
    done = launch_serve.main(["--smoke", "--device", "cpu", "--arch",
                              "qwen2-moe-a2.7b", "--requests", "5",
                              "--max-tokens", "4"])
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out) == 4 for r in done)
