"""The port's LM ``ServeEngine`` and its launcher: mirrors of the JAX
engine's tests (``tests/test_serving.py``), token-for-token parity with
the JAX engine from the same weights, sampling at temperature > 0, the
launcher on every family, and the refusals (a mesh, a card that is not
there)."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jreg
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import LMMesh
from repro_torch.models import placement
from repro_torch.models.common import rules_for_mesh
from repro_torch.models.registry import get_bundle, smoke_config
from repro_torch.serving import ServeConfig, ServeEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    bundle = get_bundle(cfg)
    return cfg, bundle, bundle.init(0, device="cpu")


def test_all_requests_finish(served):
    cfg, bundle, params = served
    eng = ServeEngine(bundle, params,
                      ServeConfig(batch=4, max_len=64, eos_id=-1))
    rng = np.random.default_rng(0)
    for i in range(10):
        eng.submit(rng.integers(2, cfg.vocab, size=5), rid=i, max_tokens=6)
    done = eng.run()
    assert len(done) == 10
    assert sorted(r.rid for r in done) == list(range(10))
    for r in done:
        assert len(r.out) == 6
    assert eng.prefills == 3          # ceil(10 / 4) waves


def test_greedy_matches_manual_decode_loop(served):
    cfg, bundle, params = served
    prompt = np.asarray([5, 9, 17, 3], np.int32)
    eng = ServeEngine(bundle, params,
                      ServeConfig(batch=2, max_len=32, eos_id=-1))
    req = eng.submit(prompt, max_tokens=5)
    eng.run()

    # manual: prefill + greedy decode with batch 2 (slot 1 idle/pad)
    toks = torch.zeros((2, len(prompt)), dtype=torch.int32)
    toks[0] = torch.from_numpy(prompt)
    cache, logits = bundle.prefill(params, {"tokens": toks}, max_len=32)
    outs = [int(torch.argmax(logits[0]))]
    for _ in range(4):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        cache, logits = bundle.decode_step(params, cache, nxt)
        outs.append(int(torch.argmax(logits[0])))
    assert req.out == outs


def test_eos_stops_early(served):
    cfg, bundle, params = served
    eng = ServeEngine(bundle, params,
                      ServeConfig(batch=2, max_len=32, eos_id=0))
    for i in range(4):
        eng.submit(np.asarray([3 + i, 7], np.int32), rid=i, max_tokens=20)
    done = eng.run()
    for r in done:
        if 0 in r.out:
            assert r.out.index(0) == len(r.out) - 1


def test_wave_slot_reuse(served):
    cfg, bundle, params = served
    eng = ServeEngine(bundle, params,
                      ServeConfig(batch=2, max_len=64, eos_id=-1))
    for i in range(6):
        eng.submit(np.asarray([2 + i], np.int32), rid=i, max_tokens=3)
    done = eng.run()
    assert len(done) == 6
    assert eng.prefills == 3


# ---------------------------------------------------------------------------
# parity with the JAX engine


def _record_margins(eng, margins, to_numpy):
    """Wrap ``eng._sample`` to keep, per call, the smallest top-2 logit
    margin over the slots that hold a live request."""
    sample = eng._sample

    def recording(logits):
        live = [r is not None and not r.done for r in eng.slots]
        top2 = np.sort(to_numpy(logits), axis=-1)[:, -2:]
        gaps = (top2[:, 1] - top2[:, 0])[np.asarray(live)]
        if gaps.size:
            margins.append(float(gaps.min()))
        return sample(logits)

    eng._sample = recording


def test_greedy_outputs_equal_the_jax_engine():
    """Ten requests (prompts of 1-8 tokens) through four slots, greedy, in
    both engines from the same weights: every ``Request.out`` equal token
    for token. The smallest top-2 margin on a live slot exceeds 1e-4, so
    agreement is not luck at a near-tie."""
    jcfg = jreg.smoke_config(jax_get_config("qwen1.5-0.5b"))
    jb = jreg.get_bundle(jcfg)
    jp = jb.init(jax.random.key(0))
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    bundle = get_bundle(cfg)
    params = lm_params_from_numpy(jax.device_get(jp), cfg, device="cpu")

    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(1, 9)))
               for _ in range(10)]
    jeng = JaxServeEngine(jb, jp, JaxServeConfig(batch=4, max_len=32,
                                                 eos_id=-1))
    eng = ServeEngine(bundle, params, ServeConfig(batch=4, max_len=32,
                                                  eos_id=-1))
    margins = []
    _record_margins(eng, margins, lambda t: t.float().numpy())
    for i, p in enumerate(prompts):
        jeng.submit(p, rid=i, max_tokens=6)
        eng.submit(p, rid=i, max_tokens=6)
    jdone = {r.rid: r.out for r in jeng.run()}
    done = {r.rid: r.out for r in eng.run()}
    assert done == jdone
    assert (eng.prefills, eng.decode_steps) == (jeng.prefills,
                                                jeng.decode_steps)
    assert len(margins) == eng.prefills + eng.decode_steps
    assert min(margins) > 1e-4, min(margins)


def test_engine_holds_one_compute_dtype_copy(served):
    cfg, bundle, params = served
    eng = ServeEngine(bundle, params, ServeConfig(batch=2, max_len=16))
    assert all(eng.compute_params[k] is params[k] for k in params)
    bcfg = cfg.replace(compute_dtype=torch.bfloat16)
    beng = ServeEngine(get_bundle(bcfg), params, ServeConfig(batch=2,
                                                             max_len=16))
    assert all(v.dtype == torch.bfloat16
               for v in beng.compute_params.values())
    assert all(v.dtype == torch.float32 for v in beng.params.values())
    req = beng.submit(np.asarray([4, 5, 6], np.int32), max_tokens=4)
    beng.run()
    assert len(req.out) == 4 and all(0 <= t < cfg.vocab for t in req.out)


# ---------------------------------------------------------------------------
# sampling at temperature > 0


def _sampled(served, seed):
    cfg, bundle, params = served
    eng = ServeEngine(bundle, params,
                      ServeConfig(batch=4, max_len=32, eos_id=-1,
                                  temperature=0.8),
                      rng=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(1)
    for i in range(6):
        eng.submit(rng.integers(2, cfg.vocab, size=4), rid=i, max_tokens=8)
    return {r.rid: r.out for r in eng.run()}


def test_temperature_sampling_is_reproducible_under_a_seed(served):
    a, b, c = _sampled(served, 3), _sampled(served, 3), _sampled(served, 4)
    assert a == b
    assert a != c
    assert all(len(v) == 8 for v in a.values())


def test_temperature_sampling_follows_the_softmax(served):
    """Gumbel-max draws of one row, many times: the frequencies match
    softmax(logits / T) within five standard errors."""
    cfg, bundle, params = served
    eng = ServeEngine(bundle, params,
                      ServeConfig(batch=1, max_len=8, temperature=0.5),
                      rng=torch.Generator().manual_seed(0))
    row = torch.tensor([0.0, 0.5, -1.0, 1.0, 0.2])
    n = 40000
    draws = eng._sample(row.expand(n, -1))
    assert draws.dtype == torch.int32
    freq = np.bincount(draws.numpy(), minlength=5) / n
    p = torch.softmax(row / 0.5, dim=0).numpy()
    np.testing.assert_array_less(np.abs(freq - p),
                                 5 * np.sqrt(p * (1 - p) / n) + 1e-9)


# ---------------------------------------------------------------------------
# the launcher and the refusals


def test_launch_serve_smoke_on_the_cpu_finishes_every_request(capsys):
    done = launch_serve.main(["--smoke", "--device", "cpu", "--requests",
                              "5", "--batch", "2", "--max-tokens", "4"])
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out) == 4 for r in done)
    assert "[serve] qwen1.5-0.5b: 5 requests, 20 tokens" in capsys.readouterr().out


def test_a_mesh_raises(served):
    """A mesh that is no ``LMMesh`` raises ``TypeError``, and so do whole
    parameters on an ``LMMesh`` (a rank holds its shards); on a 1 x 1
    mesh the engine serves the unmeshed engine's tokens."""
    cfg, bundle, params = served
    with pytest.raises(TypeError, match="LMMesh"):
        ServeEngine(bundle, params, ServeConfig(), mesh=object())
    mesh = LMMesh(("data", "model"), {"data": 1, "model": 1},
                  {"data": 0, "model": 0}, {})
    with pytest.raises(TypeError, match="shard_params"):
        ServeEngine(bundle, params, ServeConfig(), mesh=mesh)
    sharded = placement.shard_params(
        params, bundle.param_specs(rules_for_mesh(mesh)), mesh)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(3, 9)))
               for _ in range(5)]
    outs = []
    for p, m in ((params, None), (sharded, mesh)):
        eng = ServeEngine(bundle, p, ServeConfig(batch=4, max_len=32,
                                                 eos_id=-1), mesh=m)
        for i, q in enumerate(prompts):
            eng.submit(q, rid=i, max_tokens=4)
        outs.append(sorted((r.rid, r.out) for r in eng.run()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_launch_serve_smoke_serves_the_other_families(arch, capsys):
    """Every request finishes: 4 tokens, or fewer ending at the launcher's
    eos id 1."""
    done = launch_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                              "--requests", "5", "--batch", "2",
                              "--max-tokens", "4"])
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out) == 4 or (0 < len(r.out) < 4 and r.out[-1] == 1)
               for r in done)
    toks = sum(len(r.out) for r in done)
    assert f"[serve] {arch}: 5 requests, {toks} tokens" in (
        capsys.readouterr().out)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_card_without_a_card_raises():
    with pytest.raises((RuntimeError, AssertionError)):
        launch_serve.main(["--smoke", "--requests", "1"])
