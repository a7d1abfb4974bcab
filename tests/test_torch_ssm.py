"""The port's Mamba2 blocks (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) and the naive recurrence.

Mirrors ``tests/test_ssm.py`` on the port's ``ssd_chunked`` and
``causal_conv`` (the chunked scan against the direct recurrence, chunk
invariance, the state carried across calls, the conv against numpy and
streamed), and holds each function against JAX's own on the same numpy
inputs. ``mamba_block`` and ``mamba_decode_step`` match JAX's at f32,
with ``A_log``, ``dt_bias``, ``Dskip`` and ``gnorm`` (which init to
constants) given values of their own. Tolerances: rtol = atol = 1e-4
against the recurrence (as the JAX tests), 2e-4 between chunkings, 1e-5
against JAX.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.models.ssm import (causal_conv, mamba_block,
                                    mamba_decode_step, softplus, ssd_chunked)

torch.set_num_threads(1)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)


def naive_ssd(x, dt, A, Bm, Cm):
    """Direct recurrence: S_j = exp(dt_j A) S_{j-1} + dt_j B_j x_j^T."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    S = np.zeros((b, h, p, n), np.float64)
    ys = []
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    for j in range(s):
        decay = np.exp(dt[:, j] * A[None, :])              # (b, h)
        outer = np.einsum("bh,bhp,bn->bhpn", dt[:, j], x[:, j], Bm[:, j])
        S = decay[:, :, None, None] * S + outer
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, j], S))
    return np.stack(ys, axis=1), S


def rand(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def ssd_inputs(b, s, h, p, n, seed=0, dt_scale=0.5):
    return (rand((b, s, h, p), seed),
            np.abs(rand((b, s, h), seed + 1)) * dt_scale,
            -np.abs(rand((h,), seed + 2)) - 0.1,
            rand((b, s, n), seed + 3), rand((b, s, n), seed + 4))


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("s,chunk", [(8, 4), (16, 4), (16, 16), (24, 8)])
def test_ssd_chunked_matches_naive(s, chunk):
    ins = ssd_inputs(2, s, 3, 4, 5)
    y, S = ssd_chunked(*t(*ins), chunk)
    y_ref, S_ref = naive_ssd(*ins)
    close(y, y_ref, rtol=1e-4, atol=1e-4)
    close(S, S_ref, rtol=1e-4, atol=1e-4)
    jy, jS = jssm.ssd_chunked(*j(*ins), chunk)
    close(y, jy, **JAX_TOL)
    close(S, jS, **JAX_TOL)


# tests/test_ssm.py draws (chunk, seed) with hypothesis; here a fixed grid
@pytest.mark.parametrize("seed", [0, 17, 50])
@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
def test_ssd_chunk_invariance(chunk, seed):
    ins = ssd_inputs(1, 16, 2, 3, 4, seed=seed, dt_scale=0.3)
    y1, S1 = ssd_chunked(*t(*ins), chunk)
    y2, S2 = ssd_chunked(*t(*ins), 16)
    close(y1, y2.numpy(), rtol=2e-4, atol=2e-4)
    close(S1, S2.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_state_carry_across_calls():
    """[0:8) then [8:16) with the carried state equals one 16-step pass
    (the prefill-continuation invariant), and JAX's carried call."""
    x, dt, A, Bm, Cm = t(*ssd_inputs(1, 16, 2, 3, 4, dt_scale=0.3))
    y_full, S_full = ssd_chunked(x, dt, A, Bm, Cm, 4)
    y1, S1 = ssd_chunked(x[:, :8], dt[:, :8], A, Bm[:, :8], Cm[:, :8], 4)
    y2, S2 = ssd_chunked(x[:, 8:], dt[:, 8:], A, Bm[:, 8:], Cm[:, 8:], 4,
                         state0=S1)
    close(torch.cat([y1, y2], 1), y_full.numpy(), rtol=2e-4, atol=2e-4)
    close(S2, S_full.numpy(), rtol=2e-4, atol=2e-4)
    jx, jdt, jA, jB, jC = j(*(a.numpy() for a in (x, dt, A, Bm, Cm)))
    jy2, jS2 = jssm.ssd_chunked(jx[:, 8:], jdt[:, 8:], jA, jB[:, 8:],
                                jC[:, 8:], 4, state0=jnp.asarray(S1.numpy()))
    close(y2, jy2, **JAX_TOL)
    close(S2, jS2, **JAX_TOL)


def test_ssd_chunked_needs_whole_chunks():
    """A sequence that is not a whole number of chunks raises, as JAX's
    reshape does; nothing is padded."""
    ins = ssd_inputs(1, 20, 2, 3, 4)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssd_chunked(*t(*ins), 8)
    with pytest.raises(TypeError):
        jssm.ssd_chunked(*j(*ins), 8)


def test_causal_conv_matches_numpy():
    b, s, c, dc = 2, 10, 3, 4
    x, w = rand((b, s, c), 0), rand((dc, c), 1)
    y, hist = causal_conv(*t(x, w))
    xp = np.concatenate([np.zeros((b, dc - 1, c)), x], 1)
    ref = sum(xp[:, i:i + s] * w[i][None, None] for i in range(dc))
    close(y, ref, rtol=1e-5, atol=1e-6)
    close(hist, xp[:, -(dc - 1):], rtol=1e-6, atol=0)
    jy, jh = jssm.causal_conv(*j(x, w))
    close(y, jy, rtol=0, atol=0)        # the same sum in the same order
    close(hist, jh, rtol=0, atol=0)


def test_causal_conv_streaming_equivalence():
    """Token-by-token conv with carried history == full-sequence conv."""
    b, s, c, dc = 1, 9, 2, 4
    x, w = t(rand((b, s, c), 0), rand((dc, c), 1))
    y_full, _ = causal_conv(x, w)
    hist = torch.zeros((b, dc - 1, c))
    outs = []
    for i in range(s):
        y, hist = causal_conv(x[:, i:i + 1], w, hist)
        outs.append(y)
    close(torch.cat(outs, 1), y_full.numpy(), rtol=1e-5, atol=1e-6)


def test_softplus_matches_jax_softplus():
    """``logaddexp(x, 0)``, as ``jax.nn.softplus``, and its gradient, on
    both sides of ``F.softplus``'s threshold 20."""
    x = np.linspace(-40, 40, 161).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = softplus(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    close(y, jax.nn.softplus(x), rtol=1e-6, atol=0)
    close(g, jax.vmap(jax.grad(jax.nn.softplus))(x), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the blocks, at f32 from JAX's weights


def block_params(seed=0):
    """One layer of the mamba2 smoke config (JAX's init), with the
    constant-init parameters given values of their own: A_log and
    dt_bias around 0, Dskip, gnorm and ln around 1."""
    jcfg = jreg.smoke_config(jax_get_config("mamba2-2.7b"))
    arrays = jax.device_get(jreg.get_bundle(jcfg).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    lp = {}
    for k, v in arrays.items():
        if not k.startswith("layers/"):
            continue
        v = np.array(v[0])
        name = k[len("layers/"):]
        if name in ("A_log", "dt_bias", "Dskip", "gnorm", "ln"):
            base = 0.0 if name in ("A_log", "dt_bias") else 1.0
            v = (base + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
        lp[name] = v
    cfg = registry.smoke_config(get_config("mamba2-2.7b"))
    return jcfg, {k: jnp.asarray(v) for k, v in lp.items()}, cfg, {
        k: torch.from_numpy(v) for k, v in lp.items()}


@pytest.mark.parametrize("s", [16, 48])
def test_mamba_block_matches_jax(s):
    """One block over s tokens (chunk 16: one and three chunks), fresh and
    continuing from a carried state and conv tails."""
    jcfg, jlp, cfg, lp = block_params()
    x = rand((2, s, cfg.d_model), 5)
    out, (st, hx, hb, hc) = mamba_block(lp, cfg, torch.from_numpy(x))
    jout, (jst, jhx, jhb, jhc) = jssm.mamba_block(jlp, jcfg, jnp.asarray(x))
    for a, b in ((out, jout), (st, jst), (hx, jhx), (hb, jhb), (hc, jhc)):
        close(a, b, **JAX_TOL)
    x2 = rand((2, 16, cfg.d_model), 6)
    out2, _ = mamba_block(lp, cfg, torch.from_numpy(x2), (st, hx, hb, hc))
    jout2, _ = jssm.mamba_block(jlp, jcfg, jnp.asarray(x2),
                                (jst, jhx, jhb, jhc))
    close(out2, jout2, **JAX_TOL)


def test_mamba_decode_step_matches_jax_and_the_block():
    """Three decode steps from a prefilled state against JAX's, and
    against the block run over the whole sequence."""
    jcfg, jlp, cfg, lp = block_params(1)
    x = rand((2, 19, cfg.d_model), 7)
    _, (st, hx, hb, hc) = mamba_block(lp, cfg, torch.from_numpy(x[:, :16]))
    _, (jst, jhx, jhb, jhc) = jssm.mamba_block(jlp, jcfg,
                                               jnp.asarray(x[:, :16]))
    outs = []
    for i in range(16, 19):
        xi = x[:, i:i + 1]
        out, (st, (hx, hb, hc)) = mamba_decode_step(
            lp, cfg, torch.from_numpy(xi), st, (hx, hb, hc))
        jout, (jst, (jhx, jhb, jhc)) = jssm.mamba_decode_step(
            jlp, jcfg, jnp.asarray(xi), jst, (jhx, jhb, jhc))
        assert st.dtype == torch.float32
        close(out, jout, **JAX_TOL)
        close(st, jst, **JAX_TOL)
        outs.append(out)
    # 19 tokens are not whole chunks of 16: hold the three steps against
    # the block continued over those three tokens from the same state
    cont, _ = mamba_block(lp, cfg, torch.from_numpy(x[:, 16:19]),
                          mamba_block(lp, cfg, torch.from_numpy(x[:, :16]))[1])
    close(torch.cat(outs, 1), cont.numpy(), rtol=1e-4, atol=1e-4)


def test_long_chunk_masks_exp_overflow_in_the_forward():
    """Over a 256-token chunk at A = -1, dt ~ 0.69, cum_i - cum_j reaches
    ~177 above the diagonal, where f32's exp overflows to inf; the mask
    takes it out of the forward in both packages (the gradient through
    it is NaN in both: ROADMAP)."""
    b, s, h, p, n = 1, 256, 2, 2, 3
    x, _, _, Bm, Cm = ssd_inputs(b, s, h, p, n, seed=3)
    dt = np.full((b, s, h), np.log(2.0), np.float32)    # softplus(0)
    A = -np.ones((h,), np.float32)
    y, S = ssd_chunked(*t(x, dt, A, Bm, Cm), 256)
    jy, jS = jssm.ssd_chunked(*j(x, dt, A, Bm, Cm), 256)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    close(y, jy, **JAX_TOL)
    close(S, jS, **JAX_TOL)
    y_ref, _ = naive_ssd(x, dt, A, Bm, Cm)
    close(y, y_ref, rtol=1e-4, atol=1e-4)
