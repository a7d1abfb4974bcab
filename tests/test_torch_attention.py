"""The port's attention (``repro_torch.models.attention``) against the
JAX package's, on the same numpy inputs in f32: blockwise attention for
MHA and GQA, sequence lengths on and off the chunk grid, causal and not,
continued at a ``q_offset``; decode attention with ragged lengths. Plus
the port's own mirrors of ``tests/test_attention.py``'s checks.
Tolerance: rtol = atol = 1e-5."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as attn

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def arr(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# (s, t, h, kv, d, chunk): MHA and GQA at h/kv = 1, 2, 4; t on the chunk
# grid and off it; a chunk longer than the sequence
CASES = [
    (16, 16, 4, 4, 8, 4),
    (33, 33, 4, 2, 8, 16),
    (24, 24, 8, 2, 16, 8),
    (17, 17, 2, 2, 4, 32),
    (12, 40, 8, 4, 8, 16),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t,h,kv,d,chunk", CASES)
def test_blockwise_matches_jax(s, t, h, kv, d, chunk, causal):
    q, k, v = arr((2, s, h, d), 0), arr((2, t, kv, d), 1), arr((2, t, kv, d), 2)
    (jq, jk, jv), (tq, tk, tv) = both(q, k, v)
    ref = jattn.blockwise_attention(jq, jk, jv, chunk=chunk, causal=causal)
    out = attn.blockwise_attention(tq, tk, tv, chunk=chunk, causal=causal)
    assert out.dtype == torch.float32 and out.shape == (2, s, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("q_offset", [4, 8, 13])
def test_blockwise_q_offset_matches_jax(q_offset):
    s, t = 16 - q_offset, 16
    q, k, v = arr((2, s, 4, 8), 3), arr((2, t, 2, 8), 4), arr((2, t, 2, 8), 5)
    (jq, jk, jv), (tq, tk, tv) = both(q, k, v)
    ref = jattn.blockwise_attention(jq, jk, jv, chunk=4, causal=True,
                                    q_offset=q_offset)
    out = attn.blockwise_attention(tq, tk, tv, chunk=4, causal=True,
                                   q_offset=torch.tensor(q_offset))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])
def test_decode_ragged_lengths_match_jax(h, kv):
    q, k, v = arr((3, 1, h, 8), 6), arr((3, 20, kv, 8), 7), arr((3, 20, kv, 8), 8)
    length = np.asarray([1, 9, 20], np.int32)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = both(q, k, v, length)
    ref = jattn.decode_attention(jq, jk, jv, jl)
    out = attn.decode_attention(tq, tk, tv, tl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# mirrors of tests/test_attention.py, on the port alone


def naive_attention(q, k, v, causal=True):
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bskgt", qg, k) / d ** 0.5
    if causal:
        mask = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
        logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bskgt,btkd->bskgd", p, v).reshape(b, s, h, d)


def rand(shape, seed):
    return torch.from_numpy(arr(shape, seed))


@pytest.mark.parametrize("s,h,kv,d,chunk", [
    (16, 4, 4, 8, 4), (33, 4, 2, 8, 16), (64, 8, 1, 16, 64), (17, 2, 2, 4, 32)])
def test_blockwise_matches_naive(s, h, kv, d, chunk):
    q, k, v = rand((2, s, h, d), 0), rand((2, s, kv, d), 1), rand((2, s, kv, d), 2)
    out = attn.blockwise_attention(q, k, v, chunk=chunk, causal=True)
    torch.testing.assert_close(out, naive_attention(q, k, v), **TOL)


@pytest.mark.parametrize("s,chunk,causal", [
    (2, 4, True), (9, 4, False), (23, 8, True), (40, 16, False), (31, 64, True)])
def test_chunk_invariance(s, chunk, causal):
    q, k, v = rand((1, s, 4, 8), s), rand((1, s, 2, 8), s + 1), rand((1, s, 2, 8), s + 2)
    a = attn.blockwise_attention(q, k, v, chunk=chunk, causal=causal)
    b = attn.blockwise_attention(q, k, v, chunk=s, causal=causal)
    torch.testing.assert_close(a, b, **TOL)


def test_causality():
    q, k, v = rand((1, 8, 2, 4), 0), rand((1, 8, 2, 4), 1), rand((1, 8, 2, 4), 2)
    out1 = attn.blockwise_attention(q, k, v, chunk=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, 5:] = 9.0
    v2[:, 5:] = -9.0
    out2 = attn.blockwise_attention(q, k2, v2, chunk=4)
    torch.testing.assert_close(out1[:, :5], out2[:, :5], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(out1[:, 5:], out2[:, 5:])


def test_decode_matches_blockwise_last_position():
    s = 12
    q, k, v = rand((2, s, 4, 8), 0), rand((2, s, 2, 8), 1), rand((2, s, 2, 8), 2)
    full = attn.blockwise_attention(q, k, v, chunk=8, causal=True)
    out = attn.decode_attention(q[:, -1:], k, v,
                                torch.full((2,), s, dtype=torch.int32))
    torch.testing.assert_close(out[:, 0], full[:, -1], **TOL)


def test_decode_respects_length_mask():
    q, k, v = rand((1, 1, 2, 4), 0), rand((1, 16, 2, 4), 1), rand((1, 16, 2, 4), 2)
    n = torch.tensor([8], dtype=torch.int32)
    out8 = attn.decode_attention(q, k, v, n)
    k2, v2 = k.clone(), v.clone()
    k2[:, 8:] = 99.0
    v2[:, 8:] = -99.0
    torch.testing.assert_close(attn.decode_attention(q, k2, v2, n), out8,
                               rtol=1e-6, atol=1e-6)


def test_q_offset_continuation():
    s = 16
    q, k, v = rand((1, s, 2, 8), 0), rand((1, s, 2, 8), 1), rand((1, s, 2, 8), 2)
    full = attn.blockwise_attention(q, k, v, chunk=4, causal=True)
    half = attn.blockwise_attention(q[:, 8:], k, v, chunk=4, causal=True,
                                    q_offset=8)
    torch.testing.assert_close(half, full[:, 8:], **TOL)


def test_bf16_inputs_return_bf16():
    q, k, v = (rand((1, 5, 4, 8), i).to(torch.bfloat16) for i in range(3))
    assert attn.blockwise_attention(q, k, v, chunk=4).dtype == torch.bfloat16
    out = attn.decode_attention(q[:, -1:], k, v, torch.tensor([5]))
    assert out.dtype == torch.bfloat16
