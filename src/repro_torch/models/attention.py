"""Attention of the port: blockwise (online-softmax) prefill/forward and
single-step decode against a replicated or a sequence-sharded cache
(``repro.models.attention``'s counterparts).

Plain PyTorch, the JAX code's own computation: q, k and v go to f32, q
is scaled by 1/sqrt(d) before the dot, masked logits take ``NEG``, and
the blockwise form runs the same loop over KV chunks with a running
(max, denominator, accumulator), so memory stays linear in the sequence
length. No library attention kernel stands in: it would keep q, k and v
in bf16, a different function. The JAX package names a Pallas
``kernels/flash_attention`` kernel that is not in its tree; its LM
attention is plain jnp, so there is no TPU kernel to port here.

``flash_decode`` decodes against a KV cache sequence-sharded over a
mesh axis (flash-decoding): each rank computes a partial softmax over its
slice of the cache, and the shards merge through an ``all_reduce`` of the
maxima (MAX) and of the corrected sums and outputs (SUM) over the axis's
group, as JAX's ``pmax``/``psum``: collective volume O(B*H*D) per step.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

NEG = -1e30


@functools.lru_cache(maxsize=None)
def _scale(d: int) -> float:
    """1/sqrt(d) rounded to f32, as JAX computes it."""
    return float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        chunk: int = 512, causal: bool = True,
                        q_offset=0) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,KV,D); GQA via head grouping.

    Returns (B,S,H,D) in q's dtype. ``q_offset``: global position of
    q[0] (for prefill continuation); an int or a 0-d tensor.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    dev = q.device
    qg = q.reshape(b, s, kv, g, d).float() * _scale(d)
    nc = -(-t // chunk)
    tp = nc * chunk
    if tp != t:
        pad = (0, 0, 0, 0, 0, tp - t)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    pos_q = q_offset + torch.arange(s, device=dev)
    ar = torch.arange(chunk, device=dev)

    m = torch.full((b, s, kv, g), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, kv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kv, g, d), dtype=torch.float32, device=dev)
    for j in range(nc):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        logits = torch.einsum("bskgd,btkd->bskgt", qg, kj)
        pos_k = j * chunk + ar
        if causal:
            ok = pos_k[None, :] <= pos_q[:, None]
        else:
            ok = (pos_k[None, :] < t).expand(s, chunk)
        ok = ok & (pos_k < t)[None, :]
        logits = torch.where(ok[None, :, None, None, :], logits, NEG)
        mj = logits.amax(dim=-1)
        m_new = torch.maximum(m, mj)
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """Single-step decode, replicated cache. q: (B,1,H,D); k,v: (B,T,KV,D);
    length: (B,) number of valid cache positions."""
    b, _, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d).float() * _scale(d)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float())
    ok = torch.arange(t, device=q.device)[None, :] < length[:, None]
    logits = torch.where(ok[:, None, None, :], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)



def flash_decode(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, seq_axis: str = "model"
                 ) -> torch.Tensor:
    """Decode with the KV cache sequence-sharded over ``seq_axis``.
    Collective over that axis's group.

    The arguments are this rank's blocks, in the caller's batch layout
    (the cache's rows; JAX's rule that the batch falls back to replicated
    when ``q.shape[0]`` does not divide the batch axes is a layout, which
    the caller's cache specs fix): q (b, 1, H, D) its rows, k and v (b,
    T/n, KV, D) its rows of seq shard ``mesh.index(seq_axis)`` of n,
    length (b,). Masked logits take ``NEG``, so a shard with no valid
    position stays finite and weighs exp(NEG - max) = 0 in the merge.
    Over one shard there is nothing to merge, and the softmax is
    ``decode_attention``'s: a one-rank mesh decodes bitwise as no mesh
    (the merge's other rounding flips near-ties of bf16 greedy decoding)."""
    from repro_torch.models import placement
    if mesh.size(seq_axis) == 1:
        return decode_attention(q, k, v, length)
    b, _, h, d = q.shape
    t_l, kv = k.shape[1], k.shape[2]
    g = h // kv
    shard = mesh.index(seq_axis)
    qg = q.reshape(b, kv, g, d).float() * _scale(d)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float())
    pos = shard * t_l + torch.arange(t_l, device=q.device)
    ok = pos[None, :] < length[:, None]
    logits = torch.where(ok[:, None, None, :], logits, NEG)
    m_loc = logits.amax(dim=-1)                               # (b,kv,g)
    p = torch.exp(logits - m_loc[..., None])
    p = torch.where(ok[:, None, None, :], p, 0.0)
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    m_g = placement.reduce(m_loc, mesh, seq_axis, dist.ReduceOp.MAX)
    corr = torch.exp(m_loc - m_g)
    l_g = placement.reduce(l_loc * corr, mesh, seq_axis)
    o_g = placement.reduce(o_loc * corr[..., None], mesh, seq_axis)
    out = o_g / l_g.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)
