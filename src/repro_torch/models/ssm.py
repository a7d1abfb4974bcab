"""Mamba2 blocks of the port (SSD, state-space duality): the chunked scan
and the O(1) decode step (``repro.models.ssm``'s counterparts).

The SSD form splits the sequence into chunks: within a chunk the
interactions are a masked, decay-weighted quadratic form; across chunks
information flows through a small carried state (B, H, P, N). A Python
loop over the chunks takes the place of ``lax.scan``, so the (B, Q, Q, H)
intra-chunk tensor exists for one chunk at a time. The sequence must be
a whole number of chunks (``mamba_block`` takes ``min(ssm_chunk, S)``):
any other length raises, as in JAX; nothing is padded.

The casts are JAX's, op for op: the projections and the depthwise conv
run in the compute dtype (the conv is JAX's Python sum of ``dc`` shifted
products, not ``conv1d``, whose cuDNN path would take another summation
order and TF32), ``dt`` and ``A`` in f32 with ``softplus`` =
``logaddexp(x, 0)`` (``F.softplus`` turns into the identity above 20),
the scan in f32 cast back to the input's dtype, and the decode step's
state in f32.

The intra-chunk decay is ``where(i >= j, exp(cum_i - cum_j), 0)`` as in
JAX: above the diagonal ``exp`` may overflow to ``inf`` on a long chunk,
which the ``where`` masks in the forward; the gradient through it is
then NaN in both packages (0 * inf). It is kept so, on purpose.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, ParamSet, rms_norm, silu


def ssm_param_defs(ps: ParamSet, cfg: ModelConfig, prefix: str = "layers"):
    L, D = cfg.n_layers, cfg.d_model
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dc = cfg.ssm_conv
    ps.add(f"{prefix}/ln", (L, D), ("layer", "none"), init="ones")
    ps.add(f"{prefix}/wz", (L, D, di), ("layer", "embed", "ssm_heads"))
    ps.add(f"{prefix}/wx", (L, D, di), ("layer", "embed", "ssm_heads"))
    ps.add(f"{prefix}/wB", (L, D, N), ("layer", "embed", "ssm_state"))
    ps.add(f"{prefix}/wC", (L, D, N), ("layer", "embed", "ssm_state"))
    ps.add(f"{prefix}/wdt", (L, D, H), ("layer", "embed", "ssm_heads"))
    ps.add(f"{prefix}/conv_x", (L, dc, di), ("layer", "conv", "ssm_heads"),
           scale=0.5)
    ps.add(f"{prefix}/conv_B", (L, dc, N), ("layer", "conv", "ssm_state"),
           scale=0.5)
    ps.add(f"{prefix}/conv_C", (L, dc, N), ("layer", "conv", "ssm_state"),
           scale=0.5)
    ps.add(f"{prefix}/A_log", (L, H), ("layer", "ssm_heads"), init="zeros")
    ps.add(f"{prefix}/Dskip", (L, H), ("layer", "ssm_heads"), init="ones")
    ps.add(f"{prefix}/dt_bias", (L, H), ("layer", "ssm_heads"),
           init="zeros")
    ps.add(f"{prefix}/gnorm", (L, di), ("layer", "ssm_heads"), init="ones")
    ps.add(f"{prefix}/wo", (L, di, D), ("layer", "ssm_heads", "embed"))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                hist: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,C), w: (dc,C). hist: (B,dc-1,C).
    Returns (y (B,S,C), the new history (B,dc-1,C))."""
    dc = w.shape[0]
    if hist is None:
        hist = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([hist, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i][None, None, :] for i in range(dc))
    new_hist = xp[:, -(dc - 1):] if dc > 1 else hist
    return y, new_hist


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                state0: torch.Tensor | None = None):
    """SSD scan. x: (B,S,H,P); dt: (B,S,H); A: (H,) (<0 decay rates);
    Bm, Cm: (B,S,N). Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) in f32).

    Recurrence: S_j = exp(dt_j A) S_{j-1} + dt_j B_j x_j^T; y_j = C_j S_j.
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"a sequence of {s} is not a whole number of "
                         f"chunks of {chunk}")
    nc, q = s // chunk, chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    bc = Bm.reshape(b, nc, q, n).to(f32)
    cc = Cm.reshape(b, nc, q, n).to(f32)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    A = A.to(f32)

    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if state0 is None else state0.to(f32))
    ys = []
    for c in range(nc):
        x_c, dt_c, b_c, c_c = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        loga = dt_c * A[None, None, :]                      # (b,q,h)
        cum = torch.cumsum(loga, dim=1)                     # inclusive
        # intra-chunk: (C_i . B_j) exp(cum_i - cum_j) dt_j  for i >= j
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (b,i,j,h)
        L = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        L = L * dt_c[:, None, :, :]
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        m = cb[:, :, :, None] * L                           # (b,i,j,h)
        y = torch.einsum("bijh,bjhp->bihp", m, x_c)
        # inter-chunk: y_i += (C_i . S0) exp(cum_i)
        y_int = torch.einsum("bqn,bhpn->bqhp", c_c, state)
        y = y + y_int * torch.exp(cum)[..., None]
        # the state handed to the next chunk
        w_end = torch.exp(cum[:, -1:, :] - cum) * dt_c     # (b,q,h)
        s_p = torch.einsum("bjh,bjn,bjhp->bhpn", w_end, b_c, x_c)
        state = torch.exp(cum[:, -1, :])[:, :, None, None] * state + s_p
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), state


def _project(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    """(residual, z, xs, B, C, dt_raw): the block's input projections in
    the compute dtype."""
    dt_ = x.dtype
    xh = rms_norm(x, lp["ln"], cfg.norm_eps)
    return (xh @ lp["wz"].to(dt_), xh @ lp["wx"].to(dt_),
            xh @ lp["wB"].to(dt_), xh @ lp["wC"].to(dt_),
            xh @ lp["wdt"].to(dt_))


def _gated_out(lp: dict, cfg: ModelConfig, res, y, z):
    y = rms_norm(y * silu(z), lp["gnorm"], cfg.norm_eps)
    return res + y @ lp["wo"].to(res.dtype)


def mamba_block(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                prefix_state: tuple | None = None):
    """One mamba2 block over the full sequence. Returns (out,
    (ssm_state, hx, hb, hc))."""
    b, s, _ = x.shape
    h_, p_ = cfg.ssm_heads, cfg.ssm_headdim
    dt_ = x.dtype
    z, xs, bm, cm, dt_raw = _project(lp, cfg, x)
    if prefix_state is None:
        hx = hb = hc = None
        state0 = None
    else:
        state0, hx, hb, hc = prefix_state
    xs, hx = causal_conv(xs, lp["conv_x"].to(dt_), hx)
    bm, hb = causal_conv(bm, lp["conv_B"].to(dt_), hb)
    cm, hc = causal_conv(cm, lp["conv_C"].to(dt_), hc)
    xs, bm, cm = silu(xs), silu(bm), silu(cm)

    dt = softplus(dt_raw.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xsh = xs.reshape(b, s, h_, p_)
    # dt_j is absorbed inside ssd_chunked's decay kernel: no pre-scaling
    y, state = ssd_chunked(xsh, dt, A, bm, cm, min(cfg.ssm_chunk, s), state0)
    y = y + lp["Dskip"].to(dt_)[None, None, :, None] * xsh
    out = _gated_out(lp, cfg, x, y.reshape(b, s, -1), z)
    return out, (state, hx, hb, hc)


def mamba_decode_step(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: torch.Tensor, conv_hist: tuple,
                      heads: slice | None = None, join=None):
    """O(1) single-token step. x: (B,1,D); state: (B,H,P,N) f32;
    conv_hist: (hx, hb, hc) each (B, dc-1, C). Returns (out, (state,
    (hx, hb, hc))), all new tensors.

    ``heads`` (a slice of the H heads; all by default): the heads whose
    state this call holds and updates, ``state`` then (B, h, P, N) and
    ``hx`` the conv tail of their channels (B, dc-1, h*P); ``join`` takes
    the y of those heads, (B, h, P), to all heads' (a mesh's gather over
    the heads' axis). Heads are independent up to the gated norm, so
    this is the whole step's value."""
    b = x.shape[0]
    p_ = cfg.ssm_headdim
    hs = heads if heads is not None else slice(0, cfg.ssm_heads)
    ch = slice(hs.start * p_, hs.stop * p_)
    h_ = hs.stop - hs.start
    dt_ = x.dtype
    f32 = torch.float32
    z, xs, bm, cm, dt_raw = _project(lp, cfg, x)
    hx, hb, hc = conv_hist
    xs, hx = causal_conv(xs[..., ch], lp["conv_x"][:, ch].to(dt_), hx)
    bm, hb = causal_conv(bm, lp["conv_B"].to(dt_), hb)
    cm, hc = causal_conv(cm, lp["conv_C"].to(dt_), hc)
    xs, bm, cm = silu(xs), silu(bm), silu(cm)

    dt = softplus(dt_raw[..., hs].float()
                  + lp["dt_bias"][hs].float())[:, 0]             # (B,h)
    A = -torch.exp(lp["A_log"][hs].float())
    a = torch.exp(dt * A[None, :])                               # (B,h)
    xv = xs[:, 0].reshape(b, h_, p_).to(f32) * dt[..., None]
    outer = torch.einsum("bhp,bn->bhpn", xv, bm[:, 0].to(f32))
    state = a[:, :, None, None] * state + outer
    y = torch.einsum("bn,bhpn->bhp", cm[:, 0].to(f32), state)
    y = y.to(dt_) + lp["Dskip"][hs].to(dt_)[None, :, None] \
        * xs[:, 0].reshape(b, h_, p_)
    if join is not None:
        y = join(y)
    out = _gated_out(lp, cfg, x, y.reshape(b, 1, -1), z)
    return out, (state, (hx, hb, hc))
