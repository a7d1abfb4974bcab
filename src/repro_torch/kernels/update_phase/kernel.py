"""The dense Update phase on Hopper: three kernel wrappers and their
plain versions.

Each wrapper launches its kernel (``csrc/update_phase.cu``) for CUDA
tensors and raises if it cannot; for CPU tensors it runs the plain
PyTorch version beside it. Each counts its launches in ``.launches``.
All arrays carry a leading batch axis B (one network per row).

* ``winner_lock_min`` replaces ``_lock_kernel``
  (``src/repro/kernels/update_phase/kernel.py:68``): per unit, the least
  priority among the signals it won (``BIG_PRIO`` where none). One
  integer ``atomicMin`` per signal: min commutes, so the result is exact
  and repeatable. Bound: 8 bytes per signal in, 4 per unit out (0.08 MB
  at M = 8192, C = 4096, 0.02 us at 3.35 TB/s): launch-bound.
* ``update_accum`` replaces ``_update_accum_kernel`` (``:124``): the
  winner pull ``w1 = w + scale_b (x_winner - w)`` (a copy: winners are
  distinct after the lock), ``nsc = sum scale_n``, ``nsx = sum
  scale_n x`` over the neighbor slots that point at each unit,
  ``err = sum d2b`` over selected winners, the habituation decrements
  and the winner indicator. No float atomics: each unit gathers its
  neighbor pulls by walking its own row of ``nbr`` in slot order, which
  relies on the symmetric-edge invariant (the plain version scatters by
  ``nbr[wid]`` and does not). Bound: about 1.5 MB moved at M = 8192,
  C = 4096, K = 16 (0.45 us): memory-bound, launch-bound in practice.
* ``edge_age`` replaces ``_edge_age_kernel`` (``:272``): ``age + (win +
  winat) valid (1 - prot protat)``, 0 where ``reset`` marks the
  winner-second slot; ``valid``, ``winat`` and ``protat`` are formed
  from ``nbr`` and the per-unit flags inside. Exact. Bound: about
  0.5 MB moved at C = 4096, K = 16 (0.15 us): launch-bound.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson.topology import scatter_add, scatter_set
from repro_torch.kernels import _build

BIG_PRIO = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# B2. winner lock


def winner_lock_min_plain(wid: torch.Tensor, prio: torch.Tensor,
                          capacity: int) -> torch.Tensor:
    """Plain version: wid, prio (B, M) i32 -> best (B, C) i32."""
    B = wid.shape[0]
    best = torch.full((B, capacity), BIG_PRIO, dtype=torch.int32,
                      device=wid.device)
    return best.scatter_reduce(1, wid.long().clamp(0, capacity - 1),
                               torch.where(wid < capacity, prio, BIG_PRIO),
                               reduce="amin")


def winner_lock_min(wid: torch.Tensor, prio: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    """Per-unit minimum priority: wid, prio (B, M) i32 (``BIG_PRIO`` on
    masked rows) -> best (B, C) i32."""
    if wid.device.type == "cpu":
        return winner_lock_min_plain(wid, prio, capacity)
    B, M = wid.shape
    dev = wid.device
    _build.check("wid", wid, torch.int32, (B, M), dev)
    _build.check("prio", prio, torch.int32, (B, M), dev)
    best = torch.empty((B, capacity), dtype=torch.int32, device=dev)
    _build.launch("update_phase", "repro_winner_lock", [wid, prio, best],
                  [B, M, capacity])
    winner_lock_min.launches += 1
    return best


winner_lock_min.launches = 0


# ---------------------------------------------------------------------------
# B3. per-unit accumulators


def update_accum_plain(x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n,
                       dec_n, nbr, w):
    """Plain version of :func:`update_accum` (same arguments and
    results). Scatters into the units named by ``nbr[wid]``; it does not
    rely on symmetric edges. Sums with several contributors are
    scatter-adds, whose order on a CUDA tensor varies from run to run
    (float atomics): ulp differences in ``nsc``/``nsx``/``decn_u``."""
    outs = [[] for _ in range(7)]
    for b in range(x.shape[0]):
        for out, v in zip(outs, _accum_one(
                x[b], wid[b], sel[b], adapt[b], scale_b[b], d2b[b],
                dec_b[b], scale_n[b], dec_n[b], nbr[b], w[b])):
            out.append(v)
    return tuple(torch.stack(o) for o in outs)


def _accum_one(x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
               nbr, w):
    C = nbr.shape[0]
    a_idx = (torch.where(adapt, wid, C).long(),)
    s_idx = (torch.where(sel, wid, C).long(),)
    wc = wid.clamp(0, C - 1).long()
    zeros = torch.zeros_like(w[:, 0])

    w1 = scatter_set(w, a_idx, w[wc] + scale_b[:, None] * (x - w[wc]))
    err = scatter_set(zeros, s_idx, d2b)
    wind = scatter_set(zeros, s_idx, 1.0)
    decb_u = scatter_set(zeros, a_idx, dec_b)

    nb = nbr[wc]                                               # (M, K)
    tgt = (torch.where((nb >= 0) & adapt[:, None], nb, C).long(),)
    nsc = scatter_add(zeros, tgt, scale_n)
    decn_u = scatter_add(zeros, tgt, dec_n)
    nsx = scatter_add(torch.zeros_like(w), tgt,
                      scale_n[:, :, None] * x[:, None, :])
    return w1, nsc, nsx, err, decb_u, decn_u, wind


def update_accum(x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
                 nbr, w):
    """Fused per-unit accumulators of the dense Update phase.

    x (B, M, d) f32; wid (B, M) i32; sel, adapt (B, M) bool; scale_b, d2b,
    dec_b (B, M) f32; scale_n, dec_n (B, M, K) f32, zero on invalid slots;
    nbr (B, C, K) i32; w (B, C, d) f32 -> ``(w1, nsc, nsx, err, decb_u,
    decn_u, wind)``: (B, C, d), (B, C), (B, C, d) and four (B, C), all
    f32.
    """
    if x.device.type == "cpu":
        return update_accum_plain(x, wid, sel, adapt, scale_b, d2b, dec_b,
                                  scale_n, dec_n, nbr, w)
    B, M, D = x.shape
    C, K = nbr.shape[1:]
    dev = x.device
    f32 = torch.float32
    _build.check("x", x, f32, (B, M, D), dev)
    _build.check("wid", wid, torch.int32, (B, M), dev)
    for name, t in (("sel", sel), ("adapt", adapt)):
        _build.check(name, t, torch.bool, (B, M), dev)
    for name, t in (("scale_b", scale_b), ("d2b", d2b), ("dec_b", dec_b)):
        _build.check(name, t, f32, (B, M), dev)
    for name, t in (("scale_n", scale_n), ("dec_n", dec_n)):
        _build.check(name, t, f32, (B, M, K), dev)
    _build.check("nbr", nbr, torch.int32, (B, C, K), dev)
    _build.check("w", w, f32, (B, C, D), dev)
    if not 1 <= D <= 8:
        raise ValueError(f"update_accum kernel takes 1 <= dim <= 8, got {D}")
    owner = torch.empty((B, C), dtype=torch.int32, device=dev)
    w1 = torch.empty((B, C, D), dtype=f32, device=dev)
    nsx = torch.empty((B, C, D), dtype=f32, device=dev)
    nsc, err, decb_u, decn_u, wind = (
        torch.empty((B, C), dtype=f32, device=dev) for _ in range(5))
    _build.launch(
        "update_phase", "repro_update_accum",
        [x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n, dec_n, nbr, w,
         owner, w1, nsc, nsx, err, decb_u, decn_u, wind], [B, M, C, K, D])
    update_accum.launches += 1
    return w1, nsc, nsx, err, decb_u, decn_u, wind


update_accum.launches = 0


# ---------------------------------------------------------------------------
# B4. edge aging + winner-second refresh


def edge_age_plain(age, nbr, win, stable, reset):
    """Plain version: age (B, C, K) f32, nbr (B, C, K) i32, win, stable
    (B, C) bool, reset (B, C, K) bool -> (B, C, K) f32."""
    C = nbr.shape[1]
    valid = nbr >= 0
    safe = nbr.clamp(0, C - 1).long()
    winat = torch.gather(win, 1, safe.flatten(1)).view_as(nbr) & valid
    protat = torch.gather(stable, 1, safe.flatten(1)).view_as(nbr)
    keep = stable[:, :, None] & protat
    f32 = torch.float32
    inc = ((win[:, :, None].to(f32) + winat.to(f32)) * valid.to(f32)
           * (1.0 - keep.to(f32)))
    return torch.where(reset, 0.0, age + inc)


def edge_age(age, nbr, win, stable, reset):
    """Edge aging of winner rows and their mirrored slots (stable-stable
    edges protected), then the winner-second reset, in one pass."""
    if age.device.type == "cpu":
        return edge_age_plain(age, nbr, win, stable, reset)
    B, C, K = age.shape
    dev = age.device
    _build.check("age", age, torch.float32, (B, C, K), dev)
    _build.check("nbr", nbr, torch.int32, (B, C, K), dev)
    _build.check("win", win, torch.bool, (B, C), dev)
    _build.check("stable", stable, torch.bool, (B, C), dev)
    _build.check("reset", reset, torch.bool, (B, C, K), dev)
    out = torch.empty_like(age)
    _build.launch("update_phase", "repro_edge_age",
                  [age, nbr, win, stable, reset, out], [B, C, K])
    edge_age.launches += 1
    return out


edge_age.launches = 0
