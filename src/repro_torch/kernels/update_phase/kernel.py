"""The dense Update phase on Hopper: two kernel wrappers and their plain
versions, for the three Pallas kernels of
``src/repro/kernels/update_phase/kernel.py``.

Each wrapper launches its kernel (``csrc/update_phase.cu``) for CUDA
tensors and raises if it cannot; for CPU tensors it runs the plain
PyTorch version beside it. Each counts its launches in ``.launches``.
All arrays carry a leading batch axis B (one network per row).

* ``winner_lock_min`` replaces ``_lock_kernel`` (``:68``): per unit, the
  least priority among the signals it won (``BIG_PRIO`` where none). One
  launch, no global atomics: each block keeps a tile of up to 8192 units
  of one network in shared memory, reads the network's whole
  ``(wid, prio)`` row and takes a shared-memory ``atomicMin`` for the
  winners in its tile (a larger pool takes several tiles). min commutes,
  so the result is exact and repeatable. Bound: 8 bytes per signal in, 4
  per unit out (0.08 MB at M = 8192, C = 4096, 0.02 us at 3.35 TB/s):
  the launch is the cost.
* ``update_accum`` replaces ``_update_accum_kernel`` (``:124``) and
  ``_edge_age_kernel`` (``:272``): the winner pull ``w1 = w + scale_b
  (x_winner - w)`` (a copy: winners are distinct after the lock),
  ``nsc = sum scale_n``, ``nsx = sum scale_n x`` over the neighbor slots
  that point at each unit, ``err = sum d2b`` over selected winners, the
  habituation decrements, the winner indicator, and the aged edge table
  ``age + (win + winat) valid (1 - prot protat)``, 0 on the slots of the
  edges (winner, second) of the adapting signals. Two launches: a
  scatter of each selected signal's id into the ``owner`` scratch, then
  one group of lanes per unit, one lane per slot of its ``nbr`` row,
  launched so that it overlaps the scatter (programmatic dependent
  launch). The scratch is not cleared: ``o = owner[c]`` counts only if
  ``0 <= o < M``, ``sel[o]`` and ``wid[o] == c``, which no stale value
  can pass while the selected signals have distinct winners (the lock's
  precondition). No float atomics: each lane finds its unit in its
  neighbor's row and stages that slot's pull, and the sums run in slot
  order, which relies on the symmetric-edge invariant (the plain version
  scatters by ``nbr[wid]`` and does not). The same lane ages its slot
  from the validated owners of its unit and of its neighbor and their
  ``sid``: the winner-second reset is exact because adapting signals
  have distinct winners, and aging does not rely on symmetric edges.
  Bound: about 1.1 MB that the function needs at M = 8192, C = 4096,
  K = 16 (0.33 us); the two launches and a chain of about five dependent
  L2 loads per unit cost more.
"""
from __future__ import annotations

import torch

from repro_torch.core.gson.batch import add, put, take
from repro_torch.core.gson.topology import edge_slots
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
# B3 + B4. per-unit accumulators and edge aging


def update_accum_plain(x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n,
                       dec_n, nbr, w, sid, age, stable):
    """Plain version of :func:`update_accum` (same arguments and
    results). Scatters into the units named by ``nbr[wid]``; it does not
    rely on symmetric edges. Sums with several contributors are
    scatter-adds, whose order on a CUDA tensor varies from run to run
    (float atomics): ulp differences in ``nsc``/``nsx``/``decn_u``. The
    aged table is :func:`edge_age_plain` with the reset of
    ``edge_slots(nbr, wid, sid, adapt)``."""
    C = nbr.shape[1]
    a_idx = (torch.where(adapt, wid, C),)
    s_idx = (torch.where(sel, wid, C),)
    wc = wid.clamp(0, C - 1).long()
    zeros = torch.zeros_like(w[..., 0])
    w_wc = take(w, wc)

    w1 = put(w, a_idx, w_wc + scale_b[..., None] * (x - w_wc))
    err = put(zeros, s_idx, d2b)
    wind = put(zeros, s_idx, 1.0)
    decb_u = put(zeros, a_idx, dec_b)

    nb = take(nbr, wc)                                         # (B, M, K)
    tgt = (torch.where((nb >= 0) & adapt[..., None], nb, C),)
    nsc = add(zeros, tgt, scale_n)
    decn_u = add(zeros, tgt, dec_n)
    nsx = add(torch.zeros_like(w), tgt,
              scale_n[..., None] * x[..., None, :])
    aged = edge_age_plain(age, nbr, wind > 0.0, stable,
                          edge_slots(nbr, wid, sid, adapt))
    return w1, nsc, nsx, err, decb_u, decn_u, wind, aged


def edge_age_plain(age, nbr, win, stable, reset):
    """Plain version of the aging half: age (B, C, K) f32, nbr (B, C, K)
    i32, win, stable (B, C) bool, reset (B, C, K) bool -> (B, C, K) f32:
    winner rows and the slots that point at a winner age by one each
    (stable-stable edges do not age), then the reset slots are 0."""
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


def update_accum(x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
                 nbr, w, sid, age, stable):
    """Fused per-unit accumulators and edge aging of the dense Update
    phase.

    x (B, M, d) f32; wid (B, M) i32; sel, adapt (B, M) bool; scale_b, d2b,
    dec_b (B, M) f32; scale_n, dec_n (B, M, K) f32, zero on invalid slots;
    nbr (B, C, K) i32; w (B, C, d) f32; sid (B, M) i32; age (B, C, K) f32;
    stable (B, C) bool -> ``(w1, nsc, nsx, err, decb_u, decn_u, wind,
    age)``: (B, C, d), (B, C), (B, C, d), four (B, C) and (B, C, K), all
    f32.
    """
    if x.device.type == "cpu":
        return update_accum_plain(x, wid, sel, adapt, scale_b, d2b, dec_b,
                                  scale_n, dec_n, nbr, w, sid, age, stable)
    B, M, D = x.shape
    C, K = nbr.shape[1:]
    dev = x.device
    f32 = torch.float32
    _build.check("x", x, f32, (B, M, D), dev)
    for name, t in (("wid", wid), ("sid", sid)):
        _build.check(name, t, torch.int32, (B, M), dev)
    for name, t in (("sel", sel), ("adapt", adapt)):
        _build.check(name, t, torch.bool, (B, M), dev)
    for name, t in (("scale_b", scale_b), ("d2b", d2b), ("dec_b", dec_b)):
        _build.check(name, t, f32, (B, M), dev)
    for name, t in (("scale_n", scale_n), ("dec_n", dec_n)):
        _build.check(name, t, f32, (B, M, K), dev)
    _build.check("nbr", nbr, torch.int32, (B, C, K), dev)
    _build.check("w", w, f32, (B, C, D), dev)
    _build.check("age", age, f32, (B, C, K), dev)
    _build.check("stable", stable, torch.bool, (B, C), dev)
    if not 1 <= D <= 8:
        raise ValueError(f"update_accum kernel takes 1 <= dim <= 8, got {D}")
    # any contents: the kernel validates every entry it reads
    owner = torch.empty((B, C), dtype=torch.int32, device=dev)
    w1 = torch.empty((B, C, D), dtype=f32, device=dev)
    nsx = torch.empty((B, C, D), dtype=f32, device=dev)
    nsc, err, decb_u, decn_u, wind = (
        torch.empty((B, C), dtype=f32, device=dev) for _ in range(5))
    aged = torch.empty_like(age)
    _build.launch(
        "update_phase", "repro_update_accum",
        [x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n, dec_n, nbr, w,
         sid, age, stable, owner, w1, nsc, nsx, err, decb_u, decn_u, wind,
         aged], [B, M, C, K, D])
    update_accum.launches += 1
    return w1, nsc, nsx, err, decb_u, decn_u, wind, aged


update_accum.launches = 0
