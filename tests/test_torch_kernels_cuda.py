"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` need the card (the kernels have no CPU mode: on a
CPU tensor a wrapper runs its plain version, which the parity files hold
against the JAX package). On the H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports no JAX, so it runs where JAX is not installed.
Contract: Find Winners ids bitwise where the three nearest distances are
more than 1e-4 apart, distances within rtol=2e-4, atol=1e-5; the lock
bitwise; the fused accumulators' winner fields and aged edge table
bitwise and their neighbor sums within rtol=1e-6, atol=1e-7; every
kernel bitwise repeatable. The remaining tests run here: no fallback hides a missing
build or a tensor the kernels do not take.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import gson
from repro_torch.core.gson.multi import (find_winners_reference,
                                         multi_signal_step, stable_units,
                                         update_phase_inputs,
                                         update_phase_reference)
from repro_torch.core.gson.topology import (compute_topo_states,
                                            compute_topo_states_plain,
                                            edge_slots)
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams, init_state, stack_states
from repro_torch.gson import autotune
from repro_torch.kernels import _build
from repro_torch.kernels.topo_states import topo_states
from repro_torch.kernels.topo_states.kernel import threshold_bits
from repro_torch.kernels.find_winners import (compact_active,
                                              compact_active_plain,
                                              find_winners_top2,
                                              find_winners_top2_plain, regime)
from repro_torch.kernels.update_phase import (BIG_PRIO, edge_age_plain,
                                              update_accum,
                                              update_accum_plain,
                                              update_phase_op,
                                              winner_lock_min,
                                              winner_lock_min_plain)
from repro_torch.kernels.update_phase.sparse import update_phase_sparse

torch.set_num_threads(1)
D_TOL = dict(rtol=2e-4, atol=1e-5)
W_TOL = dict(rtol=1e-6, atol=1e-7)
ROOT = Path(__file__).resolve().parents[1]
ACCUM_FIELDS = ("w1", "nsc", "nsx", "err", "decb_u", "decn_u", "wind",
                "age")
EXACT_FIELDS = ("w1", "err", "decb_u", "wind", "age")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda "
                    "tests/test_torch_kernels_cuda.py` on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def near_tie_free(sig, w, active, eps=1e-4):
    x, u = sig.double(), w.double()
    d = (x * x).sum(1, keepdim=True) - 2 * x @ u.T + (u * u).sum(1)
    d = torch.where(active[None, :], d, math.inf)
    k = min(3, d.shape[1])
    top = torch.topk(d, k, dim=1, largest=False).values
    if k < 2:
        return torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    return (torch.diff(top, dim=1).nan_to_num(nan=math.inf) > eps).all(1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,c,d", [(1, 8192, 4096, 3), (1, 513, 1000, 3),
                                     (3, 100, 700, 5), (1, 7, 2, 3),
                                     (8, 8192, 4096, 3), (2, 2048, 32768, 3),
                                     (2, 300, 2000, 8), (1, 64, 12, 1)])
def test_find_winners_kernel_matches_plain_version(cuda_device, B, m, c, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sig = torch.randn((B, m, d), generator=g, device=cuda_device)
    w = torch.randn((B, c, d), generator=g, device=cuda_device)
    act = torch.rand((B, c), generator=g, device=cuda_device) < 0.7
    act[:, 0] = True
    before = find_winners_top2.launches
    d2k, idk = find_winners_top2(sig, w, act)
    d2k2, idk2 = find_winners_top2(sig, w, act)
    torch.cuda.synchronize()
    assert find_winners_top2.launches == before + 2
    assert torch.equal(d2k, d2k2) and torch.equal(idk, idk2)
    d2p, idp = find_winners_top2_plain(sig, w, act)
    torch.testing.assert_close(d2k, d2p, **D_TOL)
    for b in range(B):
        ok = near_tie_free(sig[b], w[b], act[b])
        assert ok.float().mean() > 0.9
        assert torch.equal(idk[b][ok], idp[b][ok])
    # the other regime gives the same answer, bitwise
    other = "few" if regime(B, m) == "many" else "many"
    d2o, ido = find_winners_top2(sig, w, act, scan=other)
    assert torch.equal(d2o, d2k) and torch.equal(ido, idk)


@pytest.mark.cuda
def test_find_winners_ties_go_to_the_lowest_id(cuda_device):
    sig = torch.zeros((1, 5, 3), device=cuda_device)
    w = torch.zeros((1, 3000, 3), device=cuda_device)     # all equidistant
    act = torch.ones((1, 3000), dtype=torch.bool, device=cuda_device)
    act[0, :7] = False
    _, ids = find_winners_top2(sig, w, act)
    assert (ids[0] == torch.tensor([7, 8], device=cuda_device)).all()


def _sparse_cases():
    """(m, C, n_active): the main path's buffer on a pool of 4096 slots,
    then the few-signal shapes at every pool size the port runs, from
    empty to full."""
    cases = [(8192, 4096, n) for n in (0, 1, 2, 300)]
    for m in (1, 2, 31, 33):
        for c in (2, 4096, 32768):
            cases += [(m, c, n) for n in dict.fromkeys((0, 1, 2, 300, c))
                      if n <= c]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["many", "few"])
@pytest.mark.parametrize("m,c,n_active", _sparse_cases())
def test_find_winners_kernel_on_sparse_pools(cuda_device, m, c, n_active,
                                             scan):
    """Pools with few active units, scattered: the kernel scans only the
    active ones, and every unit when fewer than two are active, where an
    inactive unit (+1e30) fills the top-2. Both regimes."""
    g = torch.Generator(device=cuda_device).manual_seed(n_active + c + m)
    sig = torch.randn((1, m, 3), generator=g, device=cuda_device)
    w = torch.randn((1, c, 3), generator=g, device=cuda_device)
    act = torch.zeros((1, c), dtype=torch.bool, device=cuda_device)
    where = torch.randperm(c, generator=g, device=cuda_device)[:n_active]
    act[0, where] = True
    d2k, idk = find_winners_top2(sig, w, act, scan=scan)
    d2k2, idk2 = find_winners_top2(sig, w, act, scan=scan)
    d2p, idp = find_winners_top2_plain(sig, w, act)
    assert torch.equal(d2k, d2k2) and torch.equal(idk, idk2)
    torch.testing.assert_close(d2k, d2p, **D_TOL)
    ok = near_tie_free(sig[0], w[0], act[0])
    if n_active < 2:
        assert torch.equal(idk, idp)
    else:
        if m > 2:
            assert ok.float().mean() > 0.9
        assert torch.equal(idk[0][ok], idp[0][ok])


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["many", "few"])
@pytest.mark.parametrize("m", [1, 33, 8192])
def test_find_winners_kernel_on_fleets_of_unequal_pools(cuda_device, m,
                                                        scan):
    """B = 8 networks with 0 to 4096 active units of 4096 in one call:
    each network is packed and scanned by its own count."""
    counts = [0, 1, 2, 3, 300, 1000, 4095, 4096]
    g = torch.Generator(device=cuda_device).manual_seed(m)
    sig = torch.randn((8, m, 3), generator=g, device=cuda_device)
    w = torch.randn((8, 4096, 3), generator=g, device=cuda_device)
    act = torch.zeros((8, 4096), dtype=torch.bool, device=cuda_device)
    for b, n in enumerate(counts):
        pick = torch.randperm(4096, generator=g, device=cuda_device)[:n]
        act[b, pick] = True
    d2k, idk = find_winners_top2(sig, w, act, scan=scan)
    d2p, idp = find_winners_top2_plain(sig, w, act)
    torch.testing.assert_close(d2k, d2p, **D_TOL)
    for b, n in enumerate(counts):
        if n < 2:
            assert torch.equal(idk[b], idp[b])
            continue
        ok = near_tie_free(sig[b], w[b], act[b])
        assert torch.equal(idk[b][ok], idp[b][ok])


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["many", "few"])
@pytest.mark.parametrize("m", [1, 33])
def test_find_winners_ties_across_unit_splits(cuda_device, m, scan):
    """Equidistant nearest units far apart in a full pool of 32768 (other
    partitions, other staged tiles): the two lowest ids win, whichever
    threads scanned them."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    sig = torch.zeros((1, m, 3), device=cuda_device)
    w = torch.randn((1, 32768, 3), generator=g, device=cuda_device)
    w = 2.0 * w / w.norm(dim=-1, keepdim=True)     # d2 about 4
    tie = [31000, 20000, 5000, 1500, 777, 2049, 30001]
    unit = torch.eye(3, device=cuda_device)
    for k, c in enumerate(tie):                     # |w| = 1, d2 = 1
        w[0, c] = unit[k % 3] * (1 if k % 2 else -1)
    act = torch.ones((1, 32768), dtype=torch.bool, device=cuda_device)
    d2, ids = find_winners_top2(sig, w, act, scan=scan)
    assert (ids[0] == torch.tensor([777, 1500], device=cuda_device)).all()
    assert (d2 == 1.0).all()
    act[0, 777] = False
    _, ids = find_winners_top2(sig, w, act, scan=scan)
    assert (ids[0] == torch.tensor([1500, 2049], device=cuda_device)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,c,d,frac", [(1, 4096, 3, 0.07), (1, 32768, 3, 0.5),
                                        (3, 1000, 5, 0.7), (2, 2, 3, 0.5),
                                        (1, 65536, 8, 0.6), (2, 7, 1, 1.0),
                                        (4, 4096, 4, 0.0)])
def test_compaction_kernel_matches_plain_version(cuda_device, B, c, d, frac):
    """The first launch's packed rows, ids and counts equal
    compact_active_plain's bitwise (rows past the count are not
    written)."""
    g = torch.Generator(device=cuda_device).manual_seed(c + d)
    w = torch.randn((B, c, d), generator=g, device=cuda_device)
    act = torch.rand((B, c), generator=g, device=cuda_device) < frac
    packed, ids, count = compact_active(w, act)
    pp, ip, cp = compact_active_plain(w, act)
    assert torch.equal(count, cp)
    for b in range(B):
        n = int(cp[b])
        assert torch.equal(ids[b, :n], ip[b, :n])
        assert torch.equal(packed[b, :n], pp[b, :n])


def _pool(dev, model="soam", capacity=1024, max_deg=16, iters=60, m=256,
          seed=0):
    p = GSONParams(model=model, insertion_threshold=0.3)
    sampler = make_sampler("torus")
    g = torch.Generator(device=dev).manual_seed(seed)
    st = init_state(sampler(g, 2), capacity=capacity, max_deg=max_deg,
                    init_threshold=0.3)
    for i in range(iters):
        prio = torch.randperm(m, generator=g, device=dev, dtype=torch.int32)
        st = multi_signal_step(st, sampler(g, m), p, prio,
                               refresh_states=(i % 5 == 0))
    return p, st


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [None, 64])
@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_update_kernels_match_plain_versions(cuda_device, model, masked):
    p, st = _pool(cuda_device, model)
    C, m = st.capacity, 2048
    g = torch.Generator(device=cuda_device).manual_seed(3)
    sig = make_sampler("torus")(g, m)
    wid, sid, d2b, _ = find_winners_reference(sig, st.w, st.active)
    prio = torch.randperm(m, generator=g, device=cuda_device,
                          dtype=torch.int32)
    if masked is not None:
        prio = torch.where(torch.arange(m, device=cuda_device) < masked,
                           prio, BIG_PRIO)
    largs = (wid[None].contiguous(), prio[None].contiguous(), C)
    best = winner_lock_min(*largs)
    assert torch.equal(best, winner_lock_min(*largs))
    assert torch.equal(best, winner_lock_min_plain(*largs))
    selected = (prio == best[0][wid.long()]) & (prio != BIG_PRIO)
    ins, adapt, scale_b, dec_b, _, _, _, scale_n, dec_n = \
        update_phase_inputs(st, wid, d2b, selected, p)
    stable = stable_units(st, p)
    args = [x[None].contiguous() for x in (
        sig, wid, selected, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
        st.nbr, st.w, sid, st.age, stable)]
    got = update_accum(*args)
    again = update_accum(*args)
    plain = update_accum_plain(*args)
    for name, k, k2, q in zip(ACCUM_FIELDS, got, again, plain):
        assert torch.equal(k, k2), f"{name} not repeatable"
        if name in EXACT_FIELDS:
            assert torch.equal(k, q), f"{name} not bitwise"
        torch.testing.assert_close(k, q, **W_TOL)
    reset = edge_slots(st.nbr, wid, sid, adapt)
    assert bool(reset.any())
    assert torch.equal(got[-1][0], edge_age_plain(
        st.age[None], st.nbr[None], got[6] > 0, stable[None],
        reset[None])[0])


@pytest.mark.cuda
def test_update_phase_op_matches_reference_on_card(cuda_device):
    p, st = _pool(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    sig = make_sampler("torus")(g, 512)
    wid, sid, d2b, _ = find_winners_reference(sig, st.w, st.active)
    prio = torch.randperm(512, generator=g, device=cuda_device,
                          dtype=torch.int32)
    got = update_phase_op(st, sig, wid, sid, d2b, prio, p)
    ref = update_phase_reference(st, sig, wid, sid, d2b, prio, p)
    for name in ("selected", "adapt", "ins", "age"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("w", "firing", "error"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   **W_TOL)


@pytest.mark.cuda
def test_session_on_card_goes_through_every_kernel(cuda_device):
    counts = [f.launches for f in (find_winners_top2, winner_lock_min,
                                   update_accum)]
    spec = gson.RunSpec(variant="multi-fused", capacity=512,
                        max_iterations=40, check_every=10)
    st, stats = gson.run(spec, seed=0)
    after = [f.launches for f in (find_winners_top2, winner_lock_min,
                                  update_accum)]
    assert all(a >= c + 40 for a, c in zip(after, counts))
    assert st.w.is_cuda and stats.iterations == 40
    assert int(st.n_active) > 8
    ref, _ = gson.run(spec.replace(backend="reference"), seed=0)
    assert torch.equal(st.nbr, ref.nbr)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    sig = torch.zeros((1, 4, 3), device=cuda_device)
    w = torch.zeros((1, 8, 3), device=cuda_device)
    act = torch.ones((1, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        find_winners_top2(sig.double(), w, act)
    with pytest.raises(ValueError):
        find_winners_top2(sig, w.transpose(1, 2).contiguous(), act)
    with pytest.raises(ValueError):
        find_winners_top2(sig, w, act.cpu())
    with pytest.raises(ValueError):
        find_winners_top2(torch.zeros((1, 4, 9), device=cuda_device),
                          torch.zeros((1, 8, 9), device=cuda_device), act)


# ---------------------------------------------------------------------------
# B2 and the fused B3 + B4 on synthetic networks: symmetric neighbor
# tables of any degree, full pools, fleets (B > 1), masked buffers, large
# pools, a table whose symmetry is broken


def _symmetric_nbr(rng, C, K, n_active, full):
    """A (C, K) neighbor table with symmetric edges and empty slots at
    random places: a circulant graph with every slot used (all C units
    active) if ``full``, else random edges among units 0..n_active-1 (the
    main path's pool: free slots go out lowest id first)."""
    if full:
        offs = [o for h in range(1, K // 2 + 1) for o in (h, -h)]
        nbr = (np.arange(C)[:, None] + np.array(offs)[None, :]) % C
        order = rng.permuted(np.tile(np.arange(K), (C, 1)), axis=1)
        return np.take_along_axis(nbr, order, axis=1).astype(np.int32)
    nbr = np.full((C, K), -1, np.int32)
    for a, b in rng.integers(0, n_active, (n_active * K, 2)):
        if a == b or (nbr[a] == b).any():
            continue
        free_a, free_b = np.flatnonzero(nbr[a] < 0), np.flatnonzero(nbr[b] < 0)
        if len(free_a) and len(free_b):
            nbr[a, rng.choice(free_a)] = b
            nbr[b, rng.choice(free_b)] = a
    return nbr


def _accum_network(rng, C, K, M, D, full=False, m_t=None, n_active=300):
    """One network's lock inputs and accumulator inputs, numpy: winners
    from the active units (every unit wins at least once if ``full``),
    distinct priorities, the lock's survivors as ``sel``."""
    nbr = _symmetric_nbr(rng, C, K, n_active, full)
    if full:
        wid = np.concatenate([rng.permutation(C), rng.integers(0, C, M - C)])
    else:
        wid = rng.integers(0, n_active, M)
    wid = wid.astype(np.int32)
    mask = np.arange(M) < (M if m_t is None else m_t)
    prio = np.where(mask, rng.permutation(M), BIG_PRIO).astype(np.int32)
    best = np.full(C, BIG_PRIO, np.int64)
    np.minimum.at(best, wid, prio)
    sel = (prio == best[wid]) & mask
    adapt = sel & (rng.random(M) < 0.8)
    valid = (nbr[wid] >= 0) & adapt[:, None]
    # seconds: mostly a neighbor of the winner (an edge to refresh), else
    # any unit, at times the winner itself
    pick = rng.integers(0, K, M)
    sid = np.where(rng.random(M) < 0.7, nbr[wid, pick], -1)
    other = rng.integers(0, C if full else n_active, M)
    sid = np.where(sid >= 0, sid, np.where(rng.random(M) < 0.3, wid, other))
    f32 = np.float32
    return dict(
        sid=sid.astype(np.int32),
        age=rng.integers(0, 60, (C, K)).astype(f32),
        stable=rng.random(C) < 0.3,
        prio=prio, x=rng.standard_normal((M, D)).astype(f32), wid=wid,
        sel=sel, adapt=adapt, scale_b=(0.1 * rng.random(M)).astype(f32),
        d2b=rng.random(M).astype(f32),
        dec_b=(0.01 * rng.random(M)).astype(f32),
        scale_n=np.where(valid, 0.05 * rng.random((M, K)), 0).astype(f32),
        dec_n=np.where(valid, 0.01 * rng.random((M, K)), 0).astype(f32),
        nbr=nbr, w=rng.standard_normal((C, D)).astype(f32))


ACCUM_ARGS = ("x", "wid", "sel", "adapt", "scale_b", "d2b", "dec_b",
              "scale_n", "dec_n", "nbr", "w", "sid", "age", "stable")


def _accum_fleet(dev, seed, B, C, K, M, D, **kw):
    """B networks stacked: (lock args, accumulator args, numpy nets)."""
    rng = np.random.default_rng(seed)
    nets = [_accum_network(rng, C, K, M, D, **kw) for _ in range(B)]

    def stack(key):
        return torch.from_numpy(np.stack([n[key] for n in nets])).to(dev)
    return ((stack("wid"), stack("prio"), C),
            [stack(k) for k in ACCUM_ARGS], nets)


def _check_accum(got, plain):
    for name, k, q in zip(ACCUM_FIELDS, got, plain):
        if name in EXACT_FIELDS:
            assert torch.equal(k, q), f"{name} not bitwise"
        torch.testing.assert_close(k, q, **W_TOL, msg=name)


def _launch_accum(args, owner):
    """repro_update_accum called directly, on a given owner scratch."""
    x, nbr = args[0], args[9]
    B, M, D = x.shape
    C, K = nbr.shape[1:]
    f32 = dict(dtype=torch.float32, device=x.device)
    outs = [torch.empty((B, C, D), **f32), torch.empty((B, C), **f32),
            torch.empty((B, C, D), **f32)] + [
        torch.empty((B, C), **f32) for _ in range(4)] + [
        torch.empty((B, C, K), **f32)]
    _build.launch("update_phase", "repro_update_accum",
                  [*args, owner, *outs], [B, M, C, K, D])
    return outs


def _stale_owner(rng, net, kind):
    """Owner scratch contents that must never pass the kernel's check."""
    wid, sel = net["wid"], net["sel"]
    C, M = net["nbr"].shape[0], wid.shape[0]
    big = np.iinfo(np.int32)
    if kind == "unselected":     # in range, winner right, not selected
        unsel = np.flatnonzero(~sel)
        owner = rng.choice(unsel, C)
        owner[wid[unsel]] = unsel
    elif kind == "other_winner":  # selected, but it won another unit
        ids = np.flatnonzero(sel)
        owner = rng.choice(ids, C)
        owner[wid[ids]] = np.roll(ids, 1)
    elif kind == "negative":
        owner = rng.integers(big.min, 0, C)
    elif kind == "too_large":
        owner = rng.integers(M, big.max, C, endpoint=True)
    else:                        # a mix of all of the above
        owner = np.stack([_stale_owner(rng, net, k) for k in (
            "unselected", "other_winner", "negative", "too_large")])
        owner = owner[rng.integers(0, 4, C), np.arange(C)]
    return owner.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", ["unselected", "other_winner", "negative",
                                  "too_large", "mixed"])
def test_update_accum_ignores_stale_owner_scratch(cuda_device, kind, B):
    """The owner scratch is not cleared: whatever it holds, the outputs,
    the aged table among them, are those of a call on a scratch set to
    -1 — for one network and for a fleet, whose networks each leave
    their own stale ids."""
    _, args, nets = _accum_fleet(cuda_device, 11, B, 4096, 16, 8192, 3)
    rng = np.random.default_rng(12)
    clean = _launch_accum(args, torch.full((B, 4096), -1, dtype=torch.int32,
                                           device=cuda_device))
    stale = torch.from_numpy(np.stack(
        [_stale_owner(rng, n, kind) for n in nets])).to(cuda_device)
    got = _launch_accum(args, stale)
    torch.cuda.synchronize()
    for name, k, q in zip(ACCUM_FIELDS, got, clean):
        assert torch.equal(k, q), f"{name} differs on a stale scratch"
    _check_accum(got, update_accum_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 16, 32])
def test_update_accum_on_a_full_pool(cuda_device, K):
    """All 4096 units active and every slot of every row used; every unit
    wins a signal."""
    _, args, _ = _accum_fleet(cuda_device, K, 1, 4096, K, 8192, 3, full=True)
    assert bool(args[2].sum() == 4096)
    got = update_accum(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, update_accum(*args)))
    _check_accum(got, update_accum_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m_t", [None, 64])
@pytest.mark.parametrize("K,D", [(6, 3), (8, 3), (16, 3), (32, 3), (40, 3),
                                 (16, 5)])
def test_lock_and_accum_on_fleets(cuda_device, K, D, m_t):
    """B = 3 networks in one launch, at several degrees (6 and 40 take
    the unaligned row search and the chunked slot loop), unmasked and
    masked to m_t = 64."""
    largs, args, _ = _accum_fleet(cuda_device, 100 + K + D, 3, 2000, K,
                                  4096, D, m_t=m_t)
    before = (winner_lock_min.launches, update_accum.launches)
    best = winner_lock_min(*largs)
    assert torch.equal(best, winner_lock_min(*largs))
    assert torch.equal(best, winner_lock_min_plain(*largs))
    wid, prio = largs[0], largs[1]
    sel = (prio == torch.gather(best, 1, wid.long())) & (prio != BIG_PRIO)
    assert torch.equal(sel, args[2])
    got = update_accum(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, update_accum(*args)))
    assert (winner_lock_min.launches, update_accum.launches) == (
        before[0] + 2, before[1] + 2)
    _check_accum(got, update_accum_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m_t", [None, 64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("K", [6, 16, 40])
def test_fused_aging_matches_plain_version(cuda_device, K, D, B, m_t):
    """The aged table of the fused launch equals edge_slots +
    edge_age_plain bitwise and repeats bitwise: K = 6 (rows not 16-byte
    multiples), 16 (the main path), 40 (the chunked slot loop), fleets,
    the full buffer and m_t = 64."""
    _, args, _ = _accum_fleet(cuda_device, 300 + K + D + B, B, 2000, K,
                              4096, D, m_t=m_t)
    before = update_accum.launches
    got = update_accum(*args)
    again = update_accum(*args)
    assert update_accum.launches == before + 2
    wid, sel, adapt, nbr, sid, age, stable = (args[i] for i in (
        1, 2, 3, 9, 11, 12, 13))
    reset = torch.stack([edge_slots(nbr[b], wid[b], sid[b], adapt[b])
                         for b in range(B)])
    assert bool(reset.any())
    want = edge_age_plain(age, nbr, got[6] > 0, stable, reset)
    assert torch.equal(got[-1], again[-1])
    assert torch.equal(got[-1], want)
    assert bool((want > age).any()) and bool((want == age).any())
    _check_accum(got, update_accum_plain(*args))


@pytest.mark.cuda
def test_fused_aging_on_a_table_with_one_broken_row(cuda_device):
    """Row c names a unit u that does not name it back, twice: aging
    still equals the plain version (the first of the two slots is reset
    where c's owner names u as its second, the other ages), and the
    winner fields stay bitwise; the neighbor sums are not compared, as
    their walk relies on symmetric edges."""
    rng = np.random.default_rng(21)
    net = _accum_network(rng, 2000, 16, 4096, 3)
    nbr, wid, sel, adapt = net["nbr"], net["wid"], net["sel"], net["adapt"]
    i0 = np.flatnonzero(adapt)[0]
    c = wid[i0]
    winners = [w for w in wid[sel] if w != c and (nbr[w] != c).all()
               and (nbr[c] != w).all()]
    u = winners[0]
    nbr[c, :2] = u            # replaces two of c's edges: one-sided now
    net["sid"][i0] = u
    net["stable"][c] = False
    args = [torch.from_numpy(net[k][None]).to(cuda_device)
            for k in ACCUM_ARGS]
    got = update_accum(*args)
    plain = update_accum_plain(*args)
    # slot 0 is reset; slot 1 ages by 2: c and u are both winners
    assert got[-1][0, c, 0] == 0
    assert got[-1][0, c, 1] == args[12][0, c, 1] + 2
    for name, k, q in zip(ACCUM_FIELDS, got, plain):
        if name in EXACT_FIELDS:
            assert torch.equal(k, q), f"{name} not bitwise"


@pytest.mark.cuda
@pytest.mark.parametrize("C,M,B", [(65536, 8192, 1), (65541, 8191, 2),
                                   (4096, 8190, 3)])
@pytest.mark.parametrize("m_t", [None, 64])
def test_winner_lock_across_tiles(cuda_device, C, M, B, m_t):
    """Pools larger than one shared-memory tile (several blocks per
    network, a ragged last tile) and buffers whose rows are not 16-byte
    multiples (the scalar path)."""
    g = torch.Generator(device=cuda_device).manual_seed(C + M)
    wid = torch.randint(0, C, (B, M), generator=g, device=cuda_device,
                        dtype=torch.int32)
    prio = torch.stack([torch.randperm(M, generator=g, device=cuda_device,
                                       dtype=torch.int32) for _ in range(B)])
    if m_t is not None:
        prio[:, m_t:] = BIG_PRIO
    best = winner_lock_min(wid, prio, C)
    assert torch.equal(best, winner_lock_min(wid, prio, C))
    assert torch.equal(best, winner_lock_min_plain(wid, prio, C))


@pytest.mark.cuda
def test_each_wrapper_at_b8_matches_its_plain_version(cuda_device):
    """The fleet's shape: eight networks in one launch of each wrapper,
    at the main path's widths, each held against its plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    B, M, C, D = 8, 8192, 4096, 3
    sig = torch.randn((B, M, D), generator=g, device=cuda_device)
    w = torch.randn((B, C, D), generator=g, device=cuda_device)
    act = torch.rand((B, C), generator=g, device=cuda_device) < 0.1
    act[:, :2] = True
    before = [f.launches for f in (find_winners_top2, winner_lock_min,
                                   update_accum)]
    d2k, idk = find_winners_top2(sig, w, act)
    d2p, idp = find_winners_top2_plain(sig, w, act)
    torch.testing.assert_close(d2k, d2p, **D_TOL)
    for b in range(B):
        ok = near_tie_free(sig[b], w[b], act[b])
        assert ok.float().mean() > 0.9
        assert torch.equal(idk[b][ok], idp[b][ok])
    largs, args, _ = _accum_fleet(cuda_device, 8, B, C, 16, M, D, m_t=512)
    best = winner_lock_min(*largs)
    assert torch.equal(best, winner_lock_min_plain(*largs))
    got = update_accum(*args)
    _check_accum(got, update_accum_plain(*args))
    after = [f.launches for f in (find_winners_top2, winner_lock_min,
                                  update_accum)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


_STATE_FIELDS = ("w", "active", "nbr", "age", "error", "firing",
                 "threshold", "topo_state", "inconsistent_for", "n_active",
                 "signal_count", "discarded")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_fleet_on_card_equals_sessions(cuda_device, variant):
    """A B = 4 FleetSession on the card: one launch of each wrapper per
    fleet iteration, and every network equals its own Session (state
    fields bitwise, rows equal with qe within 1e-6)."""
    spec = gson.RunSpec(variant=variant, capacity=512, max_iterations=40,
                        check_every=10)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(4)))
    fleet.run(budget=0)
    before = [f.launches for f in (find_winners_top2, winner_lock_min,
                                   update_accum)]
    fleet.run()
    after = [f.launches for f in (find_winners_top2, winner_lock_min,
                                  update_accum)]
    assert [a - b for a, b in zip(after, before)] == [40, 40, 40]
    for i in range(4):
        sess = gson.Session(spec, seed=i)
        sess.run()
        st, stats = fleet.result(i)
        assert st.w.is_cuda
        for name in _STATE_FIELDS:
            assert torch.equal(getattr(st, name),
                               getattr(sess.state, name)), (i, name)
        for row, srow in zip(stats.history, sess.stats.history, strict=True):
            assert (row["iteration"], row["units"], row["signals"]) == (
                srow["iteration"], srow["units"], srow["signals"])
            assert row["qe"] == pytest.approx(srow["qe"], rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [100, 1])
def test_gng_fleet_on_card_equals_the_plain_reference(cuda_device, lam):
    """A B = 8 GNG fleet at C = 4096 on ``cuda-full`` (Fritzke's settings
    of the benchmark's GNG cell; lambda 1 makes every iteration from ~8
    units on insert 8), 128 iterations: from the card's state before each
    iteration, the plain reference (``gpubench/reference/gng_step.py``)
    reaches the card's state after it, outside near ties: discrete fields
    bitwise, weights and errors within 1e-4 by the benchmark's measure
    (``gng_compare.state_gap``: errors relative to the network's largest;
    the kernel's squared distances are direct differences, the
    reference's a product), ten times inside the benchmark's limit."""
    import sys
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gpubench.reference import gng_compare
    from gpubench.reference import gng_step as ref
    from gpubench.traffic.draws import JobInputs
    B, N = 8, 128
    model = GSONParams(model="gng", eps_b=0.2, eps_n=0.006, age_max=50.0,
                       gng_lambda=lam, gng_alpha=0.5, gng_beta=0.005)
    spec = gson.RunSpec(variant="multi", model=model, backend="cuda-full",
                        capacity=4096, device="cuda")
    p = ref.Params(eps_b=0.2, eps_n=0.006, age_max=50.0, gng_lambda=lam,
                   gng_alpha=0.5, gng_beta=0.005, insertion_threshold=0.2,
                   min_m=4, check_every=10)
    inputs = JobInputs(seed=2 ** 31 + 77, job=0, batch=B, surface="sphere",
                       device=cuda_device)
    inputs.keep = set(range(N))
    sess = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(B)),
                             draws=inputs.draws())

    def nets():
        (c,) = sess.cohorts
        n = c.fstate.nets
        return [ref.Net.of({f: getattr(n, f)[i] for f in ref.FIELDS})
                for i in range(B)]

    sess.run(budget=0)
    before, judged = nets(), 0
    for k in range(N):
        sess.run(budget=1)
        after = nets()
        x, prio = inputs.kept.pop(k)
        for i in range(B):
            want, tie = ref.step(before[i], x[i], prio[i], k, p)
            if tie:
                continue
            gap, field = gng_compare.state_gap(after[i], want)
            assert gap <= 1e-4, (k, i, gap, field)
            judged += 1
        before = after
    # lambda 1 puts two units at one point now and then (two insertions
    # between the same q and f): a near tie for the signals around it
    assert judged >= N * B // 4
    assert min(int(n.n_active) for n in before) > (2 if lam == 100 else 500)


@pytest.mark.cuda
def test_session_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    spec = gson.RunSpec(variant="multi", capacity=512, max_iterations=40,
                        check_every=10)
    full = gson.Session(spec, seed=1)
    full.run()
    cut = gson.Session(spec, seed=1, checkpoint_dir=str(tmp_path))
    cut.run(budget=17)
    cut.checkpoint()
    del cut
    back = gson.Session.restore(spec, str(tmp_path))
    assert back.state.w.is_cuda and back.probes.is_cuda
    back.run()
    assert back.stats.history == full.stats.history
    for name in _STATE_FIELDS:
        assert torch.equal(getattr(back.state, name),
                           getattr(full.state, name)), name


# ---------------------------------------------------------------------------
# no fallback (these run on any host)


# ---------------------------------------------------------------------------
# the winner-neighborhood slab and the sequential baseline


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["soam", "gwr"])
@pytest.mark.parametrize("B", [1, 4])
def test_slab_matches_dense_and_plain_on_card(cuda_device, B, model):
    """``update_phase_sparse`` on the card (B2 and B3 + B4 at slab
    capacity) equals ``update_phase_op`` bitwise, and its plain version
    (the same function on CPU copies) in discrete fields bitwise, floats
    within W_TOL."""
    nets, ins = [], []
    for b in range(B):
        p, st = _pool(cuda_device, model, capacity=2048, seed=b)
        g = torch.Generator(device=cuda_device).manual_seed(10 + b)
        sig = make_sampler("torus")(g, 256)
        wid, sid, d2b, _ = find_winners_reference(sig, st.w, st.active)
        prio = torch.randperm(256, generator=g, device=cuda_device,
                              dtype=torch.int32)
        nets.append(st)
        ins.append((sig, wid, sid, d2b, prio))
    st = stack_states(nets)
    args = (st, *(torch.stack(x) for x in zip(*ins)), p)
    slab0 = update_phase_sparse.slab_calls
    counts = (winner_lock_min.launches, update_accum.launches)
    got = update_phase_sparse(*args)
    assert update_phase_sparse.slab_calls == slab0 + 1, "slab not taken"
    assert (winner_lock_min.launches, update_accum.launches) == (
        counts[0] + 1, counts[1] + 1)
    for name, a, b in zip(got._fields, got, update_phase_op(*args)):
        assert torch.equal(a, b), f"{name} differs from update_phase_op"
    plain = update_phase_sparse(*(
        x.cpu() if isinstance(x, torch.Tensor) else x
        for x in (st.map(lambda t: t.cpu()), *args[1:])))
    for name in ("selected", "adapt", "ins", "age"):
        assert torch.equal(getattr(got, name).cpu(), getattr(plain, name))
    for name in ("w", "firing", "error"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(plain, name), **W_TOL)


@pytest.mark.cuda
def test_sparse_session_equals_dense_on_card(cuda_device):
    spec = gson.RunSpec(backend="cuda-update", capacity=1024,
                        max_iterations=30, check_every=10,
                        variant_config=gson.MultiConfig(fixed_m=64))
    slab0 = update_phase_sparse.slab_calls
    st_s, stats_s = gson.run(spec.replace(backend="cuda-sparse"), seed=1)
    assert update_phase_sparse.slab_calls - slab0 > 15
    st_d, stats_d = gson.run(spec, seed=1)
    assert stats_s.history == stats_d.history
    for name in ("w", "active", "nbr", "age", "error", "firing", "threshold",
                 "topo_state", "n_active"):
        assert torch.equal(getattr(st_s, name), getattr(st_d, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("best", ["cuda", "sparse"])
def test_cuda_auto_runs_kernels_and_refuses_last_on_card(cuda_device, best):
    """On the card ``cuda-auto`` runs the kernels the table names, and
    raises on ``neighbor_collision="last"`` instead of running the
    reference."""
    table = autotune.SelectionTable(cells=(autotune.Cell(
        8, 1024, 16, best, {"cuda": 1.0, "sparse": 1.0}),))
    up = autotune.make_autotuned_update_phase(table)
    inputs = autotune._cell_inputs(8, 1024, 16, device=cuda_device)
    counts = (winner_lock_min.launches, update_accum.launches)
    got = up(*inputs)
    assert (winner_lock_min.launches, update_accum.launches) == (
        counts[0] + 1, counts[1] + 1)
    want = autotune.CANDIDATES[best](*inputs)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    last = dataclasses.replace(inputs[-1], neighbor_collision="last")
    with pytest.raises(NotImplementedError, match="reference backend"):
        up(*inputs[:-1], last)


@pytest.mark.cuda
def test_single_launches_find_winners_once_per_signal(cuda_device):
    spec = gson.RunSpec(variant="single", backend="cuda-full", capacity=512,
                        max_iterations=2, check_every=1,
                        variant_config=gson.SingleConfig(chunk=64,
                                                         refresh_every=20))
    counts = [f.launches for f in (find_winners_top2, winner_lock_min,
                                   update_accum)]
    st, stats = gson.run(spec, seed=2)
    after = [f.launches for f in (find_winners_top2, winner_lock_min,
                                  update_accum)]
    # one B1 launch per signal; the Update phase is the reference's
    assert [a - c for a, c in zip(after, counts)] == [128, 0, 0]
    assert st.w.is_cuda and stats.signals == 128
    ref, ref_stats = gson.run(spec.replace(backend="reference"), seed=2)
    assert stats.history == ref_stats.history
    assert torch.equal(st.nbr, ref.nbr)


# ---------------------------------------------------------------------------
# paths that had not run on the card: the engine shim, autotune's cache,
# cuda-auto in a Session, a cuda-sparse fleet (the "c2" phase of
# chip_smoke.py runs these four)


@pytest.mark.cuda
def test_c2_engine_run_on_card_equals_its_session(cuda_device):
    from repro_torch.core.gson.engine import EngineConfig, GSONEngine
    cfg = EngineConfig(variant="multi", capacity=512, max_iterations=30,
                       check_every=10)
    with pytest.warns(DeprecationWarning):
        engine = GSONEngine(cfg, "sphere", find_winners="cuda-full")
    assert engine.spec.device == "cuda"
    state, stats = engine.run(seed=3)
    sess = gson.Session(engine.spec, seed=3)
    sess.run()
    assert state.w.is_cuda and stats.iterations == 30
    assert stats.history == sess.stats.history
    for name in _STATE_FIELDS:
        assert torch.equal(getattr(state, name),
                           getattr(sess.state, name)), name


@pytest.mark.cuda
def test_c2_autotune_writes_a_cache_that_loads_back(cuda_device, tmp_path,
                                                     monkeypatch):
    cache = tmp_path / "table.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(cache))
    monkeypatch.delenv(autotune.ENV_TABLE, raising=False)
    table = autotune.autotune(cells=((32, 768, 64), (256, 4096, 512)),
                              n=3, warmup=1)
    assert cache.is_file()
    loaded = autotune.load_table()
    assert loaded.to_json() == table.to_json()
    assert [(c.units, c.capacity, c.m) for c in loaded.cells] == [
        (32, 768, 64), (256, 4096, 512)]
    assert {c.best for c in loaded.cells} <= {"cuda", "sparse"}
    assert "reference" in loaded.cells[0].t_us
    up = autotune.make_autotuned_update_phase()
    assert up.select(768, 64) == loaded.cells[0].best


@pytest.mark.cuda
def test_c2_cuda_auto_session_equals_cuda_update(cuda_device, tmp_path,
                                                 monkeypatch):
    """The committed table picks ``cuda`` at every cell, so a ``cuda-auto``
    Session is a ``cuda-update`` one, bitwise."""
    monkeypatch.delenv(autotune.ENV_TABLE, raising=False)
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "none.json"))
    up = gson.resolve_backend("cuda-auto").update_phase
    assert up.resolve_table().to_json()["cells"] == autotune.load_table(
        autotune.PACKAGED_TABLE).to_json()["cells"]
    assert {c.best for c in up.resolve_table().cells} == {"cuda"}
    spec = gson.RunSpec(backend="cuda-update", max_iterations=64,
                        check_every=16)
    counts = (winner_lock_min.launches, update_accum.launches)
    st_a, stats_a = gson.run(spec.replace(backend="cuda-auto"), seed=4)
    assert (winner_lock_min.launches - counts[0],
            update_accum.launches - counts[1]) == (64, 64)
    st_u, stats_u = gson.run(spec, seed=4)
    assert stats_a.history == stats_u.history and len(stats_a.history) == 4
    for name in _STATE_FIELDS:
        assert torch.equal(getattr(st_a, name), getattr(st_u, name)), name


@pytest.mark.cuda
def test_c2_cuda_sparse_fleet_at_b4(cuda_device):
    spec = gson.RunSpec(backend="cuda-sparse", max_iterations=30,
                        check_every=10,
                        variant_config=gson.MultiConfig(fixed_m=512))
    fs = gson.FleetSpec.broadcast(spec, seeds=range(4))
    slab0 = update_phase_sparse.slab_calls
    fleet = gson.FleetSession(fs)
    fleet.run()
    assert update_phase_sparse.slab_calls - slab0 > 15
    dense = gson.FleetSession(gson.FleetSpec.broadcast(
        spec.replace(backend="cuda-update"), seeds=range(4)))
    dense.run()
    for i in range(4):
        st, stats = fleet.result(i)
        st_d, stats_d = dense.result(i)
        assert stats.history == stats_d.history
        sess = gson.Session(spec, seed=i)
        sess.run()
        # qe is a mean over a batch of another shape: within 1e-6
        for row, srow in zip(stats.history, sess.stats.history,
                             strict=True):
            assert (row["iteration"], row["units"], row["signals"]) == (
                srow["iteration"], srow["units"], srow["signals"])
            assert row["qe"] == pytest.approx(srow["qe"], rel=1e-6)
        for name in _STATE_FIELDS:
            assert torch.equal(getattr(st, name), getattr(st_d, name)), \
                (i, name)
            assert torch.equal(getattr(st, name),
                               getattr(sess.state, name)), (i, name)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [False, True])
def test_c2_batch_add_repeats_bitwise_on_card(cuda_device, cols):
    """``batch.add`` on the card sums in an order fixed by the index: run
    after run the same bits, and the CPU's sum within float rounding."""
    from repro_torch.core.gson.batch import add
    g = torch.Generator().manual_seed(0)
    B, C, K, n = 2, 64, 8, 4096
    x = torch.randn(B, C, K, generator=g)
    rows = torch.randint(0, C + 1, (B, n), generator=g)     # C drops
    if cols:
        index = (rows, torch.randint(0, K, (B, n), generator=g))
        vals = torch.randn(B, n, generator=g)
    else:
        index = (rows,)
        vals = torch.randn(B, n, K, generator=g)
    on_card = [add(x.to(cuda_device),
                   tuple(i.to(cuda_device) for i in index),
                   vals.to(cuda_device)).cpu() for _ in range(3)]
    assert torch.equal(on_card[0], on_card[1])
    assert torch.equal(on_card[0], on_card[2])
    torch.testing.assert_close(on_card[0], add(x, index, vals))


@pytest.mark.cuda
def test_c2_reference_session_on_card_repeats_bitwise(cuda_device):
    """The plain backend's Update phase on the card is deterministic, so
    ranks that replicate it under a signal mesh hold one network."""
    spec = gson.RunSpec(backend="reference", capacity=512,
                        max_iterations=40, check_every=10)
    runs = [gson.run(spec, seed=5) for _ in range(2)]
    assert runs[0][1].history == runs[1][1].history
    for name in _STATE_FIELDS:
        assert torch.equal(getattr(runs[0][0], name),
                           getattr(runs[1][0], name)), name


@pytest.mark.cuda
def test_windowed_refuses_tf32_on_card(cuda_device):
    from repro_torch import ann
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sig = torch.randn(64, 3, generator=g, device=cuda_device)
    w = torch.randn(256, 3, generator=g, device=cuda_device)
    act = torch.ones(256, dtype=torch.bool, device=cuda_device)
    fw = ann.windowed_find_winners(0.95)
    for a, b in zip(fw(sig, w, act), find_winners_reference(sig, w, act)):
        assert torch.equal(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TensorFloat-32"):
            fw(sig, w, act)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_grid_on_card_returns_its_own_answer_on_a_dense_pool(cuda_device):
    """Two networks of 4096 units on the sphere (cells of ~0.125, units
    ~0.06 apart): every signal passes the radius guard, so the grid's own
    shortlist answer reaches the caller, the reference is not run, and
    its ids are the exhaustive search's."""
    from repro_torch import ann
    from repro_torch.ann.grid import grid_search, guarded_search
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sphere = make_sampler("sphere")
    w = torch.stack([sphere(g, 4096) for _ in range(2)])
    sig = torch.stack([sphere(g, 1024) for _ in range(2)])
    act = torch.ones((2, 4096), dtype=torch.bool, device=cuda_device)
    fw = ann.grid_find_winners(0.95)
    aux = fw.build(w, act)
    calls, fires = guarded_search.calls, guarded_search.fires
    out = fw(sig, w, act, aux=aux)
    assert (guarded_search.calls, guarded_search.fires) == (calls + 1, fires)
    own = grid_search(aux, sig, w, act, per_cell_cap=fw.per_cell_cap,
                      n_anchors=fw.n_anchors)
    for a, b in zip(out, own):
        assert torch.equal(a, b)
    ref = find_winners_reference(sig, w, act)
    for b in range(2):
        # squared distances here are ~1e-3: a tie is closer than 1e-6,
        # a few ulps of the reference's expansion at |x|, |w| ~ 1
        ok = near_tie_free(sig[b], w[b], act[b], eps=1e-6)
        assert int(ok.sum()) > 960
        for k in (0, 1):
            assert torch.equal(out[k][b][ok], ref[k][b][ok]), (b, k)
            torch.testing.assert_close(out[k + 2][b], ref[k + 2][b], **D_TOL)


@pytest.mark.cuda
def test_serve_on_card_poisoned_job_equals_its_session(cuda_device,
                                                       tmp_path):
    """Four jobs served on cuda-full, one poisoned: each ends equal to its
    dedicated Session on the card, the poisoned one after one retry from
    its pre-poison checkpoint; the kernels ran under serving."""
    import warnings

    from repro_torch.serving import ReconstructionServer
    spec = gson.RunSpec(variant="multi-fused", max_iterations=192)
    wrappers = (find_winners_top2, winner_lock_min, update_accum)
    before = [f.launches for f in wrappers]
    srv = ReconstructionServer(
        slots=4, slice_iters=64, checkpoint_dir=str(tmp_path),
        injector=gson.GsonFaultInjector({1: {"kind": "poison", "job": 1}}))
    jobs = [srv.submit(spec, seed=s) for s in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        srv.run(max_ticks=20)
    assert all(f.launches > n for f, n in zip(wrappers, before))
    assert [(j.status, j.retries) for j in jobs] == [
        ("done", 0), ("done", 1), ("done", 0), ("done", 0)]
    assert jobs[1].error["kind"] == "unhealthy_state"
    for s, job in enumerate(jobs):
        sess = gson.Session(spec, seed=s)
        sess.run()
        assert job.stats.iterations == sess.iteration == 192
        for row, srow in zip(job.history, sess.stats.history, strict=True):
            assert (row["iteration"], row["units"], row["signals"]) == (
                srow["iteration"], srow["units"], srow["signals"]), s
            assert row["qe"] == pytest.approx(srow["qe"], rel=1e-6), s
        # the last row came from the job's final wave, at its index there
        st = job.session.network(job.history[-1]["network"])
        for name in _STATE_FIELDS:
            assert torch.equal(getattr(st, name),
                               getattr(sess.state, name)), (s, name)


@pytest.mark.cuda
def test_lm_serve_on_card_equals_the_cpu(cuda_device):
    """The qwen1.5-0.5b smoke config at f32 from one set of weights on the
    card and on the CPU: prefill and three decode steps within 1e-4, then
    a ``ServeEngine`` on each (the cache written at a device index, one
    read of the tick's tokens) giving the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_bundle, smoke_config
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    bundle = get_bundle(cfg)
    host = bundle.init(0, device="cpu")
    card = {k: v.to(cuda_device) for k, v in host.items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (3, 12)).astype(np.int32))
    out = []
    for params, dev in ((host, "cpu"), (card, cuda_device)):
        t = toks.to(dev)
        cache, logits = bundle.prefill(params, {"tokens": t[:, :9]},
                                       max_len=16)
        steps = [logits]
        for j in range(9, 12):
            cache, logits = bundle.decode_step(params, cache, t[:, j:j + 1])
            steps.append(logits)
        assert cache["length"].device.type == torch.device(dev).type
        out.append(torch.stack(steps).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=1e-4, atol=1e-4)

    served = []
    for params in (host, card):
        eng = ServeEngine(bundle, params,
                          ServeConfig(batch=4, max_len=32, eos_id=-1))
        assert eng.device == params["embed"].device
        rng = np.random.default_rng(1)
        for i in range(6):
            eng.submit(rng.integers(2, cfg.vocab, size=int(rng.integers(
                1, 9))), rid=i, max_tokens=6)
        served.append({r.rid: r.out for r in eng.run()})
        assert (eng.prefills, eng.decode_steps) == (2, 10)
    assert served[1] == served[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_families_on_card_equals_the_cpu(cuda_device, arch):
    """The SSM, hybrid and enc-dec smoke configs at f32 from one set of
    weights on the card and on the CPU: the forward over 32 tokens (two
    SSD chunks), prefill of 16 and three decode steps within 1e-4 (every
    cache entry too), then a ``ServeEngine`` on each (whisper on the
    engine's zero frames) giving the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_bundle, smoke_config
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg = smoke_config(get_config(arch))
    bundle = get_bundle(cfg)
    host = bundle.init(0, device="cpu")
    # the constant-init parameters get values of their own
    gen = torch.Generator().manual_seed(1)
    for k in host:
        if k.endswith(("A_log", "dt_bias", "Dskip", "norm", "ln", "ln1",
                       "ln2", "ln_c")):
            host[k] = host[k] + 0.1 * torch.randn(host[k].shape, generator=gen)
    card = {k: v.to(cuda_device) for k, v in host.items()}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (3, 32)).astype(np.int32))
    frames = torch.from_numpy((0.1 * rng.standard_normal(
        (3, cfg.encoder_ctx, cfg.d_model))).astype(np.float32))
    out, caches = [], []
    for params, dev in ((host, "cpu"), (card, cuda_device)):
        extra = ({"frames": frames.to(dev)} if cfg.family == "encdec"
                 else {})
        t = toks.to(dev)
        fwd, _ = bundle.forward(params, {"tokens": t, **extra})
        cache, logits = bundle.prefill(params, {"tokens": t[:, :16], **extra},
                                       max_len=20)
        steps = [logits]
        for j in range(16, 19):
            cache, logits = bundle.decode_step(params, cache, t[:, j:j + 1])
            steps.append(logits)
        assert cache["length"].device.type == torch.device(dev).type
        out.append((fwd.cpu(), torch.stack(steps).cpu()))
        caches.append({k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out[1], out[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k in caches[0]:
        torch.testing.assert_close(caches[1][k], caches[0][k], rtol=1e-4,
                                   atol=1e-4, msg=k)

    served = []
    for params in (host, card):
        eng = ServeEngine(bundle, params,
                          ServeConfig(batch=3, max_len=24, eos_id=-1))
        rng = np.random.default_rng(1)
        for i in range(5):
            eng.submit(rng.integers(2, cfg.vocab, size=int(rng.integers(
                1, 9))), rid=i, max_tokens=5)
        served.append({r.rid: r.out for r in eng.run()})
        assert (eng.prefills, eng.decode_steps) == (2, 8)
    assert served[1] == served[0]


# ---------------------------------------------------------------------------
# more paths that no record showed on the card (the "c4_" tests, which the
# c2 phase of chip_smoke.py runs too), and the LM's train step on the card


def _run_on_card(spec, seed):
    """A Session of ``spec`` on the card: (state, stats), the state
    finite with a symmetric edge table."""
    st, stats = gson.run(spec, seed=seed)
    assert st.w.is_cuda and stats.iterations > 0
    act = st.active
    assert bool(torch.isfinite(st.w[act]).all())
    nbr = st.nbr.long()
    for u in torch.nonzero(act).flatten().tolist()[:64]:
        for v in nbr[u][nbr[u] >= 0].tolist():
            assert u in nbr[v].tolist(), (u, v)
    return st, stats


def _rows_equal_through(stats, ref, horizon: int):
    rows = [r for r in stats.history if r["iteration"] <= horizon]
    rrows = [r for r in ref.history if r["iteration"] <= horizon]
    assert rows and len(rows) == len(rrows)
    for a, b in zip(rows, rrows):
        assert (a["iteration"], a["units"], a["signals"]) == (
            b["iteration"], b["units"], b["signals"]), (a, b)
        assert math.isclose(a["qe"], b["qe"], rel_tol=1e-4), (a, b)


def _search_card_equals_cpu(fw, st, n: int = 1024, seed: int = 0):
    """``fw`` on the final pool of a card run, with the aux it builds,
    against the same search on CPU copies of its inputs: ids bitwise on
    signals without a near tie, distances within D_TOL."""
    g = torch.Generator(device=st.w.device).manual_seed(seed)
    sig = make_sampler("sphere")(g, n)
    w, act = st.w, st.active
    out = fw(sig, w, act, aux=fw.build(w, act))
    cw, cact, csig = w.cpu(), act.cpu(), sig.cpu()
    cpu = fw(csig, cw, cact, aux=fw.build(cw, cact))
    ok = near_tie_free(csig, cw, cact)
    assert int(ok.sum()) > 0.9 * n
    for k in (0, 1):
        assert torch.equal(out[k].cpu()[ok], cpu[k][ok]), k
        torch.testing.assert_close(out[k + 2].cpu(), cpu[k + 2], **D_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_c4_indexed_backend_in_multi_on_card(cuda_device, variant):
    """The ``indexed`` backend (the grid with its exhaustive fallback,
    rebuilt on the refresh cadence) inside ``multi``/``multi-fused`` on
    the card: a healthy network, and its search on the grown pool equal
    to the CPU's."""
    spec = gson.RunSpec(variant=variant, backend="indexed", capacity=1024,
                        max_iterations=64, check_every=8)
    st, stats = _run_on_card(spec, seed=3)
    assert stats.iterations == 64 and stats.units > 100
    _search_card_equals_cpu(gson.resolve_backend("indexed").find_winners, st)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ann-windowed", "ann-grid"])
def test_c4_ann_fleet_at_b4_on_card(cuda_device, backend):
    """An ANN backend in a ``FleetSession`` at B = 4 on the card: each
    network bitwise its own Session, and its rows those of the
    ``reference`` backend through 32 iterations (both searches are exact
    on these pools)."""
    spec = gson.RunSpec(backend=backend, capacity=1024, max_iterations=32,
                        check_every=8)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec,
                                                       seeds=range(4)))
    fleet.run()
    for i in range(4):
        st, stats = fleet.result(i)
        sess = gson.Session(spec, seed=i)
        sess.run()
        for row, srow in zip(stats.history, sess.stats.history,
                             strict=True):
            assert (row["iteration"], row["units"], row["signals"]) == (
                srow["iteration"], srow["units"], srow["signals"]), i
            assert row["qe"] == pytest.approx(srow["qe"], rel=1e-6), i
        for name in _STATE_FIELDS:
            assert torch.equal(getattr(st, name),
                               getattr(sess.state, name)), (i, name)
        _, ref = gson.run(spec.replace(backend="reference"), seed=i)
        _rows_equal_through(stats, ref, 32)


@pytest.mark.cuda
def test_c4_engine_indexed_on_card_equals_its_session(cuda_device):
    from repro_torch.core.gson.engine import EngineConfig, GSONEngine
    cfg = EngineConfig(variant="indexed", capacity=512, max_iterations=3,
                       check_every=1, chunk=128)
    with pytest.warns(DeprecationWarning):
        engine = GSONEngine(cfg, "sphere")
    assert engine.spec.device == "cuda"
    state, stats = engine.run(seed=3)
    sess = gson.Session(engine.spec, seed=3)
    sess.run()
    assert state.w.is_cuda and stats.signals == 3 * 128
    assert stats.history == sess.stats.history
    for name in _STATE_FIELDS:
        assert torch.equal(getattr(state, name),
                           getattr(sess.state, name)), name
    from repro_torch.ann import indexed_find_winners
    v = engine.spec.variant_config
    _search_card_equals_cpu(indexed_find_winners(
        v.grid_per_axis, v.per_cell_cap, v.bbox), state, n=256)


@pytest.mark.cuda
def test_c4_pointcloud_stream_and_noisy_sampler_on_card(cuda_device):
    """The stream draws on the card as a pure function of (seed,
    iteration), the noise from the same generator after the points; a
    Session fed the noisy stream on ``cuda-full`` has the rows of the
    ``reference`` backend through 16 iterations."""
    from repro_torch.data.pointclouds import NoisySampler, PointCloudStream
    s = PointCloudStream("torus", seed=3, noise=0.02)
    a, b = s.signals(7, 64), s.signals(7, 64)
    assert a.is_cuda and torch.equal(a, b) and a.shape == (64, 3)
    assert not torch.equal(a, s.signals(8, 64))
    g1 = torch.Generator(device=cuda_device).manual_seed(11)
    g2 = torch.Generator(device=cuda_device).manual_seed(11)
    noisy = NoisySampler(make_sampler("torus"), 0.02)(g1, 16)
    clean = make_sampler("torus")(g2, 16)
    assert torch.equal(noisy, clean + 0.02 * torch.randn(
        16, 3, generator=g2, device=cuda_device))
    spec = gson.RunSpec(sampler=PointCloudStream("sphere", noise=0.01),
                        backend="cuda-full", capacity=1024,
                        max_iterations=16, check_every=8)
    counts = find_winners_top2.launches
    st, stats = _run_on_card(spec, seed=1)
    assert find_winners_top2.launches - counts == 16
    _, ref = gson.run(spec.replace(backend="reference"), seed=1)
    _rows_equal_through(stats, ref, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ann-windowed", "ann-grid"])
def test_c4_ann_backend_at_a_second_recall_target_on_card(cuda_device, kind):
    """``ann_backend(kind, 0.8)`` on the card: rows of the ``reference``
    backend through 64 iterations, and its search on the grown pool equal
    to the CPU's."""
    be = gson.ann_backend(kind, 0.8)
    spec = gson.RunSpec(backend=be, capacity=1024, max_iterations=64,
                        check_every=8)
    st, stats = _run_on_card(spec, seed=2)
    _, ref = gson.run(spec.replace(backend="reference"), seed=2)
    _rows_equal_through(stats, ref, 64)
    if kind == "ann-grid":
        _search_card_equals_cpu(be.find_winners, st)


def _lm_smoke(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_bundle, smoke_config
    bundle = get_bundle(smoke_config(get_config(arch)))
    return bundle.cfg, bundle


@pytest.mark.cuda
def test_c4_vlm_on_card_equals_the_cpu(cuda_device):
    """internvl2-76b at smoke size with its image prefix: prefill and three
    decode steps on the card within 1e-4 of the CPU from one set of f32
    weights, then a ``ServeEngine`` (its ``img_embeds`` stub) on each,
    with the same greedy tokens."""
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg, bundle = _lm_smoke("internvl2-76b")
    assert cfg.family == "vlm"
    host = bundle.init(0, device="cpu")
    card = {k: v.to(cuda_device) for k, v in host.items()}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 9)).astype(
        np.int32))
    img = torch.from_numpy((0.1 * rng.standard_normal(
        (2, cfg.n_img_tokens, cfg.d_model))).astype(np.float32))
    out = []
    for params, dev in ((host, "cpu"), (card, cuda_device)):
        t = toks.to(dev)
        cache, logits = bundle.prefill(
            params, {"tokens": t[:, :6], "img_embeds": img.to(dev)},
            max_len=cfg.n_img_tokens + 9)
        steps = [logits]
        for j in range(6, 9):
            cache, logits = bundle.decode_step(params, cache, t[:, j:j + 1])
            steps.append(logits)
        out.append(torch.stack(steps).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=1e-4, atol=1e-4)
    served = []
    for params in (host, card):
        eng = ServeEngine(bundle, params,
                          ServeConfig(batch=4, max_len=48, eos_id=-1))
        r = np.random.default_rng(1)
        for i in range(5):
            eng.submit(r.integers(2, cfg.vocab, size=int(r.integers(
                1, 9))), rid=i, max_tokens=5)
        served.append({q.rid: q.out for q in eng.run()})
    assert served[1] == served[0]


@pytest.mark.cuda
def test_c4_serve_engine_at_temperature_on_card(cuda_device):
    """Sampling at temperature > 0 on the card: the Gumbel-max draws of
    one logits row, 20000 times, follow ``softmax(logits / T)`` (each
    token's frequency within 0.01 of its probability); a seeded engine
    serves the same tokens twice; at T = 1e-6 it serves the greedy
    tokens."""
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg, bundle = _lm_smoke("qwen1.5-0.5b")
    params = bundle.init(0, device=cuda_device)
    eng = ServeEngine(bundle, params, ServeConfig(temperature=0.8),
                      rng=torch.Generator(device=cuda_device).manual_seed(5))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    row = torch.randn(cfg.vocab, generator=g, device=cuda_device) * 2
    draws = eng._sample(row.expand(20000, -1))
    freq = torch.bincount(draws.long(), minlength=cfg.vocab).float() / 20000
    prob = torch.softmax(row / 0.8, dim=-1)
    assert float((freq - prob).abs().max()) < 0.01

    def serve(temperature, seed):
        e = ServeEngine(bundle, params, ServeConfig(
            batch=4, max_len=32, eos_id=-1, temperature=temperature),
            rng=torch.Generator(device=cuda_device).manual_seed(seed))
        r = np.random.default_rng(2)
        for i in range(6):
            e.submit(r.integers(2, cfg.vocab, size=5), rid=i, max_tokens=6)
        return {q.rid: q.out for q in e.run()}

    hot = serve(0.8, 7)
    assert hot == serve(0.8, 7)
    assert all(0 <= t < cfg.vocab for out in hot.values() for t in out)
    assert serve(1e-6, 7) == serve(0.0, 7)


def _script(args, timeout=300):
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


@pytest.mark.cuda
def test_c4_launch_serve_on_card_equals_the_cpu(cuda_device):
    """``python -m repro_torch.launch.serve`` on the card (the smoke
    config, greedy): every request served, the tokens those of a CPU
    engine on the same weights; at temperature 0.7 too (a run on the card
    from the same seeds serves the same tokens again)."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import ServeConfig, ServeEngine
    argv = ["--smoke", "--requests", "6", "--max-tokens", "6"]
    line = _script(["-m", "repro_torch.launch.serve", *argv])
    assert "[serve] qwen1.5-0.5b: 6 requests, 36 tokens" in line
    done = {r.rid: r.out for r in launch_serve.main(argv)}
    cfg, bundle = _lm_smoke("qwen1.5-0.5b")
    host = {k: v.cpu() for k, v in bundle.init(0, device="cuda").items()}
    eng = ServeEngine(bundle, host, ServeConfig(batch=4, max_len=128))
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(rng.integers(2, cfg.vocab, size=int(rng.integers(4, 17))),
                   rid=i, max_tokens=6)
    assert {r.rid: r.out for r in eng.run()} == done
    hot = argv + ["--temperature", "0.7"]
    first = {r.rid: r.out for r in launch_serve.main(hot)}
    assert first == {r.rid: r.out for r in launch_serve.main(hot)}
    assert all(len(o) == 6 for o in first.values())


def _wave_is_greedy(bundle, master, done, batch):
    """Each request of one wave of ``batch`` requests is the greedy
    continuation of its left-padded prompt under the teacher-forced
    forward at the compute dtype, wherever that forward's top-2 margin
    exceeds twice its distance from the f32 forward (bf16's own rounding
    error, the yardstick of chip_smoke.py's lm checks): (clear
    positions, all positions)."""
    from repro_torch.models.common import cast_params
    from repro_torch.models.registry import get_bundle
    reqs = sorted(done, key=lambda r: r.rid)
    plen = max(len(r.prompt) for r in reqs)
    n = max(len(r.out) for r in reqs)
    toks = torch.zeros((batch, plen + n - 1), dtype=torch.int32)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):plen] = torch.from_numpy(r.prompt)
        toks[i, plen:] = torch.tensor(r.out[:-1])
    batch_in = {"tokens": toks.to(master["embed"].device)}
    b32 = get_bundle(bundle.cfg.replace(compute_dtype=torch.float32))
    with torch.no_grad():
        lo, _ = bundle.forward(cast_params(master, bundle.cfg.compute_dtype),
                               batch_in)
        hi, _ = b32.forward(master, batch_in)
    lo = lo[:, plen - 1:].float().cpu()
    hi = hi[:, plen - 1:].float().cpu()
    top2 = lo.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * (lo - hi).abs().amax(-1)
    want = torch.tensor([r.out for r in reqs])
    assert torch.equal(lo.argmax(-1)[clear], want[clear])
    return int(clear.sum()), clear.numel()


@pytest.mark.cuda
def test_c4_serve_lm_example_on_card(cuda_device, capsys):
    """``examples/torch_serve_lm.py`` at its default (qwen1.5-0.5b at the
    published width, bf16) on the card: one wave of four requests served,
    each the greedy continuation of its prompt under the forward."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    done = mod.main(["--requests", "4", "--max-tokens", "8"])
    assert "[serve] qwen1.5-0.5b: 4 requests, 32 tokens" in \
        capsys.readouterr().out
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_bundle
    bundle = get_bundle(get_config("qwen1.5-0.5b"))
    clear, total = _wave_is_greedy(bundle, bundle.init(0, device="cuda"),
                                   done, batch=4)
    assert clear >= total // 4, (clear, total)


@pytest.mark.cuda
def test_c4_quickstart_example_on_card(cuda_device):
    """``examples/torch_quickstart.py`` on the card: the restored session
    finishes, and the fleet's network equals its own session."""
    out = _script(["examples/torch_quickstart.py", "--iters", "100"])
    assert "checkpointed at iteration 50" in out
    assert "network 1 equals its own session: True" in out


@pytest.mark.cuda
def test_c4_surface_reconstruction_example_on_card(cuda_device):
    """``examples/torch_surface_reconstruction.py`` on the card
    (``cuda-full``): its rows those of the ``reference`` backend through
    iteration 50, and chi reported."""
    def rows(out):
        return [tuple(int(v) for v in re.findall(
            r"(?:it|units|signals)=\s*(\d+)", line))
            for line in out.splitlines() if line.strip().startswith("it=")]

    argv = ["examples/torch_surface_reconstruction.py", "--iters", "50"]
    card = _script(argv)
    ref = _script(argv + ["--backend", "reference"])
    assert "Euler characteristic" in card
    a = [r for r in rows(card) if r[0] <= 50]
    assert a and a == [r for r in rows(ref) if r[0] <= 50]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_lm_train_step_on_card_equals_the_cpu(cuda_device, arch):
    """One train step of the smoke config (f32, AdamW, two microbatches)
    on the card and on the CPU from one set of weights: the loss within
    1e-5, the gradient norm within 1e-4, and the parameters within 2 lr
    (AdamW's first step is about lr sign(g))."""
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.common import ShapeCfg
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.trainer import TrainConfig, make_train_step
    cfg, bundle = _lm_smoke(arch)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), microbatches=2)
    step = make_train_step(bundle, tcfg=tcfg)
    batch = synthetic_batch(cfg, ShapeCfg("t", 32, 4, "train"), device="cpu")
    host = bundle.init(0, device="cpu")
    card = {k: v.to(cuda_device, copy=True) for k, v in host.items()}
    out = {}
    for where, params in (("cpu", host), ("card", card)):
        dev = params["embed"].device
        p, _, m = step(params, init_opt_state(tcfg.opt, params),
                       {k: v.to(dev) for k, v in batch.items()})
        out[where] = (p, float(m["loss"]), float(m["gnorm"]))
    assert out["card"][1] == pytest.approx(out["cpu"][1], rel=1e-5)
    assert out["card"][2] == pytest.approx(out["cpu"][2], rel=1e-4)
    for k in host:
        assert out["card"][0][k].device.type == cuda_device.type
        diff = (out["card"][0][k].cpu() - out["cpu"][0][k]).abs().max()
        assert float(diff) <= 2 * tcfg.opt.lr + 1e-6, k


# ---------------------------------------------------------------------------
# the SOAM refresh's state ladder (kernels/topo_states)

_RING = [(i, i % 5 + 1) for i in range(1, 6)]
ICOSAHEDRON = ([(0, i) for i in range(1, 6)] + _RING
               + [(i, i + 5) for i in range(1, 6)]
               + [(i, i % 5 + 6) for i in range(1, 6)]
               + [(a + 5, b + 5) for a, b in _RING]
               + [(11, i) for i in range(6, 11)])
OCTAHEDRON = [(a, b) for a in range(6) for b in range(a + 1, 6)
              if b != a + 1 or a % 2]
TETRAHEDRON = [(a, b) for a in range(4) for b in range(a + 1, 4)]
FAN = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4)]
TWO_PAIRS = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (3, 4)]
OVERLINKED = [(0, i) for i in (1, 2, 3, 4)] + [(1, 2), (1, 3), (1, 4),
                                               (2, 3), (3, 4), (2, 4)]
TWO_TRIANGLES = [(0, i) for i in range(1, 7)] + [(1, 2), (2, 3), (3, 1),
                                                 (4, 5), (5, 6), (6, 4)]


def ladder_tables(K: int, seed: int, C: int = 96):
    """(nbr, active, firing) of three networks for the state ladder at
    threshold 0.3: random ids, some >= C; hand-built neighborhoods (closed
    surfaces, a fan, two linked pairs, an overlinked one, two triangles, a
    tetrahedron whose last row its rows name by an id >= C, rows of degree
    1 and 2, a full row) with inactive rows that keep their edges and a
    firing counter equal to the threshold in float32; an empty network.
    For K >= 6 every state of the ladder occurs."""
    g = np.random.default_rng(seed)
    nbr = np.full((3, C, K), -1, np.int32)
    nbr[0] = np.where(g.random((C, K)) < 0.5, -1,
                      g.integers(0, C + 4, (C, K)))
    net = nbr[1]

    def link(edges, off):
        for a, b in edges:
            a, b = a + off, b + off
            fa, fb = np.flatnonzero(net[a] < 0), np.flatnonzero(net[b] < 0)
            if len(fa) and len(fb):
                net[a, fa[0]], net[b, fb[0]] = b, a

    row = 0
    for edges in (ICOSAHEDRON, OCTAHEDRON, TETRAHEDRON, FAN, TWO_PAIRS,
                  OVERLINKED, TWO_TRIANGLES):
        link(edges, row)
        row += 1 + max(max(e) for e in edges)
    link([(0, 1)], row)                          # two rows of degree 1
    link([(0, 1), (1, 2)], row + 2)              # a path: degree 2 inside
    link([(0, i) for i in range(1, K + 1)], row + 5)    # a full row
    end = row + K + 7
    net[end - 1, :2] = [C + 3, C][:K]            # ids past the pool
    link(TETRAHEDRON, C - 4)
    tail = net[C - 4:C - 1]
    tail[tail == C - 1] = C + 2                  # row C - 1 named C + 2
    active = g.random((3, C)) < 0.8
    active[1, :end] = True
    active[1, [1, 13, 20]] = False               # inactive, edges kept
    firing = np.where(g.random((3, C)) < 0.75, 0.05, 0.9).astype(np.float32)
    firing[1, :end] = firing[1, C - 4:] = 0.05
    firing[1, 3] = np.float32(0.3)               # the threshold in float32
    firing[1, C - 1] = 0.9                       # no PATCH beside it
    return (torch.from_numpy(nbr), torch.from_numpy(active),
            torch.from_numpy(firing))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: the kernel's path without 16-byte loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("K", [4, 12, 16, 32])
def test_topo_states_kernel_matches_plain_version(cuda_device, K, seed):
    """The ladder kernel equals the plain version bitwise on random and
    hand-built tables, with and without 16-byte loads and unbatched; one
    launch a call, and a repeat call gives the same bits."""
    nbr, active, firing = (t.to(cuda_device) for t in ladder_tables(K, seed))
    want = compute_topo_states_plain(nbr, active, firing, 0.3)
    if K >= 6:
        assert set(want[1].unique().tolist()) == set(range(7))
    before = topo_states.launches
    got = compute_topo_states(nbr, active, firing, 0.3)
    assert topo_states.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(compute_topo_states(nbr, active, firing, 0.3), got)
    assert torch.equal(
        compute_topo_states(_misaligned(nbr), active, firing, 0.3), want)
    assert torch.equal(
        compute_topo_states(nbr[1], active[1], firing[1], 0.3), want[1])
    assert torch.equal(compute_topo_states(nbr, active, firing, 0.05),
                       compute_topo_states_plain(nbr, active, firing, 0.05))


def _grown_fleet(spec, B: int, iterations: int):
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(
        spec.replace(max_iterations=iterations), seeds=range(B)))
    fleet.run()
    return fleet.cohorts[0].fstate.nets, fleet.cohorts[0].params


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sphere4k.fleet64", "paper.fleet32"])
def test_topo_states_kernel_on_grown_fleets(cuda_device, cell):
    """At both benchmark cells' shapes (B = 64, C = 4096; B = 32,
    C = 32768; K = 16), on fleets grown by the card, and with every unit
    habituated: the kernel equals the plain version bitwise, and a call
    allocates only its (B, C) output and a (B, C) byte of scratch."""
    from repro_torch.configs import soam_paper
    spec, B = ((gson.RunSpec(), 64) if cell == "sphere4k.fleet64"
               else (soam_paper.paper_spec(), 32))
    nets, params = _grown_fleet(spec, B, 64)
    thr = params.firing_threshold
    assert nets.nbr.shape[0] == B and nets.nbr.shape[2] == 16
    for firing in (nets.firing, torch.zeros_like(nets.firing)):
        want = compute_topo_states_plain(nets.nbr, nets.active, firing, thr)
        got = compute_topo_states(nets.nbr, nets.active, firing, thr)
        assert torch.equal(got, want)
    assert int((want >= 4).sum()) > 0       # DISK or PATCH occur
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    compute_topo_states(nets.nbr, nets.active, nets.firing, thr)
    torch.cuda.synchronize()
    out_and_scratch = nets.active.numel() * (4 + 1)
    assert torch.cuda.max_memory_allocated() - base <= out_and_scratch + 1024


@pytest.mark.cuda
def test_every_refresh_on_the_fleet_path_launches_the_kernel(cuda_device):
    """A B = 4 fleet: the kernel's launches equal the refreshes (the
    ``gson.refresh`` spans of the cadence and of the checks)."""
    from repro_torch.utils import timing
    spec = gson.RunSpec(capacity=512, max_iterations=40, check_every=10)
    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(4)))
    fleet.run(budget=0)
    before = topo_states.launches
    with timing.tracing(True):
        timing.clear()
        fleet.run()
        refreshes = sum(s[0] == "gson.refresh" for s in timing.spans())
        timing.clear()
    assert refreshes >= 40 // 5
    assert topo_states.launches - before == refreshes


@pytest.mark.cuda
def test_topo_states_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    nbr = torch.full((2, 8, 33), -1, dtype=torch.int32, device=cuda_device)
    act = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    fir = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="max_deg"):
        compute_topo_states(nbr, act, fir, 0.3)
    nbr = nbr[..., :16].contiguous()
    with pytest.raises(TypeError):
        compute_topo_states(nbr.long(), act, fir, 0.3)
    with pytest.raises(TypeError):
        compute_topo_states(nbr, act, fir.double(), 0.3)
    with pytest.raises(ValueError):
        compute_topo_states(nbr.transpose(0, 1), act, fir, 0.3)
    with pytest.raises(ValueError):
        compute_topo_states(nbr, act.cpu(), fir, 0.3)


@pytest.mark.parametrize("K", [4, 12, 16, 32])
def test_topo_states_on_the_cpu_is_the_plain_version(K):
    """On CPU tensors ``compute_topo_states`` runs the plain version and
    launches nothing."""
    nbr, active, firing = ladder_tables(K, 0)
    before = topo_states.launches
    assert torch.equal(compute_topo_states(nbr, active, firing, 0.3),
                       compute_topo_states_plain(nbr, active, firing, 0.3))
    assert topo_states.launches == before


def test_topo_states_wrapper_takes_only_cuda_tensors():
    """The wrapper itself raises for a CPU or meta tensor; a meta tensor
    goes from ``compute_topo_states`` to the kernel and raises there."""
    nbr, active, firing = ladder_tables(16, 0)
    with pytest.raises(ValueError, match="expected a tensor on"):
        topo_states(nbr, active, firing, 0.3)
    with pytest.raises(ValueError, match="expected a tensor on"):
        compute_topo_states(nbr.to("meta"), active.to("meta"),
                            firing.to("meta"), 0.3)


def test_topo_states_threshold_is_compared_in_float32():
    """PyTorch compares a float32 tensor with a Python float in float32:
    the kernel gets the threshold as those float32 bits."""
    f = torch.tensor([0.3], dtype=torch.float32)
    above = float(f) + 1e-9                  # rounds to f in float32
    assert not bool(f < above)
    assert np.int32(threshold_bits(above)).view(np.float32) == f.numpy()[0]
    assert threshold_bits(0.3) == int(f.view(torch.int32))


def test_build_names_the_topo_states_source():
    """``build_all`` builds the ladder's source beside the other two."""
    src = _build.SOURCES["topo_states"]
    assert src == (ROOT / "src" / "repro_torch" / "kernels" / "topo_states"
                   / "csrc" / "topo_states.cu")
    assert src.is_file() and "repro_topo_states" in src.read_text()
    assert set(_build.SOURCES) == {"find_winners", "update_phase",
                                   "topo_states"}


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    sig = torch.zeros((1, 4, 3), device="meta")
    w = torch.zeros((1, 8, 3), device="meta")
    act = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        find_winners_top2(sig, w, act)
    f = torch.zeros((1, 4), device="meta")
    i, b = f.int(), f.bool()
    fk, age = f.new_zeros((1, 4, 2)), f.new_zeros((1, 8, 2))
    with pytest.raises(ValueError, match="expected a tensor on"):
        update_accum(sig, i, b, b, f, f, f, fk, fk, age.int(), w, i, age,
                     act)


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without nvcc (or with a broken source) the build raises; nothing
    hands over to a plain version."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("find_winners")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: broken source' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build_all()
    assert not list(tmp_path.glob("*.so"))


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A one-rank NCCL world in this process and ``make_mesh_for_env``'s
    (data 1, model 1) mesh on it."""
    import torch.distributed as dist
    from repro_torch.launch.train import make_mesh_for_env
    assert not dist.is_initialized(), "a process group is already running"
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh_for_env()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_lm_mesh_flash_decode_on_card(nccl_mesh):
    """``flash_decode`` on a one-rank NCCL mesh (one seq shard: nothing to
    merge) equals ``decode_attention`` on the card bitwise, a fully masked
    row among the lengths."""
    from repro_torch.models import attention as attn
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 1, 8, 16), generator=g, device="cuda")
    k, v = (torch.randn((4, 32, 2, 16), generator=g, device="cuda")
            for _ in range(2))
    length = torch.tensor([32, 17, 0, 25], dtype=torch.int32, device="cuda")
    got = attn.flash_decode(nccl_mesh, q, k, v, length)
    assert torch.equal(got, attn.decode_attention(q, k, v, length))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 1])
def test_lm_mesh_moe_ep_on_card(nccl_mesh, s):
    """``moe_ffn_ep`` of the qwen2-moe smoke config on a one-rank NCCL mesh
    against the dense reference on the card, without drops (capacity 8):
    within 2e-3, the aux within 1e-2 (JAX's tolerances)."""
    from repro_torch.models.moe import moe_ffn_ep, moe_ffn_reference
    cfg, bundle = _lm_smoke("qwen2-moe-a2.7b")
    cfg = cfg.replace(capacity_factor=8.0)
    params = bundle.init(0, device="cuda")
    lp = {k[len("layers/"):]: v[0] for k, v in params.items()
          if k.startswith("layers/")}
    g = torch.Generator(device="cuda").manual_seed(1)
    x = 0.5 * torch.randn((8, s, cfg.d_model), generator=g, device="cuda")
    y, aux = moe_ffn_ep(lp, x, cfg, nccl_mesh)
    y_ref, aux_ref = moe_ffn_reference(lp, x, cfg)
    torch.testing.assert_close(y, y_ref, rtol=2e-3, atol=2e-3)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-2)


@pytest.mark.cuda
def test_lm_mesh_decode_on_card(nccl_mesh):
    """The qwen1.5-0.5b smoke config's prefill and three decode steps
    through ``build_prefill_step`` / ``build_decode_step`` on a one-rank
    NCCL mesh against the unmeshed model on the card: within 1e-5."""
    from repro_torch.launch import steps
    from repro_torch.models import placement
    from repro_torch.models.common import ShapeCfg
    cfg, bundle = _lm_smoke("qwen1.5-0.5b")
    dep = steps.deploy_for("qwen1.5-0.5b", "decode_32k")
    rules = steps.rules_for_deploy(nccl_mesh, dep)
    full = bundle.init(0, device="cuda")
    params = placement.shard_params(full, bundle.param_specs(rules),
                                    nccl_mesh)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (4, 12)).astype(np.int32)).cuda()
    pstep, _ = steps.build_prefill_step(
        bundle, nccl_mesh, rules, ShapeCfg("p", 16, 4, "prefill"), dep)
    dstep, _ = steps.build_decode_step(
        bundle, nccl_mesh, rules, ShapeCfg("d", 16, 4, "decode"), dep)
    out = []
    for run in ((pstep, dstep, params), (None, None, full)):
        if run[0] is None:
            cache, logits = bundle.prefill(full, {"tokens": toks[:, :9]},
                                           max_len=16)
            dec = lambda c, t: bundle.decode_step(full, c, t)  # noqa: E731
        else:
            cache, logits = pstep(params, {"tokens": toks[:, :9]})
            dec = lambda c, t: dstep(params, c, t)  # noqa: E731
        got = [logits]
        for j in range(9, 12):
            cache, logits = dec(cache, toks[:, j:j + 1])
            got.append(logits)
        out.append(torch.stack(got))
    torch.testing.assert_close(out[0], out[1], rtol=1e-5, atol=1e-5)


def test_chip_smoke_names_every_kernel_of_the_sources():
    """chip_smoke.py counts a wrapper's device launches and sums the
    port's kernels in its profile by the names in DEVICE_KERNELS: every
    __global__ of the CUDA sources is named there, and nothing else."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    declared = {n for names in smoke.DEVICE_KERNELS.values() for n in names}
    defined = set()
    for src in _build.SOURCES.values():
        defined |= set(re.findall(r"__global__\s+void\s+"
                                  r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                  src.read_text()))
    assert declared == defined
