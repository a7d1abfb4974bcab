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
from repro_torch.core.gson.topology import edge_slots
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams, init_state
from repro_torch.kernels import _build
from repro_torch.kernels.find_winners import (find_winners_top2,
                                              find_winners_top2_plain)
from repro_torch.kernels.update_phase import (BIG_PRIO, edge_age_plain,
                                              update_accum,
                                              update_accum_plain,
                                              update_phase_op,
                                              winner_lock_min,
                                              winner_lock_min_plain)

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
                                     (3, 100, 700, 5), (1, 7, 2, 3)])
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


@pytest.mark.cuda
def test_find_winners_ties_go_to_the_lowest_id(cuda_device):
    sig = torch.zeros((1, 5, 3), device=cuda_device)
    w = torch.zeros((1, 3000, 3), device=cuda_device)     # all equidistant
    act = torch.ones((1, 3000), dtype=torch.bool, device=cuda_device)
    act[0, :7] = False
    _, ids = find_winners_top2(sig, w, act)
    assert (ids[0] == torch.tensor([7, 8], device=cuda_device)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_active", [0, 1, 2, 300])
def test_find_winners_kernel_on_sparse_pools(cuda_device, n_active):
    """Pools of 4096 slots with few active units, scattered: the kernel
    scans only the active ones, and every unit when fewer than two are
    active, where an inactive unit (+1e30) fills the top-2."""
    g = torch.Generator(device=cuda_device).manual_seed(n_active)
    sig = torch.randn((1, 8192, 3), generator=g, device=cuda_device)
    w = torch.randn((1, 4096, 3), generator=g, device=cuda_device)
    act = torch.zeros((1, 4096), dtype=torch.bool, device=cuda_device)
    where = torch.randperm(4096, generator=g, device=cuda_device)[:n_active]
    act[0, where] = True
    d2k, idk = find_winners_top2(sig, w, act)
    d2p, idp = find_winners_top2_plain(sig, w, act)
    torch.testing.assert_close(d2k, d2p, **D_TOL)
    ok = near_tie_free(sig[0], w[0], act[0])
    if n_active < 2:
        assert torch.equal(idk, idp)
    else:
        assert ok.float().mean() > 0.9
        assert torch.equal(idk[0][ok], idp[0][ok])


def _pool(dev, model="soam", capacity=1024, max_deg=16, iters=60, m=256):
    p = GSONParams(model=model, insertion_threshold=0.3)
    sampler = make_sampler("torus")
    g = torch.Generator(device=dev).manual_seed(0)
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
