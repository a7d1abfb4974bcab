"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` need the card (the kernels have no CPU mode: on a
CPU tensor a wrapper runs its plain version, which the parity files hold
against the JAX package). On the H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports no JAX, so it runs where JAX is not installed.
Contract: Find Winners ids bitwise where the three nearest distances are
more than 1e-4 apart, distances within rtol=2e-4, atol=1e-5; the lock
and edge aging bitwise; the accumulators' winner fields bitwise and
their neighbor sums within rtol=1e-6, atol=1e-7; every kernel bitwise
repeatable. The remaining tests run here: no fallback hides a missing
build or a tensor the kernels do not take.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch import gson
from repro_torch.core.gson.multi import (find_winners_reference,
                                         multi_signal_step, stable_units,
                                         update_phase_inputs,
                                         update_phase_reference)
from repro_torch.core.gson.sampling import make_sampler
from repro_torch.core.gson.state import GSONParams, init_state
from repro_torch.kernels import _build
from repro_torch.kernels.find_winners import (find_winners_top2,
                                              find_winners_top2_plain)
from repro_torch.kernels.update_phase import (BIG_PRIO, edge_age,
                                              edge_age_plain, update_accum,
                                              update_accum_plain,
                                              update_phase_op,
                                              winner_lock_min,
                                              winner_lock_min_plain)

torch.set_num_threads(1)
D_TOL = dict(rtol=2e-4, atol=1e-5)
W_TOL = dict(rtol=1e-6, atol=1e-7)


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
    args = [x[None].contiguous() for x in (
        sig, wid, selected, adapt, scale_b, d2b, dec_b, scale_n, dec_n,
        st.nbr, st.w)]
    got = update_accum(*args)
    again = update_accum(*args)
    plain = update_accum_plain(*args)
    names = ("w1", "nsc", "nsx", "err", "decb_u", "decn_u", "wind")
    for name, k, k2, q in zip(names, got, again, plain):
        assert torch.equal(k, k2), f"{name} not repeatable"
        if name in ("w1", "err", "decb_u", "wind"):
            assert torch.equal(k, q), f"{name} not bitwise"
        torch.testing.assert_close(k, q, **W_TOL)
    win = got[-1][0] > 0
    reset = torch.rand(st.nbr.shape, device=cuda_device) < 0.05
    eargs = [x[None].contiguous() for x in (st.age, st.nbr, win,
                                            stable_units(st, p), reset)]
    out = edge_age(*eargs)
    assert torch.equal(out, edge_age(*eargs))
    assert torch.equal(out, edge_age_plain(*eargs))


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
                                   update_accum, edge_age)]
    spec = gson.RunSpec(variant="multi-fused", capacity=512,
                        max_iterations=40, check_every=10)
    st, stats = gson.run(spec, seed=0)
    after = [f.launches for f in (find_winners_top2, winner_lock_min,
                                  update_accum, edge_age)]
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
# no fallback (these run on any host)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    sig = torch.zeros((1, 4, 3), device="meta")
    w = torch.zeros((1, 8, 3), device="meta")
    act = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        find_winners_top2(sig, w, act)
    age = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        edge_age(age, age.int(), act, act, age.bool())


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
