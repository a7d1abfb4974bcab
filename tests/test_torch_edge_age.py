"""Edge aging inside the fused accumulator launch, held on the CPU.

The CUDA kernel (``accum_group_kernel`` in
``src/repro_torch/kernels/update_phase/csrc/update_phase.cu``) ages each
slot (c, j) from what its lane holds: the validated owner of c (the
selected signal whose winner is c), the validated owner of nb =
nbr[c, j], their adapt flags and their seconds. ``per_slot_age`` states
that rule in plain PyTorch. These tests hold it bitwise against

* the plain version, ``edge_slots(nbr, wid, sid, adapt)`` then
  ``edge_age_plain`` (the aged table that ``update_accum`` returns on
  the CPU), on hand-made tables for the edge cases and on random ones;
* the JAX package's ``update_phase_op`` run in interpret mode (the
  Pallas ``_edge_age_kernel``), on pools grown by the port, for all
  three models, masked and unmasked.

The kernel itself is held against the plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (grown_state, lock_priorities,  # noqa: E402
                           phase_inputs, t, to_jax_state)
from repro.kernels.update_phase.ops import \
    update_phase_op as jax_op  # noqa: E402
from repro_torch.core.gson.multi import (stable_units,  # noqa: E402
                                         update_phase_inputs)
from repro_torch.core.gson.topology import edge_slots  # noqa: E402
from repro_torch.kernels.update_phase import (  # noqa: E402
    edge_age_plain, update_accum, update_accum_plain, update_phase_op)

torch.set_num_threads(1)


def per_slot_age(age, nbr, wid, sel, adapt, sid, stable):
    """The kernel's rule, slot by slot: age (B, C, K) f32, nbr (B, C, K)
    i32, wid, sid (B, M) i32, sel, adapt (B, M) bool, stable (B, C) bool
    -> (B, C, K) f32. Selected signals must have distinct winners."""
    B, C, K = nbr.shape
    out = torch.empty_like(age)
    for b in range(B):
        s = sel[b] & (wid[b] >= 0) & (wid[b] < C)
        owner = torch.full((C,), -1, dtype=torch.long)
        owner[wid[b][s].long()] = torch.nonzero(s)[:, 0]
        assert int(s.sum()) == int((owner >= 0).sum()), "winners not distinct"
        nb = nbr[b].long()
        valid = nb >= 0
        nbc = nb.clamp(0, C - 1)
        ow = owner[:, None]                                # c's owner
        on = torch.where(valid, owner[nbc], -1)            # nb's owner

        def adapts(o):
            return (o >= 0) & adapt[b][o.clamp(min=0)]

        def second(o):
            return torch.where(adapts(o), sid[b][o.clamp(min=0)].long(), -1)

        units = torch.arange(C)[:, None]
        # the first slot of row c that holds nb
        js = (nb[:, :, None] == nb[:, None, :]).to(torch.int32).argmax(2)
        first = valid & (nb < C) & (js == torch.arange(K))
        reset = first & ((second(ow) == nb) | (second(on) == units))
        win_c = (ow >= 0).to(torch.float32)
        winat = (on >= 0).to(torch.float32)
        keep = stable[b][:, None] & valid & stable[b][nbc]
        inc = ((win_c + winat) * valid.to(torch.float32)
               * (1.0 - keep.to(torch.float32)))
        out[b] = torch.where(reset, 0.0, age[b] + inc)
    return out


def plain_age(age, nbr, wid, sel, adapt, sid, stable):
    """The aged table of ``update_accum`` on the CPU (its plain version),
    with the accumulator inputs set to zeros; checked against
    ``edge_slots`` + ``edge_age_plain`` spelled out."""
    B, C, K = nbr.shape
    M = wid.shape[1]
    z = torch.zeros
    args = (z((B, M, 3)), wid, sel, adapt, z((B, M)), z((B, M)), z((B, M)),
            z((B, M, K)), z((B, M, K)), nbr, z((B, C, 3)), sid, age, stable)
    got = update_accum(*args)[-1]
    win = torch.zeros((B, C), dtype=torch.bool)
    for b in range(B):
        win[b, wid[b][sel[b]].long()] = True
    reset = torch.stack([edge_slots(nbr[b], wid[b], sid[b], adapt[b])
                         for b in range(B)])
    assert torch.equal(got, edge_age_plain(age, nbr, win, stable, reset))
    assert torch.equal(got, update_accum_plain(*args)[-1])
    return got


def check(age, nbr, wid, sel, adapt, sid, stable):
    """The rule equals the plain version bitwise; returns the table."""
    args = [torch.as_tensor(np.asarray(a)) for a in (
        age, nbr, wid, sel, adapt, sid, stable)]
    args[0] = args[0].to(torch.float32)
    for i in (1, 2, 5):
        args[i] = args[i].to(torch.int32)
    for i in (3, 4, 6):
        args[i] = args[i].to(torch.bool)
    got = plain_age(*args)
    assert torch.equal(per_slot_age(*args), got)
    return got


# ---------------------------------------------------------------------------
# hand-made tables: one network, C = 6, K = 4 unless said otherwise


def _table(rows, C=6, K=4):
    nbr = np.full((1, C, K), -1, np.int32)
    for c, row in rows.items():
        nbr[0, c, :len(row)] = row
    return nbr


def _ages(nbr, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 9, nbr.shape).astype(np.float32)


def _signals(pairs, adapt=None):
    """(wid, sid) of selected signals; all adapt unless ``adapt``."""
    wid = np.array([[w for w, _ in pairs]], np.int32)
    sid = np.array([[s for _, s in pairs]], np.int32)
    sel = np.ones_like(wid, bool)
    ad = sel if adapt is None else np.array([adapt])
    return wid, sel, ad, sid


def test_single_active_unit_has_itself_as_second():
    """One active unit: winner and second are the same unit, no slot to
    reset, nothing to age."""
    nbr = _table({}, C=4)
    age = np.zeros(nbr.shape, np.float32)
    wid, sel, ad, sid = _signals([(0, 0)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 4), bool))
    assert torch.equal(got, torch.zeros_like(got))


def test_second_equal_to_winner_resets_nothing():
    nbr = _table({0: [1, 2], 1: [0], 2: [0]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(0, 0)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    # the winner's row and the slots pointing back at it age by one
    assert got[0, 0, 0] == age[0, 0, 0] + 1 and got[0, 1, 0] == age[0, 1, 0] + 1
    assert (got != 0).all()


def test_winner_second_edge_not_there_yet():
    """(0, 3) is no edge: no slot is reset, the winner's row ages."""
    nbr = _table({0: [1, 2], 1: [0], 2: [0], 3: [4], 4: [3]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(0, 3)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert (got[0][nbr[0] >= 0] != 0).all()
    assert got[0, 3, 0] == age[0, 3, 0] and got[0, 0, 1] == age[0, 0, 1] + 1


def test_existing_winner_second_edge_resets_both_slots():
    nbr = _table({0: [1, 2], 1: [0], 2: [3, 0], 3: [2]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(0, 2)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert got[0, 0, 1] == 0 and got[0, 2, 1] == 0
    assert got[0, 2, 0] == age[0, 2, 0]           # (2, 3): no winner near


def test_mutual_pair_resets_from_both_owners():
    """Two selected signals, each with the other's winner as second: the
    slots of (0, 1) are reset from both sides, once."""
    nbr = _table({0: [2, 1], 1: [0, 3], 2: [0], 3: [1]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(0, 1), (1, 0)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert got[0, 0, 1] == 0 and got[0, 1, 0] == 0
    # (0, 2) and (1, 3) lie in one winner's row each: +1 on both sides
    assert got[0, 0, 0] == age[0, 0, 0] + 1 and got[0, 2, 0] == age[0, 2, 0] + 1


def test_only_the_reverse_half_resets():
    """The owner of 1 names 0 as its second, 0 wins nothing: the reset
    comes from the neighbor's owner alone."""
    nbr = _table({0: [1], 1: [0]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(1, 0)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert got[0, 0, 0] == 0 and got[0, 1, 0] == 0


def test_selected_but_not_adapting_ages_without_reset():
    """A signal that inserts (selected, not adapting) still makes its
    winner a winner, but refreshes no edge."""
    nbr = _table({0: [1], 1: [0]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(0, 1)], adapt=[False])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert got[0, 0, 0] == age[0, 0, 0] + 1 and got[0, 1, 0] == age[0, 1, 0] + 1


def test_stable_stable_edges_do_not_age():
    nbr = _table({0: [1, 2], 1: [0, 2], 2: [0, 1]})
    age = _ages(nbr)
    stable = np.array([[True, True, False, False, False, False]])
    wid, sel, ad, sid = _signals([(0, 5), (1, 4)])
    got = check(age, nbr, wid, sel, ad, sid, stable)
    assert got[0, 0, 0] == age[0, 0, 0] and got[0, 1, 0] == age[0, 1, 0]
    # (0, 2) and (1, 2) have one unstable end: each of their slots ages
    # by one, for the winner at one end
    assert got[0, 0, 1] == age[0, 0, 1] + 1 and got[0, 2, 0] == age[0, 2, 0] + 1
    assert got[0, 2, 1] == age[0, 2, 1] + 1


def test_both_ends_winners_age_by_two():
    nbr = _table({0: [1], 1: [0]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(0, 3), (1, 3)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert got[0, 0, 0] == age[0, 0, 0] + 2 and got[0, 1, 0] == age[0, 1, 0] + 2


def test_asymmetric_row_and_duplicate_slot():
    """A row that names a neighbor which does not name it back, and a row
    that names one neighbor twice (only its first slot is reset): the
    rule does not rely on symmetric edges."""
    nbr = _table({0: [1, 2], 1: [3], 2: [0, 4, 0], 4: [2]})
    age = _ages(nbr)
    wid, sel, ad, sid = _signals([(1, 0), (2, 0)])
    got = check(age, nbr, wid, sel, ad, sid, np.zeros((1, 6), bool))
    assert got[0, 0, 0] == 0 and got[0, 0, 1] == 0 and got[0, 2, 0] == 0
    assert got[0, 2, 2] == age[0, 2, 2] + 1         # the duplicate ages


# ---------------------------------------------------------------------------
# random networks: any degree, fleets, masked rows


def _random_fleet(seed, B, C, K, M, n_active, symmetric=True):
    rng = np.random.default_rng(seed)
    nets = []
    for _ in range(B):
        nbr = np.full((C, K), -1, np.int32)
        for a, b in rng.integers(0, n_active, (n_active * K, 2)):
            if a == b or (nbr[a] == b).any():
                continue
            fa, fb = np.flatnonzero(nbr[a] < 0), np.flatnonzero(nbr[b] < 0)
            if len(fa) and (len(fb) or not symmetric):
                nbr[a, rng.choice(fa)] = b
                if len(fb) and (symmetric or rng.random() < 0.8):
                    nbr[b, rng.choice(fb)] = a
        wid = rng.integers(0, n_active, M).astype(np.int32)
        # a second that is mostly a neighbor, sometimes any unit or the
        # winner itself
        sid = rng.integers(0, n_active, M).astype(np.int32)
        for i in range(M):
            row = nbr[wid[i]][nbr[wid[i]] >= 0]
            u = rng.random()
            if len(row) and u < 0.7:
                sid[i] = rng.choice(row)
            elif u < 0.8:
                sid[i] = wid[i]
        prio = rng.permutation(M)
        prio[M // 2:] = M      # the second half masked out
        best = np.full(C, M + 1)
        np.minimum.at(best, wid, prio)
        sel = (prio == best[wid]) & (prio < M)
        adapt = sel & (rng.random(M) < 0.8)
        nets.append(dict(age=rng.integers(1, 30, (C, K)).astype(np.float32),
                         nbr=nbr, wid=wid, sel=sel, adapt=adapt, sid=sid,
                         stable=rng.random(C) < 0.3))
    return [np.stack([n[k] for n in nets]) for k in (
        "age", "nbr", "wid", "sel", "adapt", "sid", "stable")]


@pytest.mark.parametrize("B,K", [(1, 4), (1, 6), (2, 16), (2, 40)])
def test_rule_matches_plain_version_on_random_networks(B, K):
    """K = 6 is not a multiple of 4, K = 40 is more than 32 slots (the
    kernel's chunked slot loop); B = 2 is a fleet."""
    args = _random_fleet(K, B, 120, K, 256, 90)
    got = check(*args)
    age = torch.from_numpy(args[0])
    assert (got == 0).any()                         # resets happened
    assert (got > age).any() and (got == age).any()


def test_rule_matches_plain_version_on_asymmetric_networks():
    args = _random_fleet(5, 2, 120, 8, 256, 90, symmetric=False)
    nbr = args[1][0]
    rows, slots = np.nonzero(nbr >= 0)
    assert not all((nbr[nbr[r, s]] == r).any() for r, s in zip(rows, slots))
    check(*args)


# ---------------------------------------------------------------------------
# grown pools against the JAX package


@pytest.mark.parametrize("masked", [None, 23])
@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_rule_matches_plain_version_and_jax(model, masked):
    """On a pool grown by the port, the rule, the plain version and the
    JAX ``update_phase_op`` (Pallas, interpret mode) age the edges alike,
    bitwise."""
    p, tp, st = grown_state(model)
    sig, wid, sid, d2b, k_lock, mask = phase_inputs(st, masked=masked)
    prio = lock_priorities(k_lock, sig.shape[0])
    tmask = None if mask is None else t(mask)
    out = update_phase_op(st, t(sig), t(wid), t(sid), t(d2b), prio, tp,
                          tmask)
    tw, ts = t(wid).to(torch.int32), t(sid).to(torch.int32)
    _, adapt, scale_b, dec_b, _, _, _, scale_n, dec_n = \
        update_phase_inputs(st, tw, t(d2b), out.selected, tp)
    assert torch.equal(adapt, out.adapt)
    stable = stable_units(st, tp)
    rule = per_slot_age(st.age[None], st.nbr[None], tw[None],
                        out.selected[None], adapt[None], ts[None],
                        stable[None])[0]
    plain = update_accum_plain(*[a.contiguous()[None] for a in (
        t(sig), tw, out.selected, adapt, scale_b, t(d2b), dec_b, scale_n,
        dec_n, st.nbr, st.w, ts, st.age, stable)])[-1][0]
    jout = jax_op(to_jax_state(st), jnp.asarray(sig), wid, sid, d2b, k_lock,
                  p, None if mask is None else jnp.asarray(mask),
                  interpret=True)
    assert torch.equal(rule, plain)
    assert torch.equal(out.age, plain)
    np.testing.assert_array_equal(np.asarray(jout.age), rule.numpy())
    assert bool(edge_slots(st.nbr, tw, ts, adapt).any())
