"""The port's winner-neighborhood slab Update phase against the JAX one.

Mirrors ``tests/test_kernels_update_sparse.py``. A pool grown by the port
goes to both packages with the same signals, winners and lock priorities
(the JAX ``permutation(k_lock, m)``); the port's ``update_phase_sparse``
(on the CPU: the plain versions of its two kernels) is held

* against the JAX ``update_phase_sparse`` (Pallas in interpret mode):
  ``selected``/``adapt``/``ins``/``age`` bitwise, floats within
  rtol=1e-6, atol=1e-7 (``W_TOL`` of the JAX file: neighbor sums add
  colliding pulls in another order);
* against the port's dense ``update_phase_op``: bitwise in every field
  (the same sums, added in the same slot order).

Which branch runs — the slab, the dense fallback of the run-time check,
or the dense path when the slab would be the whole pool — is counted by
the port and compared with a numpy statement of the JAX package's rule
(``sparse.py``: the tile and slab budget, the touched-tile set, ``G >=
n_tiles`` and ``n_touched <= G``).
"""
from __future__ import annotations

import functools

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (assert_update_out_match,  # noqa: E402
                           grown_state, lock_priorities, phase_inputs,
                           relabel, t, to_jax_state, torch_params)
from repro.core.gson.multi import \
    find_winners_reference as jax_find_winners  # noqa: E402
from repro.core.gson.state import GSONParams as JaxParams  # noqa: E402
from repro.kernels.update_phase.sparse import \
    default_slab_tiles as jax_default_slab_tiles  # noqa: E402
from repro.kernels.update_phase.sparse import \
    update_phase_sparse as jax_sparse  # noqa: E402
from repro_torch.core.gson.state import stack_states  # noqa: E402
from repro_torch.kernels.update_phase.ops import \
    update_phase_op  # noqa: E402
from repro_torch.kernels.update_phase.sparse import (  # noqa: E402
    default_slab_tiles, update_phase_sparse)

torch.set_num_threads(1)
# the grown pools are read, never written: grow each once
grown = functools.lru_cache(maxsize=None)(grown_state)


def jax_branch(st, wid, sid, m: int, tile: int, slab) -> str:
    """The branch the JAX slab takes (numpy statement of its rule)."""
    C = st.capacity
    tile = min(tile, -(-C // 128) * 128)
    n_tiles = -(-C // tile)
    G = (jax_default_slab_tiles(m, tile, n_tiles) if slab is None
         else max(1, min(slab, n_tiles)))
    if G >= n_tiles:
        return "pool"
    nbr = st.nbr.numpy()
    wc = np.clip(np.asarray(wid), 0, C - 1)
    ids = np.concatenate([wc, np.clip(np.asarray(sid), 0, C - 1),
                          np.maximum(nbr[wc], 0).ravel()])
    return "slab" if len(np.unique(ids // tile)) <= G else "dense"


def branch_counts():
    return (update_phase_sparse.slab_calls, update_phase_sparse.dense_calls,
            update_phase_sparse.pool_calls)


def branch_taken(before) -> str:
    after = branch_counts()
    moved = [name for name, a, b in zip(("slab", "dense", "pool"), after,
                                        before) if a != b]
    assert len(moved) == 1 and sum(after) == sum(before) + 1, moved
    return moved[0]


def check_both(p, tp, st, sig, wid, sid, d2b, k_lock, mask=None, *,
               tile=256, slab=None, tag=""):
    """Port slab vs JAX slab and vs the port's dense path; returns the
    branch the port took (asserted equal to the JAX rule's)."""
    m = sig.shape[0]
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax_sparse(to_jax_state(st), jnp.asarray(sig), wid, sid, d2b,
                      k_lock, p, jmask, block_c=tile, slab_tiles=slab,
                      interpret=True)
    args = (st, t(sig), t(wid), t(sid), t(d2b), lock_priorities(k_lock, m),
            tp, None if mask is None else t(mask))
    before = branch_counts()
    got = update_phase_sparse(*args, tile=tile, slab_tiles=slab)
    branch = branch_taken(before)
    assert branch == jax_branch(st, wid, sid, m, tile, slab), tag
    assert_update_out_match(want, got, tag=f"{tag} vs jax")
    for name, a, b in zip(got._fields, got, update_phase_op(*args)):
        assert torch.equal(a, b), f"{tag} {name} differs from update_phase_op"
    return got, branch


def test_default_slab_tiles_matches_jax():
    for m in (1, 32, 37, 64, 128, 129, 512, 768, 4096):
        for tile in (128, 256):
            for n_tiles in (1, 2, 3, 8, 16, 32):
                assert default_slab_tiles(m, tile, n_tiles) == \
                    jax_default_slab_tiles(m, tile, n_tiles)


@pytest.mark.parametrize("masked", [None, 17])
@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_sparse_matches_jax_and_dense(model, masked):
    # capacity 512 in 128-unit tiles, m = 32: a 1-tile slab
    p, tp, st = grown(model, capacity=512)
    inputs = phase_inputs(st, m=32, masked=masked)
    got, branch = check_both(p, tp, st, *inputs, tile=128,
                             tag=f"{model} masked={masked}")
    assert branch == "slab"
    if masked is not None:
        assert not got.selected[masked:].any()


@pytest.mark.parametrize("cap,m,tile,slab,branch", [
    (300, 48, 128, None, "slab"),     # misaligned capacity
    (520, 37, 128, 2, "slab"),        # everything misaligned, tight budget
    (100, 1, 256, None, "pool"),      # one signal, one tile
    (512, 64, 128, 1, "slab"),        # a 1-tile budget, compact pool
    (2176, 64, 256, None, "slab"),    # big pool, modest batch (the regime)
])
def test_sparse_shape_sweep(cap, m, tile, slab, branch):
    p, tp, st = grown("gwr", capacity=cap, iters=10)
    inputs = phase_inputs(st, m=m)
    _, taken = check_both(p, tp, st, *inputs, tile=tile, slab=slab,
                          tag=f"cap={cap} m={m} tile={tile} slab={slab}")
    assert taken == branch


def fragmented(model="gwr", capacity=512):
    """A grown network relabelled into bands by x: the lowest third of its
    units in tile 0 (ids 0-127), the middle third in tile 1, the top
    third in tile 2; tile 3 free. Edges join neighboring bands. The
    network is a SOAM one (GNG grows too few units in a short run); the
    returned params are ``model``'s."""
    _, _, st = grown("soam", capacity=200, iters=25)
    p = JaxParams(model=model, insertion_threshold=0.3)
    tp = torch_params(p)
    act = np.nonzero(st.active.numpy())[0]
    order = act[np.argsort(st.w.numpy()[act, 0], kind="stable")]
    new_ids = np.full(st.capacity, -1)
    for band, ids in enumerate(np.array_split(order, 3)):
        new_ids[ids] = 128 * band + np.arange(len(ids))
    free = np.setdiff1d(np.arange(capacity), new_ids[new_ids >= 0])
    new_ids[new_ids < 0] = free[:int((new_ids < 0).sum())]
    return p, tp, relabel(st, new_ids, capacity)


def signals_near(st, ids, seed=0, scale=1e-3):
    """Signals just off the units ``ids``, with the JAX winners."""
    rng = np.random.default_rng(seed)
    w = st.w.numpy()[ids]
    sig = (w + scale * rng.standard_normal(w.shape)).astype(np.float32)
    wid, sid, d2b, _ = jax_find_winners(jnp.asarray(sig),
                                        jnp.asarray(st.w.numpy()),
                                        jnp.asarray(st.active.numpy()))
    return sig, wid, sid, d2b


@pytest.mark.parametrize("model", ["soam", "gwr", "gng"])
def test_fragmented_pool_with_off_slab_neighbors(model):
    """Signals in the lowest band touch tile 0 (and at most tile 1); a
    2-tile slab then holds tiles 0 and 1, whose units in the middle band
    have neighbors in tile 2, off the slab. Exact all the same."""
    import jax
    p, tp, st = fragmented(model)
    nbr = st.nbr.numpy()
    a, b = np.nonzero(nbr >= 0)
    crossing = ((a // 128 <= 1) & (nbr[a, b] // 128 >= 2)).sum()
    assert crossing > 0, "no slab row has an off-slab neighbor"
    # units of tile 0 whose neighbors all lie in tile 0
    inner = [u for u in range(128) if st.active[u]
             and np.all(nbr[u][nbr[u] >= 0] < 128)]
    sig, wid, sid, d2b = signals_near(st, inner[:24])
    assert np.all(np.asarray(wid) < 128)
    _, branch = check_both(p, tp, st, sig, wid, sid, d2b,
                           jax.random.key(3), tile=128, slab=2,
                           tag=f"{model} fragmented")
    assert branch == "slab"


def test_guard_falls_back_on_a_fragmented_pool():
    # random signals over the whole surface touch all three bands, more
    # than a 1-tile slab holds: the dense fallback, exact all the same
    p, tp, st = fragmented("soam")
    _, branch = check_both(p, tp, st, *phase_inputs(st, m=48), tile=128,
                           slab=1, tag="guard")
    assert branch == "dense"


def test_duplicate_winner_pressure():
    """Many signals, few units: post-lock survivors must stay distinct
    and equal the JAX slab's (the remap must not merge or split ids)."""
    p, tp, st = grown("gwr", capacity=640, iters=8, m=16)
    inputs = phase_inputs(st, m=256)
    got, branch = check_both(p, tp, st, *inputs, tile=128, slab=2,
                             tag="dup-winners")
    assert branch == "slab"
    winners = np.asarray(inputs[1])[got.selected.numpy()]
    assert 0 < len(winners) == len(set(winners.tolist()))


def test_last_collision_mode_raises():
    _, _, st = grown("gwr", capacity=512, iters=5)
    tp = torch_params(JaxParams(model="gwr", neighbor_collision="last"))
    sig, wid, sid, d2b, k_lock, _ = phase_inputs(st, m=32)
    with pytest.raises(NotImplementedError, match="last"):
        update_phase_sparse(st, t(sig), t(wid), t(sid), t(d2b),
                            lock_priorities(k_lock, 32), tp, tile=128)


@pytest.mark.parametrize("mixed", [False, True])
def test_batch_of_four_equals_four_single_calls(mixed):
    """B = 4 networks on the slab equal four B = 1 calls, bitwise. With
    ``mixed``, network 3 is fragmented past the budget: the whole batch
    takes the dense path, while networks 0-2 alone take the slab — both
    branches are exact, so the state is the same."""
    p = None
    nets, ins = [], []
    for seed in range(4):
        if mixed and seed == 3:
            p, tp, st = fragmented("soam")
        else:
            p, tp, st = grown("soam", capacity=512, seed=seed)
        nets.append(st)
        sig, wid, sid, d2b, k_lock, _ = phase_inputs(st, m=40, seed=seed)
        ins.append((t(sig), t(wid), t(sid), t(d2b),
                    lock_priorities(k_lock, 40)))
    alone = []
    for st, args in zip(nets, ins):
        before = branch_counts()
        alone.append(update_phase_sparse(st, *args, tp, tile=128,
                                         slab_tiles=1))
        branch_taken(before)
    before = branch_counts()
    batch = update_phase_sparse(
        stack_states(nets), *(torch.stack(x) for x in zip(*ins)), tp,
        tile=128, slab_tiles=1)
    assert branch_taken(before) == ("dense" if mixed else "slab")
    for b, out in enumerate(alone):
        for name, x, y in zip(out._fields, out, batch):
            assert torch.equal(x, y[b]), f"network {b} {name}"
