"""The port's checkpoint manager and ``Session.checkpoint/restore``.

Mirrors ``tests/test_checkpoint.py`` case by case (roundtrip, latest,
``.tmp`` directories ignored, missing leaf, shape mismatch, async saves
with retention, dtype cast, the format-2 manifest), on trees of torch
tensors. The JAX file's elastic-resharding case restores onto a device
mesh, which the port does not have yet (ROADMAP A14): it has no
counterpart here. Beyond those: snapshots move between the JAX manager
and the port's in both directions (same format 2), orphans are removed,
a tampered newest step falls back to the one before it, and a restored
``Session`` continues exactly the run it was cut from, for ``multi`` and
``multi-fused`` (also under the JAX draws).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import gson
from repro_torch.checkpoint import CheckpointManager, restore, save
from repro_torch.checkpoint import manager as mgr
from repro_torch.core.gson.state import GSONParams

torch.set_num_threads(1)

STATE_FIELDS = ("w", "active", "nbr", "age", "error", "firing",
                "threshold", "topo_state", "inconsistent_for",
                "n_active", "signal_count", "discarded")


def tree(seed=0):
    r = np.random.default_rng(seed)
    f32 = torch.float32
    return {
        "params": {"w": torch.tensor(r.standard_normal((4, 3)), dtype=f32),
                   "b": torch.tensor(r.standard_normal(3), dtype=f32)},
        "opt": {"m": torch.zeros((4, 3)),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def leaves(t):
    return [v for _, v in mgr._flatten(t)]


def assert_tree_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_exact(tmp_path):
    t = tree()
    save(str(tmp_path), t, step=3, extra={"loss": 1.25})
    out, step, extra = restore(str(tmp_path), t)
    assert step == 3
    assert extra["loss"] == 1.25
    assert_tree_equal(t, out)


def test_latest_and_multiple_steps(tmp_path):
    for s in (1, 5, 3):
        save(str(tmp_path), tree(s), step=s)
    assert mgr.latest(str(tmp_path)) == 5
    out, step, _ = restore(str(tmp_path), tree())
    assert step == 5
    assert_tree_equal(tree(5), out)


def test_tmp_dirs_ignored(tmp_path):
    save(str(tmp_path), tree(), step=1)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest(str(tmp_path)) == 1


def test_missing_leaf_raises(tmp_path):
    t = tree()
    save(str(tmp_path), t, step=1)
    t2 = dict(t)
    t2["extra_leaf"] = torch.zeros((2,))
    with pytest.raises(KeyError):
        restore(str(tmp_path), t2)


def test_shape_mismatch_raises(tmp_path):
    t = tree()
    save(str(tmp_path), t, step=1)
    t2 = tree()
    t2["params"]["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        restore(str(tmp_path), t2)


def test_async_manager_and_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        m.save_async(tree(s), step=s)
    m.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [4, 5]
    out, step, _ = m.restore(tree())
    assert step == 5
    assert_tree_equal(tree(5), out)


def test_dtype_cast_on_restore(tmp_path):
    save(str(tmp_path), {"w": torch.ones((3,), dtype=torch.float32)}, step=1)
    target = {"w": torch.empty((3,), dtype=torch.bfloat16)}
    out, _, _ = restore(str(tmp_path), target)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.ones((3,), dtype=torch.bfloat16))


def test_manifest_is_valid_json(tmp_path):
    save(str(tmp_path), tree(), step=12)
    with open(tmp_path / "step_00000012" / "manifest.json") as f:
        man = json.load(f)
    assert man["step"] == 12
    assert man["format"] == 2
    assert set(man["leaves"]) == set(man["keys"])
    assert len(man["keys"]) == 4
    assert "['params']['w']" in man["keys"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_format_2_moves_between_the_packages(tmp_path, writer):
    """A tree of numpy arrays written by one package's manager loads in
    the other's, keys, values and dtypes intact."""
    jmgr = pytest.importorskip("repro.checkpoint.manager")
    host = {k: np.asarray(v) for k, v in mgr._host_tree(tree(4)).items()}
    np_tree = {"params": {"w": host["['params']['w']"],
                          "b": host["['params']['b']"]},
               "opt": {"m": host["['opt']['m']"],
                       "step": host["['opt']['step']"]}}
    if writer == "jax":
        jmgr.save(str(tmp_path), np_tree, step=2, extra={"a": 1})
        out, step, extra = restore(str(tmp_path), tree())
        assert_tree_equal(tree(4), out)
    else:
        save(str(tmp_path), tree(4), step=2, extra={"a": 1})
        out, step, extra = jmgr.restore(str(tmp_path), np_tree)
        for k in ("w", "b"):
            np.testing.assert_array_equal(out["params"][k],
                                          np_tree["params"][k])
        assert out["opt"]["step"].dtype == np.int32
    assert (step, extra) == (2, {"a": 1})


def test_orphan_tmp_is_ignored_and_removed(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(tree(1), step=1)
    orphan = tmp_path / "step_00000002.tmp"
    os.makedirs(orphan)
    (orphan / "arrays.npz").write_bytes(b"half a write")
    assert mgr.latest(str(tmp_path)) == 1          # ignored ...
    assert orphan.exists()
    assert m.latest() == 1                         # ... and removed
    assert not orphan.exists()
    out, step, _ = m.restore(tree())
    assert step == 1
    assert_tree_equal(tree(1), out)


def test_tampered_newest_step_falls_back(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(tree(1), step=1)
    m.save(tree(2), step=2)
    arrays = tmp_path / "step_00000002" / "arrays.npz"
    arrays.write_bytes(arrays.read_bytes()[:40])   # truncated
    with pytest.warns(RuntimeWarning, match="step 2"):
        out, step, _ = m.restore(tree())
    assert step == 1
    assert_tree_equal(tree(1), out)
    with pytest.raises(ValueError, match="corrupt array file"):
        m.restore(tree(), step=2)


# ---------------------------------------------------------------------------
# Session.checkpoint / Session.restore


def short_spec(variant, **kw) -> gson.RunSpec:
    base = dict(variant=variant,
                model=GSONParams(model="gwr", insertion_threshold=0.5),
                sampler="sphere", capacity=128, max_deg=12,
                max_iterations=40, check_every=10, qe_threshold=1e-9,
                n_probe=256, device="cpu")
    base.update(kw)
    return gson.RunSpec(**base)


def assert_states_equal(a, b, ctx=""):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{ctx}: field {name!r} differs"


@pytest.mark.parametrize("variant", ["multi", "multi-fused"])
def test_session_restore_matches_uninterrupted(tmp_path, variant):
    spec = short_spec(variant)
    a = gson.Session(spec, seed=3)
    a.run()

    b = gson.Session(spec, seed=3, checkpoint_dir=str(tmp_path))
    b.run(budget=17)            # not on a check boundary
    b.checkpoint()
    rows_b = list(b.stats.history)
    del b                       # the process dies

    c = gson.Session.restore(spec, str(tmp_path))
    assert c.iteration == 17
    assert c.stats.history == rows_b
    c.resume()
    st_a, stats_a = a.result()
    st_c, stats_c = c.result()
    assert_states_equal(st_a, st_c, variant)
    assert (stats_c.iterations, stats_c.units, stats_c.signals) == (
        stats_a.iterations, stats_a.units, stats_a.signals)
    if variant == "multi":      # one row per check, wherever the cut is
        assert stats_c.history == stats_a.history


def test_periodic_checkpoints_restore_the_newest(tmp_path):
    spec = short_spec("multi", model="soam", max_iterations=30)
    a = gson.Session(spec, seed=1)
    a.run()
    b = gson.Session(spec, seed=1, checkpoint_dir=str(tmp_path),
                     checkpoint_every=10, keep=2)
    b.run(budget=25)
    # the cadence of the JAX Session: the first snapshot after
    # checkpoint_every iterations counted from -1
    assert mgr.valid_steps(str(tmp_path)) == [9, 19]
    c = gson.Session.restore(spec, str(tmp_path), keep=2)
    assert (c.iteration, c.checkpoint_every) == (19, 10)
    c.run()
    assert_states_equal(a.result()[0], c.result()[0])
    assert c.stats.history == a.stats.history
    assert mgr.valid_steps(str(tmp_path)) == [19, 29]


def test_session_restore_under_the_jax_draws(tmp_path):
    """The replayed JAX draws save and restore their keys: a restored
    port session still emits the JAX session's rows."""
    pytest.importorskip("jax")
    from _torch_parity import JaxReplayDraws
    from repro import gson as jgson

    spec = short_spec("multi", model="soam")
    jspec = jgson.RunSpec(**{k: getattr(spec, k) for k in (
        "variant", "sampler", "capacity", "max_deg", "max_iterations",
        "check_every", "qe_threshold", "n_probe")}, model="soam")
    jsess = jgson.Session(jspec, seed=5)
    jsess.run()

    b = gson.Session(spec, JaxReplayDraws("sphere", seed=5),
                     checkpoint_dir=str(tmp_path))
    b.run(budget=23)
    b.checkpoint()
    c = gson.Session.restore(spec, str(tmp_path),
                             draws=JaxReplayDraws("sphere", seed=0))
    c.run()
    assert len(c.stats.history) == len(jsess.stats.history) == 4
    for row, jrow in zip(c.stats.history, jsess.stats.history):
        assert (row["iteration"], row["units"], row["signals"]) == (
            jrow["iteration"], jrow["units"], jrow["signals"])
        assert row["qe"] == pytest.approx(jrow["qe"], rel=1e-5, abs=1e-7)
