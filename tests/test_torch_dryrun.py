"""The port's dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) on the CPU, with no process group.

* The FLOP counter (``roofline.count_flops``, ``step_flops``) on the
  hand-counted cases of ``tests/test_hlo_analysis.py`` that have a
  counterpart: a plain matmul exactly, a batched dot, a loop of layers
  as its trip count times one (eager PyTorch runs every iteration, so
  no trip count is read), a gradient as forward plus backward, a
  4-layer model as four times one layer, and the remat's second
  forward.
* ``model_flops``, ``active_param_count``, ``analytic_residency_bytes``
  and ``analytic_memory_bytes`` equal to JAX's for the ten registry
  configs and the four shapes.
* Dry-run rows of the smoke ``yi-34b``, ``qwen3-moe-235b-a22b`` and
  ``zamba2-2.7b`` on (pod 2, data 2, model 2) through
  ``steps.lower_cell`` (the counterpart of
  ``test_smoke_cells_lower_on_pod_mesh``), every rank's parameter blocks
  summing to the global bytes times their replicas, the CLI's exit codes
  and a ``--gson`` row.
"""
from __future__ import annotations

import json
import math

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jrl
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, mesh as lmesh, roofline as rl, steps
from repro_torch.models import common, placement, registry

torch.set_num_threads(1)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


# ---------------------------------------------------------------------------
# the FLOP counter


def test_plain_matmul_exact():
    a, b = meta(128, 256), meta(256, 512)
    assert rl.count_flops(lambda: a @ b) == 2 * 128 * 256 * 512


def test_batched_dot_counts_batch_dims():
    a, b = meta(4, 32, 64), meta(4, 64, 16)
    assert rl.count_flops(lambda: torch.einsum("bij,bjk->bik", a, b)) == \
        2 * 4 * 32 * 64 * 16


def layers(x, ws, inner: int = 1):
    for w in ws:
        for _ in range(inner):
            x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("inner", [1, 3])
def test_layer_loop_is_its_trip_count_times_one(inner):
    x, ws = meta(128, 256), meta(7, 256, 256)
    one = rl.count_flops(lambda: layers(x, ws[:1], 1))
    assert one == 2 * 128 * 256 * 256
    assert rl.count_flops(lambda: layers(x, ws, inner)) == 7 * inner * one


def test_gradient_counts_forward_plus_backward():
    """Forward plus two backward products per layer (the cotangents of
    the input and of the weight): 3x, as JAX's scan gradient."""
    x, ws = meta(128, 256, grad=True), meta(7, 256, 256, grad=True)

    def grad():
        torch.autograd.grad(layers(x, ws).sum(), [x, ws])
    assert rl.count_flops(grad) == 3 * 7 * 2 * 128 * 256 * 256


def smoke(arch, **kw):
    return registry.get_bundle(registry.smoke_config(get_config(arch))
                               .replace(**kw))


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_four_layer_model_is_four_times_one_layer(kind):
    shape = common.SMOKE_SHAPES[kind]
    f = {n: rl.step_flops(smoke("qwen1.5-0.5b", n_layers=n), shape)
         for n in (1, 2, 4)}
    layer = f[2] - f[1]
    assert layer > 0 and f[4] - f[1] == 3 * layer


def test_remat_recompute_is_counted():
    """``remat="full"`` runs each layer's forward a second time in the
    backward, and the count grows by what that runs: the layer's forward
    but its last product, which ``torch.utils.checkpoint`` does not
    recompute (it stops once the tensors the backward reads are back, and
    none reads ``w_down``'s output)."""
    shape = common.SMOKE_SHAPES["train_4k"]
    none = rl.step_flops(smoke("qwen1.5-0.5b", remat="none"), shape)
    full = rl.step_flops(smoke("qwen1.5-0.5b", remat="full"), shape)
    pre = common.ShapeCfg("p", shape.seq_len, shape.global_batch, "prefill")
    fwd = {n: rl.step_flops(smoke("qwen1.5-0.5b", n_layers=n), pre)
           for n in (1, 2)}
    cfg = smoke("qwen1.5-0.5b").cfg
    w_down = 2 * shape.global_batch * shape.seq_len * cfg.d_ff * cfg.d_model
    assert full - none == cfg.n_layers * (fwd[2] - fwd[1] - w_down) > 0


# ---------------------------------------------------------------------------
# JAX's analytic functions


def configs():
    return [(jax_get_config(a), get_config(a)) for a in ARCHS]


@pytest.mark.parametrize("shape_name", SHAPES)
def test_analytic_terms_equal_jax(shape_name):
    jshape, shape = jcommon.SHAPES[shape_name], common.SHAPES[shape_name]
    for jc, tc in configs():
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            jc2, tc2 = jc.replace(compute_dtype=jdt), tc.replace(
                compute_dtype=tdt)
            jb, tb = jreg.get_bundle(jc2), registry.get_bundle(tc2)
            n_act = rl.active_param_count(tc2, tb.param_shapes())
            assert n_act == jrl.active_param_count(jc2, jb.param_shapes())
            assert rl.model_flops(tc2, shape, n_act) == \
                jrl.model_flops(jc2, jshape, n_act)
            for kw in ({}, dict(microbatches=8, act_shards=16, opt_bytes=7,
                                cache_bytes=11, accum_bytes_per_param=2)):
                want = jrl.analytic_residency_bytes(
                    jc2, jshape, 1000003, 256, 5000011, **kw)
                got = rl.analytic_residency_bytes(
                    tc2, shape, 1000003, 256, 5000011, **kw)
                assert got == want, (tc.name, kw)
            for kw in ({}, dict(microbatches=4, param_bytes=99991,
                                cache_bytes=12345)):
                assert rl.analytic_memory_bytes(
                    tc2, shape, 1000003, 256, **kw) == \
                    jrl.analytic_memory_bytes(jc2, jshape, 1000003, 256,
                                              **kw), (tc.name, kw)


def test_card_constants():
    """The H100 SXM's data-sheet rates, one place (``launch.mesh``)."""
    assert (lmesh.PEAK_FLOPS_BF16, lmesh.HBM_BW, lmesh.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert 80e9 <= lmesh.HBM_PER_CARD < 2**37


# ---------------------------------------------------------------------------
# the dry run


POD = ((2, 2, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("arch", ["yi-34b", "qwen3-moe-235b-a22b",
                                  "zamba2-2.7b"])
def test_smoke_cells_on_pod_mesh(arch):
    mesh = dryrun.sized_mesh(*POD)
    cfg = registry.smoke_config(get_config(arch))
    for shp in ("train_4k", "decode_32k"):
        row = steps.lower_cell(cfg, shp, mesh, shapes=common.SMOKE_SHAPES)
        assert row["status"] == "ok" and row["chips"] == 8, row
        assert row["mesh"] == "pod2_data2_model2"
        assert row["step_flops"] > 0 and row["model_flops"] > 0
        assert row["flops"] == row["flops_per_rank"] * 8
        assert row["flops_per_rank"] * row["batch_shards"] == \
            row["step_flops"]
        assert row["bytes_per_device"] == row["residency"]["total"] > 0
        assert "batch shards" in row["notes"]
        kinds = set(row["coll_detail"]["bytes"])
        assert "all-gather" in kinds
        if shp == "train_4k":
            assert {"reduce-scatter", "all-reduce"} <= kinds
        if cfg.family == "moe":
            assert "all-to-all" in kinds
        if cfg.family == "hybrid" and shp == "decode_32k":
            assert "all-reduce" in kinds       # flash_decode's merge
        for t in ("t_compute", "t_memory", "t_collective"):
            assert math.isfinite(row[t]) and row[t] >= 0
        json.dumps(row)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_rank_blocks_sum_to_global_times_replicas(arch):
    cfg = registry.smoke_config(get_config(arch))
    b = registry.get_bundle(cfg)
    shapes = b.param_shapes()
    shape = common.SMOKE_SHAPES["decode_32k"]
    dep = steps.deploy_for(arch, "train_4k")
    want = None
    got = 0.0
    for rank in range(8):
        mesh = dryrun.sized_mesh(*POD, rank=rank)
        rules = steps.rules_for_deploy(mesh, dep)
        got += rl.rank_residency(b, shape, mesh, rules, dep)["params"]
        if want is None:
            specs = b.param_specs(rules)
            want = sum(v.numel() * v.element_size()
                       * placement.replicas(specs[k], mesh)
                       for k, v in shapes.items())
    assert got == want


def test_cli_runs_a_cell_and_fails_on_a_failed_one(tmp_path, monkeypatch):
    out = tmp_path / "d"
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 0
    row = json.loads((out / "qwen1.5-0.5b__decode_32k__single_pod_16x16"
                      ".json").read_text())
    assert row["status"] == "ok" and row["chips"] == 256
    assert row["batch_shards"] == 16            # decode: rows over data
    skipped = json.loads(json.dumps(dryrun.run_cell(
        get_config("qwen1.5-0.5b"), "long_500k", None)))
    assert skipped["status"] == "skipped"

    def broken(*a, **kw):
        raise RuntimeError("a cell that fails")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 1


def test_gson_rows(tmp_path):
    assert dryrun.main(["--gson", "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "gson_multi_pod_2x16x16.json").read_text())
    data, net = res["data"], res["network"]
    assert data["ranks"] == net["ranks"] == 512 and data["status"] == "ok"
    # the paper's m = 8192 signals: 16 per rank under the signal split,
    # one (4, m) int32 gather per step; the unit split gathers (2, m, 2n)
    assert data["signal_bytes_per_rank"] == 16 * 3 * 4
    assert data["collectives_per_step"]["all-gather"]["bytes"] == 4 * 8192 * 4
    assert net["collectives_per_step"]["all-gather"]["bytes"] == \
        2 * 8192 * 2 * 512 * 4
    assert data["state_bytes_per_rank"] == net["state_bytes_per_rank"] > 0
    fleet = res["network_mesh_fleet"]
    assert fleet["collectives_per_tick"]["all-gather"]["bytes"] == 6 * 512 * 8
