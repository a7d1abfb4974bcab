"""Step factories of the port (``repro.launch.steps``'s counterpart): the
per-cell deployment table and the sharded train / prefill / decode
programs.

Sharding recipe (JAX's, realized as ``repro_torch.models.placement``
says: each rank holds its blocks and gathers per layer what it reads):
  params        TP over 'model' + FSDP over 'data' (per the ParamSet
                logical-axis table), layer axis unsharded
  activations   batch over ('pod', 'data'); SP (seq over 'model') is
                recorded and changes nothing
  KV caches     seq over 'model' (flash decode), batch over ('pod',
                'data'); the cross K/V on kv heads, the SSD state on heads
                and the conv tail on channels over 'model'
                (``cache_specs``)
  optimizer     moments inherit the param specs (match_opt_specs)

``DEPLOY`` is JAX's table of per-(arch, shape) deployments, entry for
entry. Each ``build_*`` returns the step and its abstract arguments
(``meta`` tensors; the parameters as this rank's ``placement.Sharded``
blocks). The steps take the global batch (or token column) on every
rank, as JAX's take global arrays, and the cache as this rank's block;
they return this rank's blocks and rows. With ``mesh=None`` the same
factories run on one device. ``lower_cell`` gives the cell's dry-run row
(``launch/dryrun.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.models import placement
from repro_torch.models.act_sharding import (ActivationSharding,
                                             activation_sharding)
from repro_torch.models.common import ModelConfig, P, ShapeCfg
from repro_torch.models.registry import ModelBundle
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.trainer import TrainConfig, make_train_step


# ---------------------------------------------------------------------------
# per-cell deployment config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeployCfg:
    microbatches: int = -1           # -1 = auto: 1 sequence/device/microbatch
    seq_shard: bool = False          # SP on residuals
    optimizer: str = "adamw"
    compress_pods: bool = False
    straggler_masking: bool = False
    accum_dtype: str = "f32"         # "bf16" halves the grad-accum buffer
    lr: float = 3e-4
    # --- sharding-policy knobs ---
    # tp="none": no tensor parallelism; the model axis joins the batch
    # axes (pure DP x FSDP)
    tp: str = "model"                # "model" | "none"
    # fsdp=False: decode keeps the weights resident (not FSDP-sharded)
    fsdp: bool = True
    # fsdp_wide: shard params over (data, model)
    fsdp_wide: bool = False
    # serve in bf16 weights (halves both the weight residency and the
    # weight-streaming bytes per token)
    serve_bf16: bool = False


# keyed by (arch, shape); fall back to (arch, None) then DEFAULT
_SMALL_DENSE = ("granite-3-2b", "qwen1.5-0.5b", "mamba2-2.7b",
                "zamba2-2.7b", "whisper-medium")
# decode: weights stay resident in bf16
_DECODE_RESIDENT = ("yi-34b", "internvl2-76b", "granite-3-2b",
                    "qwen1.5-0.5b", "mamba2-2.7b", "zamba2-2.7b",
                    "whisper-medium", "qwen2-moe-a2.7b")

DEPLOY: dict = {
    ("llama3-405b", "train_4k"): DeployCfg(
        seq_shard=True, optimizer="adafactor", accum_dtype="bf16"),
    ("llama3-405b", None): DeployCfg(optimizer="adafactor", seq_shard=True),
    ("qwen3-moe-235b-a22b", "train_4k"): DeployCfg(accum_dtype="bf16"),
    ("internvl2-76b", "train_4k"): DeployCfg(accum_dtype="bf16"),
    ("yi-34b", "train_4k"): DeployCfg(tp="none", fsdp_wide=True,
                                      accum_dtype="bf16"),
    ("qwen3-moe-235b-a22b", "prefill_32k"): DeployCfg(seq_shard=True),
    ("internvl2-76b", "prefill_32k"): DeployCfg(seq_shard=True),
    ("yi-34b", "prefill_32k"): DeployCfg(seq_shard=True),
    ("llama3-405b", "prefill_32k"): DeployCfg(
        optimizer="adafactor", seq_shard=True),
    ("llama3-405b", "decode_32k"): DeployCfg(
        optimizer="adafactor", serve_bf16=True),
    ("qwen3-moe-235b-a22b", "decode_32k"): DeployCfg(serve_bf16=True),
}
for _a in _SMALL_DENSE:
    DEPLOY.setdefault((_a, "train_4k"),
                      DeployCfg(tp="none", accum_dtype="bf16"))
    DEPLOY.setdefault((_a, "prefill_32k"), DeployCfg(tp="none"))
for _a in _DECODE_RESIDENT:
    DEPLOY.setdefault((_a, "decode_32k"),
                      DeployCfg(fsdp=False, serve_bf16=True))
    DEPLOY.setdefault((_a, "long_500k"),
                      DeployCfg(fsdp=False, serve_bf16=True))
DEFAULT_DEPLOY = DeployCfg()


def deploy_for(arch: str, shape: str) -> DeployCfg:
    return DEPLOY.get((arch, shape),
                      DEPLOY.get((arch, None), DEFAULT_DEPLOY))


def resolve_deploy(dep: DeployCfg, shape: ShapeCfg, mesh=None) -> DeployCfg:
    """Make the deploy concrete for this (shape, mesh): auto microbatch
    count targets one sequence per device per microbatch, clamped to a
    divisor of the global batch."""
    mb = dep.microbatches
    if shape.kind != "train":
        mb = 1
    elif mb == -1:
        sizes = axis_sizes(mesh)
        axes = ("pod", "data", "model") if dep.tp == "none" \
            else ("pod", "data")
        shards = 1
        for a in axes:
            if a in sizes and shape.global_batch % (shards * sizes[a]) == 0:
                shards *= sizes[a]
        mb = max(shape.global_batch // shards, 1)
    while shape.global_batch % mb != 0:
        mb -= 1
    return replace(dep, microbatches=mb) if mb != dep.microbatches else dep


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict:
    """The mesh's axis sizes (none without a mesh)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes_for(mesh, b: int, include_model: bool = False) -> tuple:
    """Greedy ('pod','data'[,'model']) prefix whose product divides b."""
    sizes = axis_sizes(mesh)
    axes = ("pod", "data", "model") if include_model else ("pod", "data")
    out, prod = [], 1
    for a in axes:
        if a in sizes and b % (prod * sizes[a]) == 0:
            out.append(a)
            prod *= sizes[a]
    return tuple(out)


def rules_for_deploy(mesh, dep: DeployCfg):
    """Mesh rules with the deploy's sharding policy applied."""
    from repro_torch.models.common import rules_for_mesh
    rules = rules_for_mesh(mesh)
    kw = {}
    if dep.tp == "none":
        kw["tensor_axis"] = None
        kw["batch_axes"] = tuple(
            a for a in ("pod", "data", "model")
            if a in rules.mesh_axis_sizes)
    if dep.fsdp_wide:
        kw["fsdp_axis"] = tuple(
            a for a in ("data", "model") if a in rules.mesh_axis_sizes)
    if not dep.fsdp:
        kw["fsdp_axis"] = None
    return replace(rules, **kw) if kw else rules


def param_tree(bundle: ModelBundle, mesh, rules):
    """(abstract params: this rank's blocks as ``meta`` tensors in a
    ``placement.Sharded`` tree, specs dict)."""
    specs = bundle.param_specs(rules)
    return placement.shard_params(bundle.param_shapes(), specs, mesh), specs


def batch_specs(cfg: ModelConfig, shape: ShapeCfg, mesh,
                include_model: bool = False) -> dict:
    """PartitionSpecs for every input_specs() leaf of a train/prefill cell."""
    bat = batch_axes_for(mesh, shape.global_batch, include_model)
    bspec = P(bat if bat else None, None)
    out = {"tokens": bspec, "labels": bspec}
    if cfg.family == "vlm":
        out["img_embeds"] = P(bat if bat else None, None, None)
    if cfg.family == "encdec":
        out["frames"] = P(bat if bat else None, None, None)
    return out


def cache_specs(cfg: ModelConfig, cache_shapes: dict, mesh, b: int) -> dict:
    """Per-leaf PartitionSpec for a KV/SSM cache (its leaves as tensors or
    shapes).

    Layouts (leading L/n_inv axis never sharded):
      k, v     (L, B, S, KV, Dh)   batch x (seq -> model)   flash decode
      ck, cv   (L, B, Te, KV, Dh)  batch x (kv -> model)    cross-attn
      ssm      (L, B, H, P, N)     batch x (heads -> model)
      hx       (L, B, dc-1, Di)    batch x (channels -> model)
      hb, hc   (L, B, dc-1, N)     batch only (tiny)
      length   (B,)                batch
    """
    sizes = axis_sizes(mesh)
    tp = sizes.get("model", 1)
    bat = batch_axes_for(mesh, b)
    bat_p = bat if bat else None

    def spec_of(name: str, s) -> P:
        shp = tuple(getattr(s, "shape", s))
        if name == "length":
            return P(bat_p)
        if name in ("k", "v"):
            seq = "model" if shp[2] % tp == 0 else None
            return P(None, bat_p, seq, None, None)
        if name in ("ck", "cv"):
            kv = "model" if shp[3] % tp == 0 else None
            return P(None, bat_p, None, kv, None)
        if name == "ssm":
            h = "model" if shp[2] % tp == 0 else None
            return P(None, bat_p, h, None, None)
        if name == "hx":
            c = "model" if shp[3] % tp == 0 else None
            return P(None, bat_p, None, c)
        if name in ("hb", "hc"):
            return P(None, bat_p, None, None)
        return P(*([None] * len(shp)))

    return {k: spec_of(k, v) for k, v in cache_shapes.items()}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def build_train_step(bundle: ModelBundle, mesh, rules, dep: DeployCfg):
    """Returns (step, abstract (params, opt_state), TrainConfig); on a
    mesh the step runs under the deploy's activation layout and the
    abstract state is this rank's blocks."""
    tcfg = TrainConfig(
        opt=OptConfig(name=dep.optimizer, lr=dep.lr),
        microbatches=dep.microbatches,
        compress_pods=dep.compress_pods,
        straggler_masking=dep.straggler_masking,
        accum_dtype=dep.accum_dtype,
    )
    if placement.check_mesh(mesh) is None:
        step = make_train_step(bundle, None, rules, tcfg)
        params = bundle.param_shapes()
        return step, (params, opt_lib.init_opt_state(tcfg.opt, params)), tcfg
    # the pod axis is manual in the compress/straggler step, so the
    # activation layout there may only reference the other axes
    pod_manual = dep.compress_pods or dep.straggler_masking
    bat = tuple(a for a in rules.batch_axes
                if not (pod_manual and a == "pod"))
    act = ActivationSharding(
        batch_axes=bat, seq_axis="model" if dep.seq_shard else None)
    step = make_train_step(
        bundle, mesh, rules, tcfg,
        act_ctx=lambda: activation_sharding(
            act, mesh,
            manual_axes=frozenset({"pod"}) if pod_manual else frozenset()))
    params, _ = param_tree(bundle, mesh, rules)
    return step, (params, opt_lib.init_opt_state(tcfg.opt, params)), tcfg


def train_batch_abstract(bundle: ModelBundle, shape: ShapeCfg, mesh=None,
                         include_model: bool = False) -> dict:
    """The cell's inputs as ``meta`` tensors (global: every rank is given
    the whole batch)."""
    return bundle.input_specs(shape)


# ---------------------------------------------------------------------------
# prefill / decode programs
# ---------------------------------------------------------------------------

def build_prefill_step(bundle: ModelBundle, mesh, rules, shape: ShapeCfg,
                       dep: DeployCfg):
    """(step, abstract (params, batch)); ``step(params, batch) -> (cache,
    logits)``: this rank's block of the cache (``cache_specs``) and its
    rows of the last position's logits."""
    act = ActivationSharding(
        batch_axes=rules.batch_axes if rules is not None else (),
        seq_axis="model" if dep.seq_shard else None)
    params = (param_tree(bundle, mesh, rules)[0]
              if placement.check_mesh(mesh) is not None
              else bundle.param_shapes())
    batch = train_batch_abstract(bundle, shape, mesh,
                                 include_model=(dep.tp == "none"))
    batch.pop("labels", None)

    def step(params, batch):
        with activation_sharding(act, mesh):
            return bundle.prefill(params, batch, max_len=shape.seq_len,
                                  mesh=mesh)

    return step, (params, batch)


def build_decode_step(bundle: ModelBundle, mesh, rules, shape: ShapeCfg,
                      dep: DeployCfg):
    """(step, abstract (params, cache, token)); ``step(params, cache,
    token) -> (cache, logits)`` writes this rank's block of the cache in
    place and returns its rows of the logits; ``token`` is the whole
    (B, 1) column."""
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    if placement.check_mesh(mesh) is None:
        params = bundle.param_shapes()
        cache = bundle.cache_shapes(b, shape.seq_len)
    else:
        params, _ = param_tree(bundle, mesh, rules)
        cshapes = bundle.cache_shapes(b, shape.seq_len)
        cache = placement.shard_cache(
            cshapes, cache_specs(bundle.cfg, cshapes, mesh, b), mesh)

    def step(params, cache, token):
        return bundle.decode_step(params, cache, token, mesh=mesh)

    return step, (params, cache, token)


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if it doesn't."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k decode needs a "
                       "sub-quadratic path (DESIGN.md §6)")
    return True, ""


def lower_cell(arch_cfg: ModelConfig, shape_name: str, mesh,
               dep: DeployCfg | None = None, shapes: dict | None = None
               ) -> dict:
    """The cell's dry-run row (``launch.dryrun.run_cell``): JAX lowers
    the cell through XLA here; the port has no compiler to ask, and
    reads the cell's FLOPs, residency and collectives instead. ``mesh``:
    an ``LMMesh`` (``dryrun.sized_mesh`` needs no process group) or None
    for one device."""
    from repro_torch.launch import dryrun
    return dryrun.run_cell(arch_cfg, shape_name, mesh, shapes=shapes,
                           dep=dep)
