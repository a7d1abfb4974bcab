"""Step factories of the port (``repro.launch.steps``'s counterpart): the
per-cell deployment table and the train step on one device.

``DEPLOY`` is JAX's table of per-(arch, shape) deployments, entry for
entry (microbatching, sequence sharding, the optimizer, the gradient
accumulator's dtype, the sharding policy, bf16 serving). On one device
the mesh is None and has one shard, so ``resolve_deploy``'s automatic
microbatch count gives one sequence per microbatch, and the sharding
knobs (``seq_shard``, ``tp``, ``fsdp``, ``fsdp_wide``) have nothing to
act on.

``build_train_step`` returns the step, the abstract arguments (``meta``
tensors: nothing allocated) and the ``TrainConfig``, as in JAX. The
sharded prefill and decode programs, the parameter and cache specs and
the deploy's sharding rules wait for the LM's meshes (ROADMAP A15f);
``lower_cell`` lowers through XLA and waits for the XLA tooling (A15g).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.models.common import ModelConfig, ShapeCfg
from repro_torch.models.registry import ModelBundle
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.trainer import TrainConfig, make_train_step

_A15F = "ROADMAP A15f"


def _mesh_raise(what: str):
    raise NotImplementedError(f"{what} is not ported yet: {_A15F}")


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
    # --- sharding-policy knobs (no effect on one device) ---
    tp: str = "model"                # "model" | "none"
    fsdp: bool = True
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


def axis_sizes(mesh) -> dict:
    """The mesh's axis sizes: none on one device (``mesh=None``)."""
    if mesh is not None:
        _mesh_raise("the LM on a mesh")
    return {}


def resolve_deploy(dep: DeployCfg, shape: ShapeCfg, mesh=None) -> DeployCfg:
    """Make the deploy concrete for this shape on one device: the auto
    microbatch count targets one sequence per device per microbatch,
    clamped to a divisor of the global batch."""
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


def batch_axes_for(mesh, b: int, include_model: bool = False) -> tuple:
    _mesh_raise("batch sharding over a mesh")


def rules_for_deploy(mesh, dep: DeployCfg):
    _mesh_raise("the deploy's sharding rules")


def param_tree(bundle: ModelBundle, mesh, rules):
    _mesh_raise("sharded abstract parameters")


def batch_specs(cfg: ModelConfig, shape: ShapeCfg, mesh,
                include_model: bool = False) -> dict:
    _mesh_raise("batch partition specs")


def cache_specs(cfg: ModelConfig, cache_shapes: dict, mesh, b: int) -> dict:
    _mesh_raise("cache partition specs")


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def build_train_step(bundle: ModelBundle, mesh, rules, dep: DeployCfg):
    """Returns (step, abstract (params, opt_state) as ``meta`` tensors,
    TrainConfig). ``mesh`` must be None; ``rules`` is unused."""
    tcfg = TrainConfig(
        opt=OptConfig(name=dep.optimizer, lr=dep.lr),
        microbatches=dep.microbatches,
        compress_pods=dep.compress_pods,
        straggler_masking=dep.straggler_masking,
        accum_dtype=dep.accum_dtype,
    )
    step = make_train_step(bundle, mesh, rules, tcfg)
    params = bundle.param_shapes()
    return step, (params, opt_lib.init_opt_state(tcfg.opt, params)), tcfg


def train_batch_abstract(bundle: ModelBundle, shape: ShapeCfg, mesh=None,
                         include_model: bool = False) -> dict:
    """The cell's inputs as ``meta`` tensors."""
    axis_sizes(mesh)
    return bundle.input_specs(shape)


# ---------------------------------------------------------------------------
# prefill / decode programs and the cell driver
# ---------------------------------------------------------------------------

def build_prefill_step(bundle: ModelBundle, mesh, rules, shape: ShapeCfg,
                       dep: DeployCfg):
    _mesh_raise("the sharded prefill program")


def build_decode_step(bundle: ModelBundle, mesh, rules, shape: ShapeCfg,
                      dep: DeployCfg):
    _mesh_raise("the sharded decode program")


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if it doesn't."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k decode needs a "
                       "sub-quadratic path (DESIGN.md §6)")
    return True, ""


def lower_cell(arch_cfg: ModelConfig, shape_name: str, mesh,
               dep: DeployCfg | None = None, shapes: dict | None = None):
    raise NotImplementedError(
        "lowering a cell through XLA is not ported yet: ROADMAP A15g")
