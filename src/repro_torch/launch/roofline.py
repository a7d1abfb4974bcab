"""Roofline terms of the port's cells (``repro.launch.roofline``'s
counterpart), on the card's numbers (``launch.mesh``).

Three terms per (arch x shape x mesh) cell, in seconds:

  compute    = step FLOPs / (chips * PEAK_FLOPS_BF16)
  memory     = analytic HBM bytes / (chips * HBM_BW)
  collective = collective bytes / (chips * NVLINK_BW)

The JAX package reads FLOPs, bytes and collectives from XLA's compiled
artifacts (``cost_analysis``, ``memory_analysis``, the HLO text and its
loop-aware parse in ``hlo_analysis.py``). Eager PyTorch has no such
artifact, so here:

* **FLOPs** come from running the step itself: :func:`step_flops` runs
  the unsharded step on the ``meta`` device under
  ``torch.utils.flop_counter.FlopCounterMode`` (no memory, no compute).
  Every layer runs as a Python loop, so no trip count is needed. The
  counter counts matrix products (``mm``, ``bmm``, their ``addmm``
  forms, ``einsum``'s products), 2 per multiply-add, as the HLO count
  counts dots; elementwise work is not counted.
* **Collectives** come from the parameter and cache specs, the port's
  realization of the mesh (``models/placement.py``):
  :func:`mesh_collectives`.
* **Residency** per rank comes from the specs through
  ``placement.block``: :func:`rank_residency`.

The analytic functions (:func:`analytic_residency_bytes`,
:func:`analytic_memory_bytes`, :func:`model_flops`,
:func:`active_param_count`) are JAX's, line for line.

**FLOPs under the port's realization.** A rank computes on its rows of
the batch with the compute replicated over the other axes (tensor
parallelism is sharded storage, not Megatron products). So a rank
executes the step's FLOPs over the batch shards, not over the chips:
``RooflineCell.flops`` sums that over the chips, and the compute term is
the per-rank time. ``useful_flops_frac`` (the 6ND model FLOPs over the
executed ones) shows the replication.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


@dataclass
class RooflineCell:
    """One cell's roofline. ``flops``: the FLOPs the ranks execute,
    summed over the chips (per rank x chips); ``hbm_bytes``: the analytic
    global HBM traffic; ``coll_bytes``: collective output bytes summed
    over the chips; ``bytes_per_device``: one rank's residency."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_detail: dict = field(default_factory=dict)
    model_flops: float = 0.0
    bytes_per_device: float = 0.0
    flops_source: str = "flop_counter"
    notes: str = ""

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # coll_bytes is over the mesh (per rank x chips); each card
        # drives its own links
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_frac(self) -> float:
        if self.flops <= 0:
            return float("nan")
        return self.model_flops / self.flops

    @property
    def roofline_frac(self) -> float:
        """MODEL_FLOPS-at-peak time over the dominant term's time."""
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        if t_dom <= 0:
            return float("nan")
        return self.model_flops / (self.chips * PEAK_FLOPS_BF16) / t_dom

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "coll_detail": self.coll_detail,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "flops_source": self.flops_source, "notes": self.notes,
        }


# ---------------------------------------------------------------------------
# JAX's analytic terms


def _dt_bytes(cfg) -> int:
    return 2 if cfg.compute_dtype == torch.bfloat16 else 4


def analytic_residency_bytes(cfg, shape, n_params: int, chips: int,
                             param_bytes: int, opt_bytes: int = 0,
                             cache_bytes: int = 0,
                             microbatches: int = 1,
                             act_shards: int = 1,
                             accum_bytes_per_param: int = 4) -> dict:
    """JAX's per-device HBM residency budget (bytes), by component:
    params + opt (sharded over all chips), the grad accumulator (train),
    remat-saved layer carries for one microbatch (over ``act_shards``),
    the KV/SSM cache (serve), a working set of ~4 layer activations."""
    dt = _dt_bytes(cfg)
    L = cfg.n_layers + getattr(cfg, "n_encoder_layers", 0)
    D = cfg.d_model
    out = {"params": param_bytes / chips, "opt": opt_bytes / chips,
           "cache": cache_bytes / chips}
    if shape.kind == "train":
        out["grads"] = n_params * accum_bytes_per_param / chips
        tokens_mb = shape.global_batch * shape.seq_len / max(
            microbatches, 1)
        out["saved_activations"] = L * tokens_mb * D * dt / act_shards
        out["working"] = 4 * tokens_mb * D * 4 / act_shards
    else:
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        out["working"] = 6 * tokens * D * dt / max(act_shards, 1)
    out["total"] = float(sum(out.values()))
    return out


def analytic_memory_bytes(cfg, shape, n_params: int, chips: int,
                          microbatches: int = 1,
                          param_bytes: int | None = None,
                          cache_bytes: int | None = None) -> float:
    """JAX's global HBM traffic per step (bytes), from its inventory:

    train (per microbatch, x mb): weights 3 reads (fwd + remat + bwd)
    3*P*dt, grads write + read 8*P, remat save write + read 2*L*T*D*dt,
    ~6 activation passes per layer 6*L*T*D*dt; once the optimizer's
    read + write 16*P. prefill: weights once + cache once + 4 passes per
    layer. decode: weights once + the whole cache + 6 passes per layer
    of one token. T = tokens per microbatch (global), dt = the compute
    dtype's bytes."""
    dt = _dt_bytes(cfg)
    pb = param_bytes if param_bytes is not None else n_params * dt
    L = cfg.n_layers + getattr(cfg, "n_encoder_layers", 0)
    D = cfg.d_model
    mb = max(microbatches, 1)
    tokens = shape.global_batch * shape.seq_len
    t_mb = tokens / mb
    if shape.kind == "train":
        per_mb = 3 * pb + 8 * n_params + (2 + 6) * L * t_mb * D * dt
        once = 16 * n_params
        return mb * per_mb + once
    if shape.kind == "prefill":
        cb = cache_bytes or 0.0
        return pb + cb + 4 * L * tokens * D * dt
    cb = cache_bytes or 0.0
    t_dec = shape.global_batch
    return pb + cb + 6 * L * t_dec * D * dt


def model_flops(cfg, shape, n_params_active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference forward), D the
    processed tokens; MoE counts its active parameters."""
    if shape.kind == "train":
        per_tok = 6.0 * n_params_active
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        per_tok = 2.0 * n_params_active
        tokens = shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        per_tok = 2.0 * n_params_active
        tokens = shape.global_batch * 1
    return per_tok * tokens


def active_param_count(cfg, params_shapes) -> int:
    """Parameters touched per token (MoE: top_k of the routed experts)."""
    total = 0
    for name, leaf in params_shapes.items():
        n = math.prod(leaf.shape)
        if name.startswith("layers/we_"):   # routed experts
            n = int(n / leaf.shape[1] * cfg.top_k)
        total += n
    return total


# ---------------------------------------------------------------------------
# the step's FLOPs


def _meta(shapes: dict, grad: bool = False) -> dict:
    return {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta",
                           requires_grad=grad) for k, v in shapes.items()}


def count_flops(fn, *args, **kw) -> int:
    """The FLOPs of ``fn(*args, **kw)`` under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return int(fc.get_total_flops())


def step_flops(bundle, shape) -> int:
    """The FLOPs of the cell's unsharded step (``bundle``'s config at
    ``shape``), run on the ``meta`` device: the forward of the prompt
    for prefill, one decode step against a ``seq_len`` cache for decode,
    and for train the loss's forward and backward, the remat's second
    forward included (``cfg.remat == "full"``). The MoE family runs its
    dense reference path there (every padded expert on every token)."""
    b = shape.global_batch
    if shape.kind == "decode":
        params = _meta(bundle.param_shapes())
        token = torch.zeros((b, 1), dtype=torch.int32, device="meta")
        with torch.no_grad():
            return count_flops(bundle.decode_step, params,
                               bundle.cache_shapes(b, shape.seq_len), token)
    batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device="meta")
             for k, v in bundle.input_specs(shape).items()}
    if shape.kind == "prefill":
        params = _meta(bundle.param_shapes())
        with torch.no_grad():
            return count_flops(bundle.prefill, params, batch,
                               max_len=shape.seq_len)
    params = _meta(bundle.param_shapes(), grad=True)

    def train():
        with torch.enable_grad():
            loss, _ = bundle.loss(params, batch)
            torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return count_flops(train)


# ---------------------------------------------------------------------------
# per-rank residency and collectives from the specs


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _block_shape(spec, shape, mesh) -> tuple:
    from repro_torch.models import placement
    if mesh is None:
        return tuple(shape)
    return tuple(s.stop - s.start for s in placement.block(spec, shape, mesh))


def rows_per_rank(mesh, axes, b: int) -> tuple:
    """(rows, the axes they split over): a rank's rows of ``b`` split
    greedily over ``axes``."""
    from repro_torch.models import placement
    if mesh is None:
        return b, ()
    bat = placement.greedy_axes(mesh, axes, b)
    return b // mesh.size(bat), bat


def _gather_steps(spec, shape, mesh, keep=()) -> list:
    """(output elements, input elements) of each all-gather
    ``placement.gather_spec`` makes of a block of ``shape`` under
    ``spec``, dimension by dimension."""
    from repro_torch.models import placement
    cur = list(_block_shape(spec, shape, mesh))
    out = []
    for d, e in enumerate(placement.entries(spec, len(shape))):
        n = mesh.size(e)
        if d in keep or n == 1:
            continue
        before = math.prod(cur)
        cur[d] *= n
        out.append((math.prod(cur), before))
    return out


def _layer_keep(bundle, specs) -> dict:
    """The expert dimension of a layer slice that the expert-parallel FFN
    keeps split (as ``transformer.place`` keeps it)."""
    from repro_torch.models import placement
    if bundle.cfg.family != "moe":
        return {}
    from repro_torch.models.moe import EXPERT_LEAVES
    return {f"layers/{k}": (0,) for k in EXPERT_LEAVES
            if placement.axes_of(placement.entries(
                specs[f"layers/{k}"], 2)[1]) == ("model",)}


def _add(acc: dict, kind: str, nbytes: float, count: int = 1):
    b, c = acc.get(kind, (0.0, 0))
    acc[kind] = (b + nbytes, c + count)


def mesh_collectives(bundle, shape, mesh, rules, dep) -> dict:
    """One rank's collective traffic in one step of the cell, from the
    specs: ``{kind: (bytes, count)}``, bytes as the output of each
    operation (an all-gather's whole tensor, a reduce-scatter's block, an
    all-reduce's buffer, an all-to-all's buffer), as JAX's HLO count
    reads them. Counted: each layer's gathers of its leaves (in the
    compute dtype, cast before the gather) per microbatch and, in
    training, the remat's second gather and the gathers' reduce-scatter
    transposes; the whole-tensor gathers of the embedding, head, norms
    and the hybrid's shared block; the gradient all-reduces over the
    axes a leaf's spec does not name, per microbatch; ``flash_decode``'s
    merge (max, sum, output: f32) per attention layer per decode step;
    the SSM decode's gather of y over the heads and the enc-dec's of the
    cross attention's output over the kv heads; expert parallelism's
    dispatch and combine ``all_to_all``s. Scalar reductions (the loss,
    the write position, the grad norm) are not counted."""
    from repro_torch.launch.steps import batch_axes_for, cache_specs
    from repro_torch.models import placement
    from repro_torch.models.hybrid import n_shared_invocations
    cfg = bundle.cfg
    out: dict = {}
    if mesh is None or mesh.n == 1:
        return out
    specs = bundle.param_specs(rules)
    keep = _layer_keep(bundle, specs)
    dt = cfg.compute_dtype
    train = shape.kind == "train"
    mb = dep.microbatches if train else 1
    calls = 2 if train and cfg.remat == "full" else 1
    n_inv = n_shared_invocations(cfg) if cfg.family == "hybrid" else 0
    for k, shp in bundle.param_shapes().items():
        shp = tuple(shp.shape)
        if k.startswith(("layers/", "enc/")):      # gathered in each layer
            steps = _gather_steps(tuple(specs[k])[1:], shp[1:], mesh,
                                  keep.get(k, ()))
            fwd, again = shp[0], calls
        elif k.startswith("shared/"):  # per invocation; once per decode
            steps = _gather_steps(specs[k], shp, mesh)
            fwd, again = (1 if shape.kind == "decode" else n_inv), calls
        else:                          # whole, once per call
            steps = _gather_steps(specs[k], shp, mesh)
            fwd, again = (2 if k == "embed" and cfg.tie_embeddings
                          else 1), 1
        for full_n, in_n in steps:
            _add(out, "all-gather", mb * fwd * again * _nbytes((full_n,), dt),
                 mb * fwd * again)
            if train:   # the transpose: a reduce-scatter of the cotangent
                _add(out, "reduce-scatter", mb * fwd * _nbytes((in_n,), dt),
                     mb * fwd)
        if train:
            named = {a for e in tuple(specs[k]) for a in placement.axes_of(e)}
            rest = tuple(a for a in mesh.auto_axes if a not in named)
            if mesh.size(rest) > 1:
                blk = _block_shape(specs[k], shp, mesh)
                _add(out, "all-reduce", mb * _nbytes(blk, torch.float32), mb)
    b = shape.global_batch
    if shape.kind == "decode":
        cshapes = bundle.cache_shapes(b, shape.seq_len)
        cspecs = cache_specs(cfg, cshapes, mesh, b)
        b_l = b // mesh.size(batch_axes_for(mesh, b))
        if "k" in cshapes and mesh.size("model") > 1:
            n_attn = n_inv if cfg.family == "hybrid" else cfg.n_layers
            merge = b_l * cfg.n_heads * (2 + cfg.d_head) * 4
            _add(out, "all-reduce", n_attn * merge, 3 * n_attn)
        if "ssm" in cshapes and placement.axes_of(cspecs["ssm"][2]):
            _add(out, "all-gather", cfg.n_layers * _nbytes(
                (b_l, cfg.d_inner), dt), cfg.n_layers)
        if "ck" in cshapes and placement.axes_of(cspecs["ck"][3]):
            _add(out, "all-gather", cfg.n_layers * _nbytes(
                (b_l, cfg.n_heads * cfg.d_head), dt), cfg.n_layers)
    if cfg.family == "moe" and mesh.size("model") > 1:
        _add_ep(out, cfg, shape, mesh, rules, dep, calls)
    return out


def _add_ep(out: dict, cfg, shape, mesh, rules, dep, calls: int):
    """Expert parallelism's buffers per MoE layer (``moe.moe_ffn_ep``):
    the dispatch (tokens in the compute dtype and their (token, expert)
    ids) and the combine, each an ``all_to_all`` of (n_ep, cap, .); in
    training the transposes of the token buffers too."""
    from repro_torch.launch.steps import batch_axes_for
    n_ep = mesh.size("model")
    train = shape.kind == "train"
    mb = dep.microbatches if train else 1
    b = shape.global_batch // mb
    if train:
        rows, bat = rows_per_rank(mesh, rules.batch_axes, b)
    else:
        bat = batch_axes_for(mesh, b)
        rows = b // mesh.size(bat)
    if "model" in bat:      # rows split over model come together first
        rows *= n_ep
    s = 1 if shape.kind == "decode" else shape.seq_len
    if s % n_ep == 0 and s >= n_ep:
        s //= n_ep
    cap = int((rows * s * cfg.top_k / n_ep) * cfg.capacity_factor) + 1
    tok = _nbytes((n_ep, cap, cfg.d_model), cfg.compute_dtype)
    ids = _nbytes((n_ep, cap, 2), torch.int64)
    per = calls * (2 * tok + ids) + (2 * tok if train else 0)
    n = calls * 3 + (2 if train else 0)
    _add(out, "all-to-all", mb * cfg.n_layers * per, mb * cfg.n_layers * n)


def rank_residency(bundle, shape, mesh, rules, dep,
                   opt_name: str = "adamw") -> dict:
    """One rank's device memory in the cell (bytes), by component, from
    the specs through ``placement.block``: its blocks of the parameters,
    the optimizer's moments and the gradient accumulator (train), the
    cache (serve); and, under the port's realization, what it computes
    with: one layer's leaves gathered whole in the compute dtype with
    the whole embedding and head (``gathered``), the activations of its
    rows (train: the remat-saved layer inputs of one microbatch, its
    logits with their f32 copy and gradient, a working set of four f32
    layer activations; serve: six layer activations and the last
    position's f32 logits)."""
    from repro_torch.launch.steps import batch_axes_for, cache_specs
    from repro_torch.training import optimizer as opt_lib
    cfg = bundle.cfg
    shapes = bundle.param_shapes()
    specs = bundle.param_specs(rules) if mesh is not None else {}

    def held(tree: dict, tree_specs: dict, dtype=None) -> float:
        return float(sum(_nbytes(_block_shape(tree_specs.get(k),
                                              tuple(v.shape), mesh),
                                 dtype or v.dtype)
                         for k, v in tree.items()))

    dt = cfg.compute_dtype
    one = _nbytes((1,), dt)
    out = {"params": held(shapes, specs)}
    layer = {}
    for k, v in shapes.items():
        if k.startswith(("layers/", "enc/")):
            pre = k.split("/")[0]
            layer[pre] = layer.get(pre, 0) + _nbytes(tuple(v.shape)[1:], dt)
    out["gathered"] = float(max(layer.values(), default=0) + sum(
        _nbytes(tuple(v.shape), dt) for k, v in shapes.items()
        if k in ("embed", "lm_head")))
    D, V = cfg.d_model, cfg.vocab
    L = cfg.n_layers + getattr(cfg, "n_encoder_layers", 0)
    b = shape.global_batch
    if shape.kind == "train":
        ocfg = opt_lib.OptConfig(name=opt_name)
        moments = opt_lib.init_opt_state(ocfg, _meta(shapes))
        ospecs = (opt_lib.match_opt_specs(ocfg, shapes, specs)
                  if mesh is not None else {})
        out["opt"] = sum(held(tree, ospecs.get(part, {}))
                         for part, tree in moments.items() if part != "step")
        acc = torch.bfloat16 if dep.accum_dtype == "bf16" else torch.float32
        out["grads"] = held(shapes, specs, acc)
        rows, _ = rows_per_rank(mesh, rules.batch_axes if rules else (),
                                b // max(dep.microbatches, 1))
        t = rows * shape.seq_len
        out["saved_activations"] = float(L * t * D * one)
        out["logits"] = float(t * V * (one + 8))
        out["working"] = float(4 * t * D * 4)
    else:
        rows = b // (mesh.size(batch_axes_for(mesh, b)) if mesh else 1)
        cshapes = bundle.cache_shapes(b, shape.seq_len)
        cspecs = (cache_specs(cfg, cshapes, mesh, b) if mesh is not None
                  else {})
        out["cache"] = held(cshapes, cspecs)
        t = rows * (1 if shape.kind == "decode" else shape.seq_len)
        out["working"] = float(6 * t * D * one)
        out["logits"] = float(rows * V * 4)
    out["total"] = float(sum(out.values()))
    return out
