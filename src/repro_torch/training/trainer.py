"""The train step of the port (``repro.training.trainer``'s counterpart):
microbatch gradient accumulation, the global-norm clip and the AdamW /
Adafactor update, on one device or on a mesh.

  train_step(params, opt_state, batch) -> (params, opt_state,
                                           {"loss", "gnorm"})
  pod-manual: train_step(params, opt_state, batch, ef, health) ->
                                           (params, opt_state, ef, metrics)

Gradients come from ``torch.autograd.grad`` over the parameter dict's
leaves; the microbatches run as a Python loop where JAX scans them, in
JAX's order (each microbatch's gradient divided by ``n_micro`` and cast
to the accumulator's dtype before it is added; the loss the mean of the
microbatch losses). With ``TrainConfig.donate`` (the default, as in JAX)
the step writes the new parameters and optimizer state into the tensors
it was given; without it, those stay as they were.

On a mesh (an ``LMMesh``; see ``repro_torch.models.placement``) every
rank runs the step on its blocks of the parameters and moments, given
the whole batch: each microbatch is the global batch's JAX microbatch,
of which the model computes the rank's rows, and its gradient is summed
into each rank's block before it is accumulated (so a bf16 accumulator
rounds JAX's sums). The pod-manual variant (``compress_pods`` or
``straggler_masking``) is JAX's ``shard_map`` over ``pod``: each pod
takes its rows of the batch and its own gradient over the other axes,
weighs it by its health ``w`` (``health[pod]`` under straggler masking,
else 1), and the pods' gradients are summed (the int8 error-feedback
``compressed_psum`` or a plain sum) and renormalized by the sum of the
weights; the loss is the pods' mean.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from repro_torch.models import placement
from repro_torch.models.registry import ModelBundle
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.compression import compressed_psum, init_ef_state
from repro_torch.training.optimizer import OptConfig

_ACCUM = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    compress_pods: bool = False     # int8 EF compression on the pod axis
    straggler_masking: bool = False  # drop unhealthy pods from the psum
    donate: bool = True
    # gradient accumulator dtype: f32 is exact; bf16 halves the gradient
    # buffer at ~1e-3 relative accumulation error over 16 microbatches
    accum_dtype: str = "f32"


def grad_fn(bundle: ModelBundle, mesh=None):
    """``params, batch -> ((loss, metrics), grads)``, the counterpart of
    ``jax.value_and_grad(loss, has_aux=True)``: gradients with respect
    to every parameter, in each parameter's dtype. On a mesh (collective)
    the parameters are a ``placement.Sharded`` tree and the gradients
    this rank's blocks of the exact ones."""
    placement.check_mesh(mesh)

    def fn(params: dict, batch: dict):
        names = sorted(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        if mesh is not None:
            leaves = params.with_values(leaves)
        with torch.enable_grad():
            loss, metrics = bundle.loss(leaves, batch, mesh=mesh)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if mesh is not None:
            grads = placement.reduce_grads(grads, params.specs, mesh)
        return ((loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                                 for k, v in metrics.items()}), grads)

    return fn


def _accumulate(grad_fn, params, batch, n_micro: int,
                accum_dtype=torch.float32):
    """(loss, metrics, grads): the gradient over ``n_micro`` microbatches
    of the batch's leading axis."""
    if n_micro == 1:
        (loss, metrics), grads = grad_fn(params, batch)
        return loss, metrics, {k: g.float() for k, g in grads.items()}

    def split(x):
        b = x.shape[0]
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    micro = {k: split(v) for k, v in batch.items()}
    dev = next(iter(params.values())).device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    g_acc = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
             for k, p in params.items()}
    for i in range(n_micro):
        (loss, _), grads = grad_fn(params, {k: v[i] for k, v in micro.items()})
        g_acc = {k: a + (grads[k] / n_micro).to(accum_dtype)
                 for k, a in g_acc.items()}
        loss_acc = loss_acc + loss / n_micro
    return loss_acc, {"ce": loss_acc}, g_acc


def make_train_step(bundle: ModelBundle, mesh=None, rules=None,
                    tcfg: TrainConfig = TrainConfig(), act_ctx=None):
    """The train step, on one device (``mesh=None``) or on ``mesh`` with
    the parameters held by ``bundle.param_specs(rules)``. ``act_ctx``: a
    zero-argument context-manager factory entered around the gradient
    (``launch/steps.py`` installs the activation layout with it)."""
    placement.check_mesh(mesh)
    accum_dtype = _ACCUM[tcfg.accum_dtype]
    pod_manual = tcfg.compress_pods or tcfg.straggler_masking
    if mesh is None:
        if pod_manual:
            raise ValueError("the pod-manual train step (compress_pods, "
                             "straggler_masking) needs a mesh with a 'pod' "
                             "axis")
        specs = None
    else:
        specs = bundle.param_specs(rules)
    enter = act_ctx or contextlib.nullcontext

    def opt_apply(params, opt_state, grads):
        grads, gnorm = opt_lib.clip_by_global_norm(
            grads, tcfg.opt.grad_clip, specs=specs, mesh=mesh)
        new, opt_state = opt_lib.apply_update(
            tcfg.opt, params, grads, opt_state, inplace=tcfg.donate,
            specs=specs, mesh=mesh)
        if mesh is not None:
            new = params.with_values(new)
        return new, opt_state, gnorm

    if not pod_manual:
        gfn = grad_fn(bundle, mesh)

        def train_step(params: dict, opt_state: dict, batch: dict):
            with enter():
                loss, _, grads = _accumulate(gfn, params, batch,
                                             tcfg.microbatches, accum_dtype)
            params, opt_state, gnorm = opt_apply(params, opt_state, grads)
            return params, opt_state, {"loss": loss, "gnorm": gnorm}

        return train_step

    # ---- pod-manual variant: compression / straggler masking ----
    if "pod" not in mesh.axis_names:
        raise ValueError("the pod-manual train step needs a mesh with a "
                         "'pod' axis")
    pod_mesh = mesh.manual_over("pod")
    gfn = grad_fn(bundle, pod_mesh)
    n_pods, pod = mesh.size("pod"), mesh.index("pod")
    pod_group = mesh.group("pod")

    def train_step(params, opt_state, batch, ef, health):
        rows = {k: v.narrow(0, pod * (v.shape[0] // n_pods),
                            v.shape[0] // n_pods) for k, v in batch.items()}
        with enter():
            loss, _, grads = _accumulate(gfn, params, rows,
                                         tcfg.microbatches, accum_dtype)
        w = (health[pod].float() if tcfg.straggler_masking
             else torch.ones((), dtype=torch.float32, device=loss.device))
        wsum = placement.reduce(w, mesh, "pod")
        grads = {k: g.float() * w for k, g in grads.items()}
        if tcfg.compress_pods:
            grads, ef = compressed_psum(
                grads, ef, pod_group, n_pods,
                scale_group=mesh.group(mesh.axis_names))
            # compressed_psum divides by n_pods; renormalize by the
            # healthy-pod weight sum (in place: the means are new tensors)
            norm = n_pods / torch.clamp(wsum, min=1.0)
            for g in grads.values():
                g.mul_(norm)
        else:
            grads = {k: placement.reduce(g, mesh, "pod")
                     / torch.clamp(wsum, min=1.0) for k, g in grads.items()}
        loss = placement.reduce(loss, mesh, "pod") / n_pods
        params, opt_state, gnorm = opt_apply(params, opt_state, grads)
        return params, opt_state, ef, {"loss": loss, "gnorm": gnorm}

    return train_step


def init_train_state(bundle: ModelBundle, mesh=None, rules=None,
                     tcfg: TrainConfig = TrainConfig(), rng=None,
                     abstract: bool = False, device="cuda"):
    """(params, opt_state, ef): ``ef`` is None unless ``compress_pods``.
    ``abstract=True`` gives ``meta`` tensors; else the parameters are
    drawn from ``rng`` (a seed or a ``torch.Generator``, default 0) on
    ``device``. On a mesh every rank draws the whole model and keeps its
    blocks under ``bundle.param_specs(rules)`` (a ``placement.Sharded``
    tree); the moments and ``ef`` are blocks alike."""
    placement.check_mesh(mesh)
    params = (bundle.param_shapes() if abstract
              else bundle.init(0 if rng is None else rng, device=device))
    if mesh is not None:
        params = placement.shard_params(params, bundle.param_specs(rules),
                                        mesh)
    opt_state = opt_lib.init_opt_state(tcfg.opt, params)
    ef = init_ef_state(params) if tcfg.compress_pods else None
    return params, opt_state, ef
