"""The train step of the port on one device (``repro.training.trainer``'s
counterpart): microbatch gradient accumulation, the global-norm clip and
the AdamW / Adafactor update.

  train_step(params, opt_state, batch) -> (params, opt_state,
                                           {"loss", "gnorm"})

Gradients come from ``torch.autograd.grad`` over the parameter dict's
leaves; the microbatches run as a Python loop where JAX scans them, in
JAX's order (each microbatch's gradient divided by ``n_micro`` and cast
to the accumulator's dtype before it is added; the loss the mean of the
microbatch losses). With ``TrainConfig.donate`` (the default, as in JAX)
the step writes the new parameters and optimizer state into the tensors
it was given; without it, those stay as they were.

The pod-manual step (``compress_pods`` or ``straggler_masking``: a
psum over pods, int8 error feedback, per-pod health weights) needs a
process group and waits for the LM's meshes (ROADMAP A15f), as does any
``mesh``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.registry import ModelBundle
from repro_torch.models.transformer import no_mesh
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.compression import init_ef_state
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


def _pod_manual(tcfg: TrainConfig) -> None:
    if tcfg.compress_pods or tcfg.straggler_masking:
        raise NotImplementedError(
            "the pod-manual train step (compress_pods, straggler_masking) "
            "is not ported yet: ROADMAP A15f")


def grad_fn(bundle: ModelBundle, mesh=None):
    """``params, batch -> ((loss, metrics), grads)``, the counterpart of
    ``jax.value_and_grad(loss, has_aux=True)``: gradients with respect
    to every parameter, in each parameter's dtype."""
    no_mesh(mesh)

    def fn(params: dict, batch: dict):
        names = sorted(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss, metrics = bundle.loss(leaves, batch)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
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
    """The train step for one device. ``mesh`` must be None and
    ``rules`` and ``act_ctx`` are unused (the sharding rules and
    activation constraints wait for ROADMAP A15f)."""
    _pod_manual(tcfg)
    gfn = grad_fn(bundle, mesh)
    accum_dtype = _ACCUM[tcfg.accum_dtype]

    def train_step(params: dict, opt_state: dict, batch: dict):
        loss, _, grads = _accumulate(gfn, params, batch, tcfg.microbatches,
                                     accum_dtype)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, tcfg.opt.grad_clip)
        params, opt_state = opt_lib.apply_update(
            tcfg.opt, params, grads, opt_state, inplace=tcfg.donate)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return train_step


def init_train_state(bundle: ModelBundle, mesh=None, rules=None,
                     tcfg: TrainConfig = TrainConfig(), rng=None,
                     abstract: bool = False, device="cuda"):
    """(params, opt_state, ef): ``ef`` is None unless ``compress_pods``.
    ``abstract=True`` gives ``meta`` tensors; else the parameters are
    drawn from ``rng`` (a seed or a ``torch.Generator``, default 0) on
    ``device``."""
    no_mesh(mesh)
    params = (bundle.param_shapes() if abstract
              else bundle.init(0 if rng is None else rng, device=device))
    opt_state = opt_lib.init_opt_state(tcfg.opt, params)
    ef = init_ef_state(params) if tcfg.compress_pods else None
    return params, opt_state, ef
