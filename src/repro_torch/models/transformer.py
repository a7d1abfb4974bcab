"""Decoder-only transformer LM of the port: the dense GQA family, the MoE
FFN and the VLM image prefix (``repro.models.transformer``'s
counterpart).

Parameters are layer-stacked (a leading L axis, ``layers/*``), as in the
JAX package; a Python loop over L takes the place of ``lax.scan``. Under
``cfg.remat == "full"`` the full-sequence forward wraps each layer in
``torch.utils.checkpoint`` (as JAX wraps its scan body in
``jax.checkpoint``), but only while gradients are being taken: a call
under ``torch.no_grad`` or on parameters that need no gradient (serving)
runs the layers as they are. Every call casts the parameters it reads to
``cfg.compute_dtype``, as JAX does inside each jitted call; gradients
reach an f32 master through that cast. On a tree already in that dtype
the cast is free (``ServeEngine`` holds such a copy). The embedding rows
are gathered before the cast, which gives the cast table's rows bitwise
without casting the whole table.

``decode_step`` writes the new keys and values into the cache it is
given, in place, and returns a cache dict holding the same ``k``/``v``
tensors and a new ``length``: a caller that needs the old cache passes a
clone. Like JAX, it writes every row at position ``length[0]`` (the
serving engine's lockstep invariant), from a device index, while rope
uses each row's own ``length``.

The FFN is pluggable: the MoE family (``repro_torch.models.moe``) runs
its dense reference path here, or its expert-parallel path on a mesh,
and returns its router's load-balance loss, which ``loss_fn`` adds.

**On a mesh** (an ``LMMesh``; the realization is
``repro_torch.models.placement``'s) the parameters are this rank's
shards (``placement.Sharded``) and each layer gathers its leaves by
their specs inside the layer (so remat gathers again rather than keeping
the whole weights). The inputs are global, as JAX's arrays are: every
rank passes the whole batch (or the whole ``(B, 1)`` token column) and
computes on its rows of it, so the outputs (logits; the cache) are its
rows. ``forward`` and ``loss_fn`` split the rows over the installed
activation layout's batch axes (``act_sharding.batch_axes``); ``prefill``
and ``decode_step`` over the cache's, ``launch.steps.batch_axes_for``.
``loss_fn`` returns the global loss on every rank, whose gradient on a
rank is that rank's share. The cache is held as ``launch.steps.
cache_specs`` says: k and v sequence-sharded over ``model`` (their seq
length must be divisible by it, as JAX's ``shard_map`` requires) and
decoded with ``attention.flash_decode``; the step's token is written by
the rank whose seq shard holds the clamped global index ``length[0]``,
the other ranks writing nothing.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.models import act_sharding
from repro_torch.models import attention as attn
from repro_torch.models import placement
from repro_torch.models.act_sharding import constrain
from repro_torch.models.common import (ModelConfig, ParamSet, apply_rope,
                                       cast_params, cross_entropy_loss,
                                       rms_norm, rope_tables, silu)


# ---------------------------------------------------------------------------
# parameter tables
# ---------------------------------------------------------------------------

def dense_param_set(cfg: ModelConfig) -> ParamSet:
    ps = ParamSet(cfg)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    H, KV, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    ps.add("embed", (V, D), ("vocab_in", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        ps.add("lm_head", (D, V), ("embed", "vocab"))
    ps.add("final_norm", (D,), ("none",), init="ones")
    ps.add("layers/ln1", (L, D), ("layer", "none"), init="ones")
    ps.add("layers/ln2", (L, D), ("layer", "none"), init="ones")
    ps.add("layers/wq", (L, D, H * Dh), ("layer", "embed", "heads"))
    ps.add("layers/wk", (L, D, KV * Dh), ("layer", "embed", "kv"))
    ps.add("layers/wv", (L, D, KV * Dh), ("layer", "embed", "kv"))
    ps.add("layers/wo", (L, H * Dh, D), ("layer", "heads", "embed"))
    if cfg.qkv_bias:
        ps.add("layers/bq", (L, H * Dh), ("layer", "heads"), init="zeros")
        ps.add("layers/bk", (L, KV * Dh), ("layer", "kv"), init="zeros")
        ps.add("layers/bv", (L, KV * Dh), ("layer", "kv"), init="zeros")
    _ffn_params(ps, cfg)
    return ps


def _ffn_params(ps: ParamSet, cfg: ModelConfig):
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    if cfg.family in ("dense", "vlm", "encdec"):
        ps.add("layers/w_gate", (L, D, F), ("layer", "embed", "mlp"))
        ps.add("layers/w_up", (L, D, F), ("layer", "embed", "mlp"))
        ps.add("layers/w_down", (L, F, D), ("layer", "mlp", "embed"))
    elif cfg.family == "moe":
        from repro_torch.models.moe import moe_param_defs
        moe_param_defs(ps, cfg)
    else:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _layers(params: dict, dtype, prefix: str = "layers"):
    """Each layer's parameters of the stack ``prefix``, in ``dtype``, in
    layer order."""
    pre = prefix + "/"
    stacked = cast_params({k[len(pre):]: v for k, v in params.items()
                           if k.startswith(pre)}, dtype)
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        yield {k: v[i] for k, v in stacked.items()}


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, pl=None):
    if pl is not None:
        return pl.full("embed", cfg.compute_dtype)[tokens.long()]
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def _head(params: dict, cfg: ModelConfig, pl=None) -> torch.Tensor:
    if pl is not None:
        return (pl.full("embed", cfg.compute_dtype).T if cfg.tie_embeddings
                else pl.full("lm_head", cfg.compute_dtype))
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.compute_dtype)


def _norm(params: dict, name: str, pl=None) -> torch.Tensor:
    return params[name] if pl is None else pl.full(name, params[name].dtype)


def qkv(lp: dict, cfg: ModelConfig, x: torch.Tensor):
    b, s, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = x @ lp["wq"].to(x.dtype)
    k = x @ lp["wk"].to(x.dtype)
    v = x @ lp["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(x.dtype)
        k = k + lp["bk"].to(x.dtype)
        v = v + lp["bv"].to(x.dtype)
    return (q.reshape(b, s, H, Dh), k.reshape(b, s, KV, Dh),
            v.reshape(b, s, KV, Dh))


def qkv_rope(lp: dict, cfg: ModelConfig, x: torch.Tensor, cs):
    """``qkv`` with rope from the tables ``cs`` on q and k."""
    q, k, v = qkv(lp, cfg, x)
    return apply_rope(q, *cs), apply_rope(k, *cs), v


def mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    gate = silu(x @ lp["w_gate"].to(x.dtype))
    up = x @ lp["w_up"].to(x.dtype)
    return (gate * up) @ lp["w_down"].to(x.dtype)


def make_ffn(cfg: ModelConfig, mesh=None, bat: tuple = ()):
    """The layer's FFN: ``ffn(lp, x) -> (y, aux)``; on a mesh the MoE's
    expert-parallel path over rows split over ``bat``."""
    if cfg.family == "moe":
        from repro_torch.models.moe import moe_ffn
        return functools.partial(moe_ffn, cfg=cfg, mesh=mesh, bat=bat)

    def ffn(lp, x):  # the dense FFN has no auxiliary loss
        return mlp(lp, x), 0.0

    return ffn


def decoder_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor, positions,
                  ffn, pl=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm GQA block over the full sequence. ``positions``: (S,), or
    the (cos, sin) pair ``rope_tables`` makes of them; ``pl``: the call's
    ``placement.Place`` on a mesh (``lp`` then holds local slices,
    gathered here). Returns (x, aux_loss)."""
    if pl is not None:
        lp = pl.layer(lp)
    rope_cs = positions if isinstance(positions, tuple) else rope_tables(
        positions, cfg.d_head, cfg.rope_theta)
    h = constrain(rms_norm(x, lp["ln1"], cfg.norm_eps), "matmul_in")
    q, k, v = qkv_rope(lp, cfg, h, rope_cs)
    o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk, causal=True)
    b, s = x.shape[:2]
    x = x + o.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
    h = constrain(rms_norm(x, lp["ln2"], cfg.norm_eps), "matmul_in")
    y, aux = ffn(lp, h)
    return constrain(x + y), aux


def place(params: dict, cfg: ModelConfig, mesh, bat: tuple = ()):
    """The call's ``placement.Place`` on a mesh (None without one): the
    expert matrices keep their expert dimension split over ``model``
    where their specs split it so."""
    if placement.check_mesh(mesh) is None:
        return None
    keep = {}
    if cfg.family == "moe" and isinstance(params, placement.Sharded):
        from repro_torch.models.moe import EXPERT_LEAVES
        keep = {k: (0,) for k in EXPERT_LEAVES if placement.axes_of(
            params.spec(f"layers/{k}")[1]) == ("model",)}
    return placement.Place(mesh, params, bat, keep)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def remat(layer, cfg: ModelConfig, params: dict):
    """``layer`` under ``torch.utils.checkpoint`` when ``cfg.remat`` is
    ``"full"`` and gradients of ``params`` are being taken; else
    ``layer`` itself."""
    if cfg.remat == "full" and torch.is_grad_enabled() and any(
            v.requires_grad for v in params.values()):
        return functools.partial(checkpoint, layer, use_reentrant=False)
    return layer


def _prefix(params, cfg, tokens, img_embeds, pl=None):
    x = _embed(params, cfg, tokens, pl)
    if img_embeds is not None:  # VLM: precomputed patch embeddings prefix
        x = torch.cat([img_embeds.to(cfg.compute_dtype), x], dim=1)
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds: torch.Tensor | None = None, mesh=None) -> tuple:
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss); on a
    mesh the logits are this rank's rows."""
    pl = _rows_place(params, cfg, mesh, tokens.shape[0])
    if pl is not None:
        tokens, img_embeds = pl.rows(tokens), pl.rows(img_embeds)
    ffn = make_ffn(cfg, mesh, pl.bat if pl else ())
    x = _prefix(params, cfg, tokens, img_embeds, pl)
    s = x.shape[1]
    cs = rope_tables(torch.arange(s, device=x.device), cfg.d_head,
                     cfg.rope_theta)
    layer = remat(decoder_layer, cfg, params)
    aux = 0.0
    for lp in _layers(params, cfg.compute_dtype):
        x, a = layer(lp, cfg, x, cs, ffn, pl)
        aux = aux + a
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    return x @ _head(params, cfg, pl), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


def _rows_place(params, cfg, mesh, b: int):
    """The full-sequence forward's ``Place``: rows split over the
    activation layout's batch axes."""
    if placement.check_mesh(mesh) is None:
        return None
    return place(params, cfg, mesh, placement.greedy_axes(
        mesh, act_sharding.batch_axes(mesh), b))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, mesh=None):
    """batch: tokens (B,S) i32, labels (B,S) i32 (-1 = masked),
    optional img_embeds (B,Timg,D)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("img_embeds"), mesh=mesh)
    labels = batch["labels"]
    if batch.get("img_embeds") is not None:
        t_img = batch["img_embeds"].shape[1]
        logits = logits[:, t_img:]
    if placement.check_mesh(mesh) is not None:
        pl = _rows_place(params, cfg, mesh, labels.shape[0])
        return mesh_loss(logits, pl.rows(labels), aux, cfg, pl)
    ce = cross_entropy_loss(logits, labels.clamp_min(0), labels >= 0)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


def mesh_loss(logits, labels, aux, cfg: ModelConfig, pl):
    """The loss of this rank's rows as its share of the global loss, and
    the global loss (the shares' sum over the mesh): the token mean of
    JAX's ``cross_entropy_loss`` over the global batch (its mask count
    summed over the rows' axes; each share divided by the ranks that
    compute the same rows) plus the load-balance loss (global on every
    rank, a 1/n share each). Returns (global loss, metrics)."""
    mesh = pl.mesh
    mask = (labels >= 0).float()
    logits = logits.float()
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - lmax).sum(dim=-1)) + lmax[..., 0]
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    tok = lse - gold + 1e-4 * lse.square()
    n_tok = placement.reduce(mask.sum(), mesh, pl.bat).clamp_min(1.0)
    ce_share = (tok * mask).sum() / n_tok / pl.rep
    axes = mesh.auto_axes
    share = ce_share + cfg.router_aux_weight * aux / mesh.size(axes)
    loss = placement.total(share, mesh, axes)
    ce = placement.reduce(ce_share.detach(), mesh, axes)
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    dtype = dtype or cfg.compute_dtype
    L, KV, Dh = cfg.n_layers, cfg.n_kv, cfg.d_head
    return {
        "k": torch.zeros((L, batch, max_len, KV, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, KV, Dh), dtype=dtype,
                         device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _write(c: torch.Tensor, at: torch.Tensor, new: torch.Tensor, valid):
    """``new`` (B, 1, KV, Dh) into ``c`` (B, T, KV, Dh) at position ``at``
    (a device index), where ``valid`` (None: always) holds."""
    new = new.to(c.dtype)
    if valid is not None:
        new = torch.where(valid.view(1, 1, 1, 1), new, c.index_select(1, at))
    c.index_copy_(1, at, new)


def decode_place(params, cfg: ModelConfig, cache, mesh):
    """A mesh decode step's ``Place``: the rows of the cache's blocks
    (``cache`` must be this rank's ``placement.Sharded`` block; a K/V
    cache must be seq-sharded over ``model``, whose size must divide its
    ``max_len``). None without a mesh."""
    if placement.check_mesh(mesh) is None:
        return None
    if not isinstance(cache, placement.Sharded):
        raise TypeError("on a mesh the cache is this rank's block: "
                        "placement.shard_cache(...) or a mesh prefill")
    if "k" in cache:
        t_g = cache.shapes["k"][2]
        if "model" in mesh.axis_names and (
                t_g % mesh.size("model") or placement.axes_of(
                    cache.spec("k")[2]) != ("model",)):
            raise ValueError(
                f"flash_decode shards the cache's {t_g} positions over "
                f"the {mesh.size('model')} ranks of 'model': max_len "
                "must be divisible by the model axis")
    return place(params, cfg, mesh, placement.axes_of(
        cache.spec("length")[0]))


def write_position(cache, length: torch.Tensor, pl):
    """(at, valid, flash): where this step's key and value go in this
    rank's ``cache["k"]`` (a device index; ``valid`` None, or whether
    this rank's seq shard holds the position) and whether attention runs
    through ``flash_decode``. The position is the global row 0's
    ``length`` (the lockstep invariant), clamped as
    ``dynamic_update_slice`` clamps its start."""
    t = cache["k"].shape[2]
    if pl is None:
        return length[:1].clamp(max=t - 1).long(), None, False
    mesh = pl.mesh
    # the global row 0's length (held by the rows' first block)
    first = torch.full_like(length[:1], -1) if mesh.index(pl.bat) else \
        length[:1]
    at = placement.reduce(first, mesh, pl.bat, dist.ReduceOp.MAX
                          ).clamp(max=cache.shapes["k"][2] - 1).long()
    if "model" not in mesh.axis_names:
        return at, None, False
    # written by the rank whose seq shard holds the position
    at = at - mesh.index("model") * t
    valid = (at >= 0) & (at < t)
    return at.clamp(0, t - 1), valid, True


def attend_cache(q, kc, vc, length1, flash: bool, mesh):
    """Decode attention against one layer's (possibly seq-sharded)
    cache."""
    if flash:
        return attn.flash_decode(mesh, q, kc, vc, length1)
    return attn.decode_attention(q, kc, vc, length1)


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, mesh=None) -> tuple[dict, torch.Tensor]:
    """One decode step. token: (B, 1) i32. Returns (cache, logits (B,V)).

    Updates ``cache["k"]`` and ``cache["v"]`` in place (see the module
    docstring); the returned cache holds them and ``length + 1``. On a
    mesh the cache is this rank's ``placement.Sharded`` block and
    ``token`` the whole column; the logits are this rank's rows.
    """
    pl = decode_place(params, cfg, cache, mesh)
    if pl is not None:
        token = pl.rows(token)
    ffn = make_ffn(cfg, mesh, pl.bat if pl else ())
    x = _embed(params, cfg, token, pl)                         # (B,1,D)
    b = x.shape[0]
    length = cache["length"]                                   # (B,)
    length1 = length + 1
    at, valid, flash = write_position(cache, length, pl)
    cs = rope_tables(length[:, None], cfg.d_head, cfg.rope_theta)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        kc, vc = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_rope(lp, cfg, h, cs)
        _write(kc, at, k, valid)
        _write(vc, at, v, valid)
        o = attend_cache(q, kc, vc, length1, flash, mesh)
        x = x + o.reshape(b, 1, -1) @ lp["wo"].to(x.dtype)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, _ = ffn(lp, h)
        x = x + y
    x = rms_norm(x, _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    out = {"k": cache["k"], "v": cache["v"], "length": length1}
    return (cache.with_values(out) if pl is not None else out), logits


def prefill_place(params, cfg: ModelConfig, mesh, b: int):
    """A mesh prefill's ``Place``: rows split over the cache's batch axes
    (``launch.steps.batch_axes_for``). None without a mesh."""
    if placement.check_mesh(mesh) is None:
        return None
    from repro_torch.launch.steps import batch_axes_for
    return place(params, cfg, mesh, batch_axes_for(mesh, b))


def seq_part(cache, s: int) -> slice:
    """The positions of an ``s``-token prompt that this rank's block of
    ``cache["k"]`` holds (all of them without a mesh)."""
    if not isinstance(cache, placement.Sharded):
        return slice(0, s)
    lo = placement.block(cache.spec("k"), cache.shapes["k"],
                         cache.mesh)[2].start
    return slice(min(lo, s), min(lo + cache["k"].shape[2], s))


def local(cache, name: str, value: torch.Tensor) -> torch.Tensor:
    """This rank's block of one layer's ``value`` of leaf ``name`` (the
    rank's rows, the leaf's other dimensions whole), or ``value`` itself
    when it already has the block's shape."""
    if not isinstance(cache, placement.Sharded) or \
            tuple(value.shape[1:]) == tuple(cache[name].shape[2:]):
        return value
    blk = placement.block(cache.spec(name), cache.shapes[name], cache.mesh)
    return value[(slice(None),) + blk[2:]]


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, mesh=None,
            img_embeds: torch.Tensor | None = None
            ) -> tuple[dict, torch.Tensor]:
    """Run the full prompt, build a new cache. Returns (cache,
    last_logits); on a mesh this rank's block of the cache
    (``launch.steps.cache_specs``) and its rows of the logits."""
    b_g = tokens.shape[0]
    pl = prefill_place(params, cfg, mesh, b_g)
    if pl is not None:
        tokens, img_embeds = pl.rows(tokens), pl.rows(img_embeds)
    ffn = make_ffn(cfg, mesh, pl.bat if pl else ())
    x = _prefix(params, cfg, tokens, img_embeds, pl)
    b, s = x.shape[:2]
    max_len = max_len or s
    if s > max_len:
        raise ValueError(f"a prompt of {s} positions does not fit a cache "
                         f"of {max_len}")
    cache = new_cache(init_cache, cfg, b_g, max_len, mesh, x.device)
    seq = seq_part(cache, s)
    n = seq.stop - seq.start
    cs = rope_tables(torch.arange(s, device=x.device), cfg.d_head,
                     cfg.rope_theta)
    for i, lp in enumerate(_layers(params, cfg.compute_dtype)):
        if pl is not None:
            lp = pl.layer(lp)
        h = constrain(rms_norm(x, lp["ln1"], cfg.norm_eps), "matmul_in")
        q, k, v = qkv_rope(lp, cfg, h, cs)
        o = attn.blockwise_attention(q, k, v, chunk=cfg.attn_chunk,
                                     causal=True)
        x2 = x + o.reshape(b, s, -1) @ lp["wo"].to(x.dtype)
        h2 = constrain(rms_norm(x2, lp["ln2"], cfg.norm_eps), "matmul_in")
        y, _ = ffn(lp, h2)
        cache["k"][i, :, :n] = k[:, seq]
        cache["v"][i, :, :n] = v[:, seq]
        x = constrain(x2 + y)
    x = rms_norm(x[:, -1:], _norm(params, "final_norm", pl), cfg.norm_eps)
    logits = (x @ _head(params, cfg, pl))[:, 0]
    cache["length"].fill_(s)
    return cache, logits


def new_cache(init, cfg: ModelConfig, b: int, max_len: int, mesh, device,
              **kw):
    """A zero cache of ``b`` rows from the family's ``init_cache``
    (``init(cfg, b, max_len, device=, **kw)``): the whole cache without a
    mesh, else this rank's block of it, held as ``launch.steps.
    cache_specs`` says."""
    if placement.check_mesh(mesh) is None:
        return init(cfg, b, max_len, device=device, **kw)
    from repro_torch.launch.steps import cache_specs
    shapes = init(cfg, b, max_len, device="meta", **kw)
    specs = cache_specs(cfg, shapes, mesh, b)
    local_ = {}
    for k, v in shapes.items():
        blk = placement.block(specs[k], v.shape, mesh)
        local_[k] = torch.zeros([sl.stop - sl.start for sl in blk],
                                dtype=v.dtype, device=device)
    return placement.Sharded(local_, specs, {k: v.shape for k, v in
                                             shapes.items()}, mesh)
