"""Distributed Find Winners, steps and fleets on ``torch.distributed``.

The port's counterpart of ``repro.core.gson.distributed``. The JAX
package is single-controller: one process drives every device of a
``jax.sharding.Mesh`` through ``shard_map`` programs. The port's wall
clock is set by host dispatch, so one host thread feeding n cards would
not scale; the port is SPMD instead, like a multi-host JAX job: one
process per device, every rank running the same driver code on its own
device, and the collectives are ``torch.distributed`` calls on the group
that :meth:`repro_torch.gson.MeshSpec.build` returns (ranks
``0..ndev-1``). Every function here that reads across ranks is
collective: all ranks of the group call it, in the same order. Only
collectives that both gloo and NCCL offer are used (``all_gather`` in its
list form, ``all_gather_object``, ``broadcast_object_list``,
``barrier``); under NCCL the tensors of a collective live on the rank's
card (object collectives use the current card, so a rank makes its card
current first), under gloo on the host.

Three strategies, as in the JAX package:

* **data partitioning** (the paper's choice, Sec. 1/2.5): the m signals
  are split across ranks, the network state is replicated. Each rank
  finds winners for its own contiguous m/n rows, then the four
  per-signal results are all-gathered and the Update phase runs on every
  rank as a replicated deterministic state machine: no further
  collective, no divergence. One collective per step, of O(m) words.

* **network partitioning** (the literature's baseline the paper argues
  against): the unit pool is cut into contiguous C/n slices; every rank
  sees all signals, finds the top-2 of its slice, and the (m, 2n)
  candidates are merged in (distance, id) order, the order of the
  unsharded search (ties to the lowest id).

* **fleet sharding** (:func:`make_sharded_fleet_programs`): the leading
  ``(B,)`` network axis of a cohort is cut into contiguous slices, each
  rank stepping its ``B/n`` whole networks with the fleet core
  (``repro_torch.core.gson.fleet``) and no collective per iteration. The
  host gathers one small ``(6, B)`` array per tick (iterations,
  convergence flags, QEs, unit and signal counts, and a fault flag) and
  one ``(2, B)`` verdict per health screen. A fault that one rank raises
  on its own travels in that gather, and every rank raises it alike as
  a :class:`RankFault`.

The port's Find Winners (the B1 kernel and its plain version) computes
each (signal, unit) pair on its own, so both partitionings give the
unsharded step's answer bitwise, where the JAX data strategy is only "a
valid run" (XLA tiles the sharded distance product differently).

Not ported: ``ShardSwitchSampler`` and ``_keys_to_data`` /
``_keys_from_data``. They exist because a ``shard_map`` region sees only
its local key slice, and typed PRNG keys cannot cross its boundary. A
rank of the port simply holds the samplers and RNG seams
(``repro_torch.rng``) of its own networks.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.gson import fleet as fleet_core
from repro_torch.core.gson.multi import (find_winners_reference,
                                         multi_signal_step)
from repro_torch.core.gson.state import GSONParams, NetworkState
from repro_torch.kernels.find_winners.kernel import LARGE
from repro_torch.utils.timing import span

_BIG_ID = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# collectives


def _comm_device(group, like: torch.Tensor) -> torch.device:
    """Where a collective's tensors live: under NCCL the card of ``like``
    when it is on one, else the current card; under gloo the host."""
    if dist.get_backend(group) != "nccl":
        return torch.device("cpu")
    if like.is_cuda:
        return like.device
    return torch.device("cuda", torch.cuda.current_device())


def barrier(group) -> None:
    """Collective: wait for every rank of ``group``."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def broadcast_object(group, obj, src: int):
    """Collective: rank ``src``'s picklable ``obj`` on every rank of
    ``group``."""
    box = [obj if dist.get_rank(group) == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _rank(group) -> int:
    r = dist.get_rank(group)
    if r < 0:
        raise RuntimeError(
            f"rank {dist.get_rank()} is outside this mesh's group of "
            "ranks: it holds no networks and takes no part in its "
            "collectives")
    return r


def all_gather_cat(group, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Collective: every rank's ``x`` (one shape on all ranks),
    concatenated along ``dim`` in rank order, on ``x``'s device."""
    xs = x.to(_comm_device(group, x)).contiguous()
    out = [torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, xs, group=group)
    return torch.cat(out, dim).to(x.device)


def _to_host(tree):
    """A tree with every tensor leaf copied to the host (for pickling)."""
    if isinstance(tree, torch.Tensor):
        # a copy: pickling a view would send its whole storage
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, NetworkState):
        return tree.map(_to_host)
    return tree


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, NetworkState):
        return tree.map(lambda x: x.to(device))
    return tree


def concat_trees(trees: list):
    """Trees of one structure, joined along their leading axis: tensors
    and arrays concatenated, lists joined (one entry per network)."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.cat(trees)
    if isinstance(t0, np.ndarray):
        return np.concatenate(trees)
    if isinstance(t0, dict):
        return {k: concat_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        return [x for t in trees for x in t]
    if isinstance(t0, NetworkState):
        return NetworkState(**{
            f.name: concat_trees([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)})
    raise TypeError(f"cannot concatenate {type(t0).__name__} leaves")


# ---------------------------------------------------------------------------
# the two partitionings of one network's Find Winners


def data_parallel_find_winners(group, inner=None):
    """Find Winners with the signals split across the ranks of ``group``,
    units replicated.

    Returns a ``FindWinnersFn``: ``fw(signals, w, active) -> (wid, sid,
    d2b, d2s)``, every output gathered back whole (the Update phase needs
    the full batch). Collective, one ``all_gather`` per call. Rank r runs
    ``inner`` (default: the plain reference; the B1 kernel for a card
    backend) on its contiguous rows ``[r m/n, (r+1) m/n)``. A stateful
    ``inner`` (an ANN search with an aux) keeps its contract: the aux is
    built from the replicated units. A fault that ``inner`` raises on one
    rank alone is not shared: the step syncs with no host that could carry
    a flag, so the other ranks wait in the gather until the group's
    timeout.
    """
    local_fw = inner if inner is not None else find_winners_reference
    n = dist.get_world_size(group)

    def fw(signals, w, active, aux=None):
        m = signals.shape[-2]
        if m % n != 0:
            raise ValueError(
                f"signal batch of {m} rows is not divisible by the {n} "
                "ranks of the signal mesh; pick a max_parallel / fixed_m "
                "that the mesh divides")
        r, k = _rank(group), m // n
        mine = signals[..., r * k:(r + 1) * k, :]
        out = (local_fw(mine, w, active) if aux is None
               else local_fw(mine, w, active, aux=aux))
        wid, sid, d2b, d2s = out
        # one collective: the four (.., m/n) results as int32 words
        packed = torch.stack([wid.to(torch.int32), sid.to(torch.int32),
                              d2b.view(torch.int32), d2s.view(torch.int32)])
        full = all_gather_cat(group, packed, dim=-1)
        return full[0], full[1], full[2].view(torch.float32), \
            full[3].view(torch.float32)

    fw.stateful = getattr(local_fw, "stateful", False)
    if fw.stateful:
        fw.build = local_fw.build
    return fw


def merge_top2(ids: torch.Tensor, d2: torch.Tensor):
    """The exact top-2 of candidate lists ``(..., k)``: the two smallest
    distances, ties to the lowest id (each id at most once among the
    finite candidates; a non-candidate carries ``inf``). With fewer than
    two finite candidates the winner fills both slots, as the unsharded
    search does. Returns ``(wid, sid, d2b, d2s)``."""
    big = torch.tensor(_BIG_ID, dtype=ids.dtype, device=ids.device)

    def lowest(d):
        dmin = d.min(dim=-1).values
        return torch.where(d == dmin[..., None], ids, big).min(-1).values, \
            dmin

    i1, d1 = lowest(d2)
    i2, ds = lowest(torch.where(ids == i1[..., None], torch.inf, d2))
    alone = torch.isinf(ds)
    return (i1, torch.where(alone, i1, i2), d1, torch.where(alone, d1, ds))


def network_parallel_find_winners(group, inner=None):
    """Find Winners with the unit pool cut into contiguous ``C/n`` slices
    over the ranks of ``group``; every rank sees all signals.

    The map-reduce pattern of the prior literature: rank r runs ``inner``
    (default: the plain reference) on units ``[r C/n, (r+1) C/n)`` and
    adds the slice's base to the ids; the ranks gather the ``(m, 2n)``
    candidates (one collective) and :func:`merge_top2` orders them by
    (distance, id), which is the unsharded search's order, so the result
    equals it exactly. A slice with fewer than two active units offers
    fewer real candidates: a slot whose distance is infinite or past the
    kernel's ``LARGE / 2`` bias (an inactive unit) is no candidate, and a
    second that repeats its winner (one active unit) leaves the merge with
    its winner's id.
    """
    local_fw = inner if inner is not None else find_winners_reference
    n = dist.get_world_size(group)

    def fw(signals, w, active):
        C = w.shape[-2]
        if C % n != 0:
            raise ValueError(
                f"a pool of {C} units is not divisible by the {n} ranks "
                "of the unit partition")
        r, c = _rank(group), C // n
        wid, sid, d2b, d2s = local_fw(signals, w[..., r * c:(r + 1) * c, :],
                                      active[..., r * c:(r + 1) * c])
        none_b, none_s = d2b >= LARGE / 2, d2s >= LARGE / 2
        ids = torch.stack([wid, sid], -1).to(torch.int32) + r * c
        d2 = torch.stack([torch.where(none_b, torch.inf, d2b),
                          torch.where(none_s, torch.inf, d2s)], -1)
        packed = torch.stack([ids, d2.to(torch.float32).view(torch.int32)])
        full = all_gather_cat(group, packed, dim=-1)      # (2, .., m, 2n)
        return merge_top2(full[0], full[1].view(torch.float32))

    return fw


def make_distributed_step(group, params: GSONParams, strategy: str = "data",
                          inner=None):
    """One multi-signal step on the ranks of ``group``:
    ``step(state, signals, prio, **kw) -> state`` (``kw``: the step's
    ``update_phase``, ``signal_mask``). Collective.

    ``strategy="data"`` is the paper's scheme: signals split, state and
    Update phase replicated. ``strategy="network"`` splits the unit pool
    instead. ``inner``: the per-rank Find Winners (default: the plain
    reference).
    """
    if strategy == "data":
        fw = data_parallel_find_winners(group, inner)
    elif strategy == "network":
        fw = network_parallel_find_winners(group, inner)
    else:
        raise ValueError(f"strategy must be 'data' or 'network', got "
                         f"{strategy!r}")

    def step(state: NetworkState, signals: torch.Tensor, prio: torch.Tensor,
             **kw) -> NetworkState:
        return multi_signal_step(state, signals, params, prio,
                                 refresh_states=False, find_winners=fw,
                                 **kw)

    return step


@lru_cache(maxsize=None)
def signal_sharded_find_winners(group, inner=None):
    """Memoized :func:`data_parallel_find_winners` for the public API:
    ONE adapter per ``(group, inner backend)``, so the cohort key, which
    holds the Find Winners callable, groups equal specs together."""
    return data_parallel_find_winners(group, inner)


# ---------------------------------------------------------------------------
# fleet sharding: B whole networks over the ranks, no collective per
# iteration


class RankFault(RuntimeError):
    """A fault that one rank of a mesh raised on its own (a sampler of a
    network it holds, a kernel launch, its card's memory), raised alike on
    every rank of the group by the gather that would have carried that
    rank's counters, so that every rank takes the same decision."""


@dataclasses.dataclass(frozen=True)
class FleetShard:
    """This rank's slice of a cohort of ``batch`` networks on ``group``.

    The cohort is padded with ``pad`` placeholder networks until the
    ranks divide it, and rank r owns the contiguous networks ``[r L, (r+1)
    L)`` of the padded batch, ``L`` = ``per_rank``; the placeholders are
    the tail. Host operands come in for the ``batch`` real networks and
    :meth:`local` cuts this rank's slice out of them.
    """

    group: object
    batch: int

    @property
    def ndev(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This rank in the group, -1 outside it."""
        return dist.get_rank(self.group)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def pad(self) -> int:
        return (-self.batch) % self.ndev

    @property
    def per_rank(self) -> int:
        return (self.batch + self.pad) // self.ndev

    @property
    def lo(self) -> int:
        return _rank(self.group) * self.per_rank

    @property
    def real(self) -> int:
        """How many of this rank's networks are real (not placeholders)."""
        return max(0, min(self.per_rank, self.batch - self.lo))

    def local(self, x: np.ndarray, fill=0) -> np.ndarray:
        """This rank's slice of a ``(batch,)`` host operand; a placeholder
        gets ``fill``."""
        x = np.asarray(x)
        x = np.concatenate([x, np.full(self.pad, fill, x.dtype)])
        return x[self.lo:self.lo + self.per_rank]

    def owner(self, i: int) -> tuple[int, int]:
        """(rank, slot on it) of real network ``i``."""
        return divmod(i, self.per_rank)

    def gather(self, x: np.ndarray,
               error: BaseException | None = None) -> np.ndarray:
        """Collective: every rank's ``(k, per_rank)`` host array, joined
        along the last axis and cut to the real networks (one
        ``all_gather``, in float64). A rank that caught an ``error`` of
        its own passes it (and any ``x`` of the shape): then every rank
        raises one :class:`RankFault` naming the first such rank, whose
        text costs one broadcast on that path only."""
        x = np.asarray(x, np.float64)
        flag = np.full((1, x.shape[-1]), float(error is not None))
        t = torch.from_numpy(np.concatenate([x, flag]))
        full = all_gather_cat(self.group, t, dim=-1).numpy()
        failed = np.flatnonzero(full[-1, ::self.per_rank])
        if len(failed):
            src = int(failed[0])
            text = broadcast_object(
                self.group, repr(error) if self.rank == src else None, src)
            raise RankFault(f"rank {src} of the mesh raised {text}") \
                from error
        return full[:-1, :self.batch]

    def gather_objects(self, obj) -> list | None:
        """Collective: every rank's picklable ``obj``, in rank order, on
        rank 0 of the group, the one that writes snapshots (``None`` on the
        others). A mesh's group is the world's first ranks, so its rank 0
        is the world's."""
        out = [None] * self.ndev if self.rank == 0 else None
        dist.gather_object(_to_host(obj), out, dst=0, group=self.group)
        return out

    def broadcast(self, obj, src: int, device):
        """Collective: rank ``src``'s ``obj`` (tensors moved to ``device``)
        on every rank."""
        return _to_device(broadcast_object(self.group, _to_host(obj), src),
                          device)



def make_sharded_fleet_programs(shard: FleetShard):
    """The fleet core's step programs on this rank's slice of a cohort.

    ``iterate``, ``check`` and ``superstep`` take the signatures of
    ``fleet_core.fleet_iterate`` / ``fleet_check`` /
    ``run_fleet_superstep``, with the rank's own ``FleetState``, probes and
    draws and host operands (masks, per-network step budgets) for all
    ``shard.batch`` networks: each cuts out its slice and runs the
    unchanged fleet core on it, and does nothing when none of its networks
    is due. No collective: networks never interact. ``superstep``'s steps
    are the rank's own; the cohort reads everyone's from the tick's gather.
    """

    def iterate(fstate, mask, draws, **kw):
        mine = shard.local(mask, False)
        return (fleet_core.fleet_iterate(fstate, mine, draws, **kw)
                if mine.any() else fstate)

    def check(fstate, probes, mask, **kw):
        mine = shard.local(mask, False)
        return (fleet_core.fleet_check(fstate, probes, mine, **kw)
                if mine.any() else fstate)

    def superstep(fstate, probes, max_steps, draws, **kw):
        mine = shard.local(max_steps, 0)
        if not mine.any():
            return fstate, np.zeros(len(mine), np.int64)
        return fleet_core.run_fleet_superstep(fstate, probes, mine, draws,
                                              **kw)

    return iterate, check, superstep


def make_sharded_fleet_health(shard: FleetShard):
    """``fleet_core.fleet_health`` on this rank's networks; the ``(B,)``
    verdicts of all ranks are gathered to every rank (collective, one
    ``all_gather``; read-only). A rank whose screen raises makes every
    rank raise a :class:`RankFault`."""

    def health(nets: NetworkState) -> torch.Tensor:
        ok, error = np.zeros((1, shard.per_rank)), None
        try:
            ok = fleet_core.fleet_health(nets)
            with span("gson.wait"):
                ok = ok.cpu().numpy()[None]
        except Exception as e:                  # noqa: BLE001
            error = e
        return torch.from_numpy(shard.gather(ok, error)[0] > 0)

    return health


# ---------------------------------------------------------------------------
# a world of ranks on this host


def _rank_main(rank: int, fn, nprocs: int, backend: str, root: str,
               args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)     # what torchrun sets
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{root}/store",
                            rank=rank, world_size=nprocs)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(fn, nprocs: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on each rank of a fresh ``torch.distributed``
    world of ``nprocs`` spawned processes on this host, and return what
    each rank returned, in rank order.

    Each rank sets ``LOCAL_RANK`` (as torchrun does; under NCCL it also
    makes card ``rank`` current), joins the world through a file store in
    a new temporary directory (no network port), runs ``fn`` and leaves
    the world. ``fn`` and its results must be picklable (``fn`` a module
    level function). A rank that raises fails the call with its
    traceback; a world still running after ``timeout_s`` is killed and
    raises ``TimeoutError``.
    """
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as root:
        ctx = mp.start_processes(_rank_main, nprocs=nprocs, join=False,
                                 start_method="spawn",
                                 args=(fn, nprocs, backend, root, args))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline
                                           - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"a world of {nprocs} ranks ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        out = []
        for r in range(nprocs):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
