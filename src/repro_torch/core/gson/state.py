"""Static-capacity network state for growing self-organizing networks.

The growing network lives in a fixed pool of ``capacity`` unit slots, so
every tensor keeps one shape for the whole run: growth activates free
slots, removal deactivates them. The invariants (symmetric neighbor
lists, symmetric ages, no self edges) are kept by the ops in
``topology.py``.

The PyTorch counterpart of ``repro.core.gson.state``: a dataclass of
tensors with the same field names. The JAX state also carries its PRNG
key as a leaf; here every random draw goes through ``repro_torch.rng``
instead, so the state holds tensors only.

A fleet of B networks is one ``NetworkState`` whose every leaf has a
leading ``(B,)`` axis (``init_fleet``, ``stack_states``); the step and
the structural tail are written for that form, and an unbatched state is
run as a fleet of one (``repro_torch.core.gson.batch``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Sentinel for "no neighbor" in fixed-degree neighbor lists.
NO_NBR = -1

# SOAM topological state ladder (Piastra 2012, simplified faithfully).
ACTIVE = 0      # fresh unit
HABITUATED = 1  # firing counter below habituation threshold
CONNECTED = 2   # every neighbor shares >=1 edge inside the neighborhood
HALF_DISK = 3   # neighborhood link-graph is a simple path
DISK = 4        # neighborhood link-graph is a single cycle
PATCH = 5       # disk, and all neighbors are disk/patch
SINGULAR = 6    # degree exhausted / non-manifold neighborhood

STATE_NAMES = ("active", "habituated", "connected", "half_disk", "disk",
               "patch", "singular")

FIELDS = ("w", "active", "nbr", "age", "error", "firing", "threshold",
          "topo_state", "inconsistent_for", "n_active", "signal_count",
          "discarded", "dropped_edges", "dropped_units")


@dataclass
class NetworkState:
    """The full mutable state of a growing self-organizing network."""

    # shapes of one network; a fleet puts (B,) in front of every one
    w: torch.Tensor                 # (capacity, dim) f32 reference vectors
    active: torch.Tensor            # (capacity,) bool
    nbr: torch.Tensor               # (capacity, max_deg) i32, NO_NBR = empty
    age: torch.Tensor               # (capacity, max_deg) f32 edge ages
    error: torch.Tensor             # (capacity,) f32 GNG error accumulator
    firing: torch.Tensor            # (capacity,) f32 habituation counter
    threshold: torch.Tensor         # (capacity,) f32 insertion threshold
    topo_state: torch.Tensor        # (capacity,) i32 SOAM state ladder
    inconsistent_for: torch.Tensor  # (capacity,) i32 iterations non-disk
    n_active: torch.Tensor          # () i32
    signal_count: torch.Tensor      # () i32 total signals consumed
    discarded: torch.Tensor         # () i32 signals discarded by the lock
    dropped_edges: torch.Tensor     # () i32 edge inserts dropped (overflow)
    dropped_units: torch.Tensor     # () i32 unit inserts dropped (full)

    @property
    def capacity(self) -> int:
        return self.w.shape[-2]

    @property
    def dim(self) -> int:
        return self.w.shape[-1]

    @property
    def max_deg(self) -> int:
        return self.nbr.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.w.device

    def replace(self, **kw) -> "NetworkState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "NetworkState":
        """``fn`` applied to every leaf."""
        return NetworkState(**{f: fn(getattr(self, f)) for f in FIELDS})

    def network(self, i: int) -> "NetworkState":
        """Network ``i`` of a fleet, unbatched (views, no copy)."""
        return self.map(lambda x: x[i])


def init_fleet(
    seed_points: torch.Tensor,
    *,
    capacity: int,
    max_deg: int,
    init_threshold: float = 0.2,
) -> NetworkState:
    """B fresh networks from ``seed_points`` (B, n_seed, dim): in each,
    the first ``n_seed`` units are active and unconnected. The device is
    that of ``seed_points``."""
    seed_points = seed_points.to(torch.float32)
    B, n_seed, dim = seed_points.shape
    dev = seed_points.device
    w = torch.zeros((B, capacity, dim), dtype=torch.float32, device=dev)
    w[:, :n_seed] = seed_points
    active = torch.zeros((B, capacity), dtype=torch.bool, device=dev)
    active[:, :n_seed] = True

    def full(shape, value, dtype):
        return torch.full((B, *shape), value, dtype=dtype, device=dev)

    i32, f32 = torch.int32, torch.float32
    return NetworkState(
        w=w,
        active=active,
        nbr=full((capacity, max_deg), NO_NBR, i32),
        age=full((capacity, max_deg), 0.0, f32),
        error=full((capacity,), 0.0, f32),
        firing=full((capacity,), 1.0, f32),
        threshold=full((capacity,), init_threshold, f32),
        topo_state=full((capacity,), 0, i32),
        inconsistent_for=full((capacity,), 0, i32),
        n_active=full((), n_seed, i32),
        signal_count=full((), 0, i32),
        discarded=full((), 0, i32),
        dropped_edges=full((), 0, i32),
        dropped_units=full((), 0, i32),
    )


def init_state(seed_points: torch.Tensor, *, capacity: int, max_deg: int,
               init_threshold: float = 0.2) -> NetworkState:
    """One fresh network from ``seed_points`` (n_seed, dim): the B = 1
    view of :func:`init_fleet`."""
    return init_fleet(seed_points[None], capacity=capacity, max_deg=max_deg,
                      init_threshold=init_threshold).network(0)


def stack_states(states) -> NetworkState:
    """Unbatched ``NetworkState``s stacked along a new leading axis."""
    return NetworkState(**{f: torch.stack([getattr(s, f) for s in states])
                           for f in FIELDS})


def unstack_states(nets: NetworkState) -> list[NetworkState]:
    """A stacked ``NetworkState`` split back into B unbatched ones."""
    return [nets.network(i) for i in range(nets.w.shape[0])]


@dataclass(frozen=True)
class GSONParams:
    """Hyper-parameters shared by GNG / GWR / SOAM update rules.

    Defaults follow the published settings of the respective papers; the
    paper under reproduction keeps one shared set across all meshes except
    the insertion threshold.
    """

    model: str = "soam"          # "gng" | "gwr" | "soam"
    eps_b: float = 0.05          # winner learning rate (eps_b >> eps_n)
    eps_n: float = 0.005         # neighbor learning rate
    age_max: float = 30.0        # edge expiry age
    # --- GNG ---
    gng_lambda: int = 100        # signals between insertions
    gng_alpha: float = 0.5       # error decay on split
    gng_beta: float = 0.0005     # global error decay
    # --- GWR / SOAM ---
    insertion_threshold: float = 0.2   # initial per-unit threshold
    firing_threshold: float = 0.3      # habituated when firing < this
    tau_b: float = 0.3           # winner habituation rate
    tau_n: float = 0.1           # neighbor habituation rate
    h_min: float = 0.1           # floor of the firing counter
    # --- SOAM adaptive threshold (tracks local feature size) ---
    thr_decay: float = 0.95      # multiplicative tightening when stuck
    thr_recover: float = 1.01    # slow relaxation when locally disk
    thr_min_frac: float = 0.05   # floor as a fraction of the initial threshold
    stuck_window: int = 20       # iterations non-disk before tightening
    # --- SOAM stabilization: stop moving topologically stable units ---
    freeze_stable: bool = True
    # --- multi-signal variant ---
    max_parallel: int = 8192     # paper's cap on m
    neighbor_collision: str = "sum"  # "sum" (deterministic) | "last" (GPU-like)
