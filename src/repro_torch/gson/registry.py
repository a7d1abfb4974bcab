"""Named registries for the composable GSON run API.

Four orthogonal axes, mirroring the paper's experimental matrix and
``repro.gson.registry``:

  VARIANTS  — how the iterate-sample-converge loop is parallelized
              ("single", "indexed", "multi", "multi-fused")
  MODELS    — the growing-network rule set (GNG / GWR / SOAM)
  SAMPLERS  — the signal distribution P(xi) (benchmark surfaces, and
              point-cloud streams from ``repro_torch.data.pointclouds``)
  BACKENDS  — implementations of the step's two hot phases (paper
              Sec. 2.5): Find Winners and the dense Update phase (the
              plain references, the Hopper kernels, and the approximate
              searches of ``repro_torch.ann``)

Every axis accepts a registered name or a concrete object. A backend
that cannot run raises: nothing swaps in the reference behind the
caller's back. Unlike the JAX registry, whose BACKENDS entries are
factories, this one holds the ``Backend`` objects themselves; the ANN
searches come from memoized constructors, so one recall target gives one
instance wherever it is resolved.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Generic, Iterator, TypeVar

from repro_torch import ann
from repro_torch.core.gson.multi import find_winners_reference
from repro_torch.core.gson.sampling import SURFACES, make_sampler
from repro_torch.core.gson.state import GSONParams
from repro_torch.gson import autotune
from repro_torch.kernels.find_winners.ops import cuda_find_winners
from repro_torch.kernels.update_phase.ops import update_phase_op
from repro_torch.kernels.update_phase.sparse import update_phase_sparse

T = TypeVar("T")


class Registry(Generic[T]):
    """A write-once name -> object table with helpful misses."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str, obj: T | None = None):
        """``register(name, obj)`` directly, or ``@register(name)`` as a
        decorator. Duplicate names are an error."""
        if obj is None:
            return functools.partial(self.register, name)
        if name in self._entries:
            raise ValueError(
                f"duplicate {self.kind} registration {name!r}")
        self._entries[name] = obj
        return obj

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{', '.join(self.names())}") from None

    def names(self) -> tuple[str, ...]:
        """Registered names, sorted."""
        return tuple(sorted(self._entries))

    def items(self):
        return tuple(sorted(self._entries.items()))

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}: {', '.join(self.names())})"


# ---------------------------------------------------------------------------
# Models: the growing-network rule sets.

@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A registered rule set: published defaults + how runs terminate.

    ``convergence`` selects the termination predicate of every run
    (``core.gson.fleet.convergence_check``, through the loop config that
    ``gson.fleet.Cohort`` builds, and ``variants.check_convergence``):
    "topology" = SOAM's all-units-disk/patch criterion, "qe" =
    quantization-error threshold.
    """

    name: str
    params: GSONParams
    convergence: str        # "topology" (SOAM) | "qe" (GNG/GWR)
    description: str = ""


MODELS: Registry[ModelDef] = Registry("model")

MODELS.register("gng", ModelDef(
    "gng", GSONParams(model="gng"), "qe",
    "Growing Neural Gas (Fritzke 95): error-driven periodic insertion"))
MODELS.register("gwr", ModelDef(
    "gwr", GSONParams(model="gwr"), "qe",
    "Grow When Required (Marsland 02): threshold + habituation insertion"))
MODELS.register("soam", ModelDef(
    "soam", GSONParams(model="soam"), "topology",
    "Self-Organizing Adaptive Map (Piastra 12): terminates when every "
    "unit neighborhood is a disk/patch"))


def resolve_model(model: str | GSONParams) -> GSONParams:
    """Name -> published defaults; a GSONParams instance passes through
    (validated against the registry so typos in ``model=`` fail early)."""
    if isinstance(model, GSONParams):
        MODELS.get(model.model)
        return model
    return MODELS.get(model).params


# ---------------------------------------------------------------------------
# Samplers: P(xi), each ``f(gen, n) -> (n, dim) f32``.

SAMPLERS: Registry[Any] = Registry("sampler")

for _surface in SURFACES:
    SAMPLERS.register(_surface, make_sampler(_surface))


def resolve_sampler(sampler: str | Any):
    """Name, sampler ``(gen, n) -> points``, or a point-cloud stream
    (anything with ``as_sampler()``, e.g.
    ``repro_torch.data.pointclouds.PointCloudStream``)."""
    if isinstance(sampler, str):
        return SAMPLERS.get(sampler)
    as_sampler = getattr(sampler, "as_sampler", None)
    if as_sampler is not None:
        return as_sampler()
    if not callable(sampler):
        raise TypeError(
            f"sampler must be a registered name, a callable (gen, n) -> "
            f"points, or a point-cloud stream; got {type(sampler)!r}")
    return sampler


# ---------------------------------------------------------------------------
# Backends: implementations of the step's two hot phases. A ``None``
# phase field means the plain reference for that phase.


@dataclasses.dataclass(frozen=True)
class Backend:
    """One entry on the BACKENDS axis: per-phase implementations.

    ``find_winners`` is a ``FindWinnersFn`` (top-2 nearest-unit search),
    ``update_phase`` an ``UpdatePhaseFn`` (winner lock + dense
    adaptation; see ``repro_torch.core.gson.multi``).
    """

    name: str
    find_winners: Any = None      # FindWinnersFn | None (= reference)
    update_phase: Any = None      # UpdatePhaseFn | None (= reference)
    description: str = ""


# The ANN searches are frozen dataclasses (equal configs compare equal);
# the caches keep one instance per config, so the registered entries and
# ``ann_backend`` at the same recall target share it.

@functools.lru_cache(maxsize=None)
def _ann_windowed(recall_target: float):
    return ann.windowed_find_winners(recall_target)


@functools.lru_cache(maxsize=None)
def _ann_grid(recall_target: float):
    return ann.grid_find_winners(recall_target)


@functools.lru_cache(maxsize=None)
def _indexed_find_winners():
    return ann.indexed_find_winners()


BACKENDS: Registry[Backend] = Registry("backend")

BACKENDS.register("reference", Backend(
    "reference", find_winners_reference, None,
    "plain PyTorch for both phases"))
BACKENDS.register("cuda", Backend(
    "cuda", cuda_find_winners, None,
    "Hopper Find Winners kernel, reference Update"))
BACKENDS.register("cuda-update", Backend(
    "cuda-update", find_winners_reference, update_phase_op,
    "reference Find Winners, Hopper Update-phase kernels"))
BACKENDS.register("cuda-full", Backend(
    "cuda-full", cuda_find_winners, update_phase_op,
    "Hopper kernels for both hot phases"))
BACKENDS.register("cuda-sparse", Backend(
    "cuda-sparse", find_winners_reference, update_phase_sparse,
    "reference Find Winners, winner-neighborhood slab Update: the "
    "Update-phase kernels run on just the unit tiles the batch touches"))
BACKENDS.register("cuda-auto", Backend(
    "cuda-auto", find_winners_reference,
    autotune.make_autotuned_update_phase(),
    "shape-selected Update: per (capacity, m) the faster of cuda / sparse "
    "in the selection table measured on the card "
    "(repro_torch.gson.autotune)"))


BACKENDS.register("ann-windowed", Backend(
    "ann-windowed", _ann_windowed(0.95), None,
    "approximate Find Winners: windowed top-1 -> exact top-2 rerank, "
    "window count from the birthday recall model at recall 0.95"))
BACKENDS.register("ann-grid", Backend(
    "ann-grid", _ann_grid(0.95), None,
    "approximate Find Winners: hash-grid quantizer -> stencil shortlist "
    "-> exact rerank, grid rebuilt on the refresh cadence"))
BACKENDS.register("indexed", Backend(
    "indexed", _indexed_find_winners(), None,
    "the paper's Indexed baseline (Sec. 3.1): hash grid with per-signal "
    "exhaustive fallback"))


def ann_backend(kind: str = "ann-windowed",
                recall_target: float = 0.95) -> Backend:
    """An ANN :class:`Backend` of a registered shape at a custom recall
    target (the ``--recall-target`` path). Equal targets share one
    search instance with the registered entries."""
    if kind == "ann-windowed":
        fw = _ann_windowed(recall_target)
    elif kind == "ann-grid":
        fw = _ann_grid(recall_target)
    else:
        raise KeyError(
            f"ann_backend kind must be 'ann-windowed' or 'ann-grid', "
            f"got {kind!r}")
    return Backend(
        f"{kind}@r{recall_target:g}", fw, None,
        f"{kind} at recall_target={recall_target:g}")


def resolve_backend(backend: str | Any | None) -> Backend:
    """Name / Backend / bare FindWinnersFn -> a :class:`Backend`.

    ``None`` selects the reference for both phases. A bare callable is a
    Find Winners search run with the reference Update phase.
    """
    if backend is None:
        return Backend("reference")
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        return BACKENDS.get(backend)
    if not callable(backend):
        raise TypeError(
            f"backend must be a registered name, a Backend, or a "
            f"FindWinnersFn; got {type(backend)!r}")
    return Backend("custom", find_winners=backend)


# ---------------------------------------------------------------------------
# Variants: registered by repro_torch.gson.variants at import time.

VARIANTS: Registry[Any] = Registry("variant")
