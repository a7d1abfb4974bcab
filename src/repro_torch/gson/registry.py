"""Named registries for the composable GSON run API.

Four orthogonal axes, mirroring the paper's experimental matrix and
``repro.gson.registry``:

  VARIANTS  — how the iterate-sample-converge loop is parallelized
              ("multi", "multi-fused")
  MODELS    — the growing-network rule set (GNG / GWR / SOAM)
  SAMPLERS  — the signal distribution P(xi) (benchmark surfaces)
  BACKENDS  — implementations of the step's two hot phases (paper
              Sec. 2.5): Find Winners and the dense Update phase

Every axis accepts a registered name or a concrete object. A backend
that cannot run raises: nothing swaps in the reference behind the
caller's back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Generic, TypeVar

from repro_torch.core.gson.multi import find_winners_reference
from repro_torch.core.gson.sampling import SURFACES, make_sampler
from repro_torch.core.gson.state import GSONParams
from repro_torch.kernels.find_winners.ops import cuda_find_winners
from repro_torch.kernels.update_phase.ops import update_phase_op

T = TypeVar("T")


class Registry(Generic[T]):
    """A write-once name -> object table with helpful misses."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str, obj: T) -> T:
        """Add ``obj`` under ``name``; duplicate names are an error."""
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

    def __contains__(self, name: str) -> bool:
        return name in self._entries


# ---------------------------------------------------------------------------
# Models: the growing-network rule sets.

@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A registered rule set with its published defaults. SOAM runs end
    on its topology criterion, GNG and GWR on quantization error
    (``core.gson.fleet.fleet_check``)."""

    name: str
    params: GSONParams
    description: str = ""


MODELS: Registry[ModelDef] = Registry("model")

MODELS.register("gng", ModelDef(
    "gng", GSONParams(model="gng"),
    "Growing Neural Gas (Fritzke 95): error-driven periodic insertion"))
MODELS.register("gwr", ModelDef(
    "gwr", GSONParams(model="gwr"),
    "Grow When Required (Marsland 02): threshold + habituation insertion"))
MODELS.register("soam", ModelDef(
    "soam", GSONParams(model="soam"),
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
    """Registered name or a callable ``(gen, n) -> points``."""
    if isinstance(sampler, str):
        return SAMPLERS.get(sampler)
    if not callable(sampler):
        raise TypeError(
            f"sampler must be a registered name or a callable (gen, n) -> "
            f"points; got {type(sampler)!r}")
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


def resolve_backend(backend: str | Backend) -> Backend:
    """Registered name or a :class:`Backend`."""
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        return BACKENDS.get(backend)
    raise TypeError(f"backend must be a registered name or a Backend; "
                    f"got {type(backend)!r}")


# ---------------------------------------------------------------------------
# Variants: registered by repro_torch.gson.variants at import time.

VARIANTS: Registry[Any] = Registry("variant")
