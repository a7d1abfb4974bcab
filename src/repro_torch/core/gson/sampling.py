"""Point-cloud samplers for the surface-reconstruction benchmarks.

The paper's meshes (bunny, eight, hand, heptoroid) are not
redistributable, so the repository samples parametric / implicit
surfaces matched to the two complexity axes the paper varies — genus and
local-feature-size (LFS) variability:

  sphere        genus 0, constant LFS          (easy; 'bunny'-class size)
  torus         genus 1, constant LFS          (intermediate)
  eight         genus 2, constant-ish LFS      (the paper's 'Eight')
  trefoil       genus 1, strongly varying LFS  ('hand'-class difficulty)

A sampler is ``sampler(gen, n) -> (n, 3) f32`` on ``gen.device``, and is
deterministic in the ``torch.Generator``. The surfaces are those of
``repro.core.gson.sampling``; the draws differ (torch's generator is not
JAX's threefry), and the derivatives that JAX takes by autodiff are
written out by hand.
"""
from __future__ import annotations

import dataclasses
import math

import torch

SURFACES = ("sphere", "torus", "eight", "trefoil")
_TWO_PI = 2 * math.pi


def _uniform(gen: torch.Generator, n: int, hi: float = 1.0) -> torch.Tensor:
    return torch.rand((n,), generator=gen, device=gen.device) * hi


def sample(name: str, gen: torch.Generator, n: int) -> torch.Tensor:
    if name == "sphere":
        return sample_sphere(gen, n)
    if name == "torus":
        return sample_torus(gen, n)
    if name == "eight":
        return sample_eight(gen, n)
    if name == "trefoil":
        return sample_trefoil(gen, n)
    raise ValueError(f"unknown surface {name!r}; options: {SURFACES}")


def make_sampler(name: str) -> "SurfaceSampler":
    """Returns sampler(gen, n) -> (n, 3) f32 for the named surface."""
    if name not in SURFACES:
        raise ValueError(f"unknown surface {name!r}; options: {SURFACES}")
    return SurfaceSampler(name)


@dataclasses.dataclass(frozen=True)
class SurfaceSampler:
    name: str

    def __call__(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return sample(self.name, gen, n)


# ---------------------------------------------------------------------------

def sample_sphere(gen: torch.Generator, n: int,
                  radius: float = 1.0) -> torch.Tensor:
    v = torch.randn((n, 3), generator=gen, device=gen.device)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    return (radius * v).to(torch.float32)


def sample_torus(gen: torch.Generator, n: int, big_r: float = 1.0,
                 small_r: float = 0.35) -> torch.Tensor:
    """Uniform-area torus sampling via rejection on the minor angle."""
    theta = _uniform(gen, n, _TWO_PI)
    # 4x oversampled rejection, accepted values compacted to the front;
    # a shortfall (probability negligible) reuses the first accepted value
    m = 4 * n
    phi = _uniform(gen, m, _TWO_PI)
    u = _uniform(gen, m)
    accept = u < (big_r + small_r * torch.cos(phi)) / (big_r + small_r)
    idx = torch.argsort((~accept).to(torch.int32), stable=True)[:n]
    phi = phi[idx]
    x = (big_r + small_r * torch.cos(phi)) * torch.cos(theta)
    y = (big_r + small_r * torch.cos(phi)) * torch.sin(theta)
    z = small_r * torch.sin(phi)
    return torch.stack([x, y, z], dim=1).to(torch.float32)


# --- genus-2 'eight' (double torus): product-of-tori implicit ------------

_EIGHT_C = 0.65     # torus center offset along x
_EIGHT_R = 0.55     # major radius
_EIGHT_r = 0.22     # minor radius
_EIGHT_EPS = 0.02   # blend amount


def _torus_f_grad(p: torch.Tensor, cx: float):
    """T(p) = (rho - R)^2 + z^2 - r^2 with rho = |(x - cx, y)|, and its
    gradient."""
    dx = p[:, 0] - cx
    rho = torch.sqrt(dx * dx + p[:, 1] ** 2)
    q = rho - _EIGHT_R
    f = q ** 2 + p[:, 2] ** 2 - _EIGHT_r ** 2
    k = 2.0 * q / rho.clamp(min=1e-12)
    g = torch.stack([k * dx, k * p[:, 1], 2.0 * p[:, 2]], dim=1)
    return f, g


def eight_implicit(p: torch.Tensor) -> torch.Tensor:
    """F(p) = T1(p) * T2(p) - eps == 0 is a smooth genus-2 surface."""
    return eight_implicit_grad(p)[0]


def eight_implicit_grad(p: torch.Tensor):
    """(F(p), grad F(p)) with grad F = T2 grad T1 + T1 grad T2."""
    f1, g1 = _torus_f_grad(p, -_EIGHT_C)
    f2, g2 = _torus_f_grad(p, _EIGHT_C)
    return f1 * f2 - _EIGHT_EPS, f2[:, None] * g1 + f1[:, None] * g2


def _project_to_eight(p: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Newton projection p <- p - F * grad F / |grad F|^2."""
    for _ in range(iters):
        val, g = eight_implicit_grad(p)
        p = p - val[:, None] * g / ((g * g).sum(dim=1, keepdim=True)
                                    + 1e-12)
    return p


def sample_eight(gen: torch.Generator, n: int) -> torch.Tensor:
    """Sample near both tori then Newton-project onto the blended surface."""
    base = sample_torus(gen, n, _EIGHT_R, _EIGHT_r)
    side = torch.where(_uniform(gen, n) < 0.5, 1.0, -1.0)
    p = base.clone()
    p[:, 0] += side * _EIGHT_C
    return _project_to_eight(p).to(torch.float32)


# --- trefoil tube: genus 1 but strongly varying LFS ----------------------

def _trefoil_curve(t: torch.Tensor) -> torch.Tensor:
    x = torch.sin(t) + 2.0 * torch.sin(2.0 * t)
    y = torch.cos(t) - 2.0 * torch.cos(2.0 * t)
    z = -torch.sin(3.0 * t)
    return torch.stack([x, y, z], dim=-1) / 3.0


def _trefoil_tangent(t: torch.Tensor) -> torch.Tensor:
    """d/dt of :func:`_trefoil_curve`."""
    x = torch.cos(t) + 4.0 * torch.cos(2.0 * t)
    y = -torch.sin(t) + 4.0 * torch.sin(2.0 * t)
    z = -3.0 * torch.cos(3.0 * t)
    return torch.stack([x, y, z], dim=-1) / 3.0


def sample_trefoil(gen: torch.Generator, n: int,
                   tube_r: float = 0.12) -> torch.Tensor:
    """Tube of radius tube_r around a trefoil knot (frenet frame)."""
    t = _uniform(gen, n, _TWO_PI)
    alpha = _uniform(gen, n, _TWO_PI)
    c = _trefoil_curve(t)
    tang = _trefoil_tangent(t)
    tang = tang / (torch.linalg.norm(tang, dim=1, keepdim=True) + 1e-12)
    up = torch.tensor([0.13, 0.57, 0.81], device=t.device).expand_as(tang)
    n1 = torch.linalg.cross(tang, up)
    n1 = n1 / (torch.linalg.norm(n1, dim=1, keepdim=True) + 1e-12)
    n2 = torch.linalg.cross(tang, n1)
    offs = tube_r * (torch.cos(alpha)[:, None] * n1
                     + torch.sin(alpha)[:, None] * n2)
    return (c + offs).to(torch.float32)
