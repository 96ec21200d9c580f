"""Kernel zoo: scalar kernels k(r) with derivatives w.r.t. the scalar r.

PyTorch counterpart of ``repro/core/kernels.py``. Every kernel is expressed
through a scalar intermediate r(x_a, x_b) (paper Def. 2):

  dot-product kernels:  r = (x_a - c)^T Lambda (x_b - c)
  stationary kernels:   r = (x_a - x_b)^T Lambda (x_a - x_b)

The "effective" coefficients absorb the chain-rule factors of r so that for
BOTH families the (a, b) block of the gradient Gram matrix reads

    block_ab = K1e[a,b] * Lambda + K2e[a,b] * outer(u_ab, w_ab)

  dot:        K1e = k'(r),    K2e = k''(r),    K3e = k'''(r)
  stationary: K1e = -2 k'(r), K2e = -4 k''(r), K3e = -8 k'''(r)

The closed forms run in the dtype of ``r`` on its device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor

# Guard for kernels whose r-derivatives are singular at r=0 (Matern family);
# the singular factors are always multiplied by powers of ||x_a - x_b|| that
# vanish at least as fast, so clamping r is exact in the limit.
_R_EPS = 1e-12
_SQRT3 = math.sqrt(3.0)


def _safe_sqrt(r: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(r, _R_EPS))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A scalar kernel k(r) and its first three derivatives in r."""

    name: str
    family: str  # 'dot' | 'stationary'
    k0: Callable[[Tensor], Tensor]
    k1: Callable[[Tensor], Tensor]
    k2: Callable[[Tensor], Tensor]
    k3: Callable[[Tensor], Tensor]
    # True if the gradient GP is well defined (k' finite at r=0 for
    # stationary kernels).
    grad_ok: bool = True

    @property
    def is_stationary(self) -> bool:
        return self.family == "stationary"

    def k1e(self, r: Tensor) -> Tensor:
        v = self.k1(r)
        return -2.0 * v if self.is_stationary else v

    def k2e(self, r: Tensor) -> Tensor:
        v = self.k2(r)
        return -4.0 * v if self.is_stationary else v

    def k3e(self, r: Tensor) -> Tensor:
        v = self.k3(r)
        return -8.0 * v if self.is_stationary else v


# --------------------------------------------------------------------------
# Stationary kernels (paper Table 2); r is the SQUARED scaled distance.
# --------------------------------------------------------------------------

def _rbf() -> KernelSpec:
    k0 = lambda r: torch.exp(-0.5 * r)
    return KernelSpec(
        "rbf", "stationary",
        k0=k0,
        k1=lambda r: -0.5 * k0(r),
        k2=lambda r: 0.25 * k0(r),
        k3=lambda r: -0.125 * k0(r),
    )


def _matern12() -> KernelSpec:
    # k = exp(-sqrt(r)); k' singular at 0 -> gradient GP ill-defined.
    k0 = lambda r: torch.exp(-_safe_sqrt(r))
    return KernelSpec(
        "matern12", "stationary",
        k0=k0,
        k1=lambda r: -k0(r) / (2.0 * _safe_sqrt(r)),
        k2=lambda r: (_safe_sqrt(r) + 1.0) / (4.0 * _safe_sqrt(r) ** 3) * k0(r),
        k3=lambda r: -(3.0 + 3.0 * _safe_sqrt(r) + r)
        / (8.0 * _safe_sqrt(r) ** 5) * k0(r),
        grad_ok=False,
    )


def _matern32() -> KernelSpec:
    # k = (1+s) e^{-s}, s = sqrt(3 r).
    def k0(r):
        s = torch.sqrt(3.0 * torch.clamp_min(r, 0.0))
        return (1.0 + s) * torch.exp(-s)

    def k1(r):
        s = torch.sqrt(3.0 * torch.clamp_min(r, 0.0))
        return -1.5 * torch.exp(-s)

    def k2(r):
        sr = _safe_sqrt(r)
        return (3.0 * _SQRT3 / (4.0 * sr)) * torch.exp(-_SQRT3 * sr)

    def k3(r):
        sr = _safe_sqrt(r)
        return k2(r) * (-0.5 / torch.clamp_min(r, _R_EPS) - _SQRT3 / (2.0 * sr))

    return KernelSpec("matern32", "stationary", k0, k1, k2, k3)


def _matern52() -> KernelSpec:
    # k = (1 + s + s^2/3) e^{-s}, s = sqrt(5 r).
    def k0(r):
        s = torch.sqrt(5.0 * torch.clamp_min(r, 0.0))
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)

    def k1(r):
        s = torch.sqrt(5.0 * torch.clamp_min(r, 0.0))
        return -(5.0 / 6.0) * (1.0 + s) * torch.exp(-s)

    def k2(r):
        s = torch.sqrt(5.0 * torch.clamp_min(r, 0.0))
        return (25.0 / 12.0) * torch.exp(-s)

    def k3(r):
        s = torch.sqrt(5.0 * torch.clamp_min(r, _R_EPS))
        return -(125.0 / 24.0) * torch.exp(-s) / s

    return KernelSpec("matern52", "stationary", k0, k1, k2, k3)


def _rational_quadratic(alpha: float = 2.0) -> KernelSpec:
    a = float(alpha)

    def base(r, p):
        return (1.0 + r / (2.0 * a)) ** (-a - p)

    return KernelSpec(
        f"rq{a:g}", "stationary",
        k0=lambda r: base(r, 0.0),
        k1=lambda r: -0.5 * base(r, 1.0),
        k2=lambda r: (a + 1.0) / (4.0 * a) * base(r, 2.0),
        k3=lambda r: -(a + 1.0) * (a + 2.0) / (8.0 * a * a) * base(r, 3.0),
    )


# --------------------------------------------------------------------------
# Dot-product kernels (paper Table 1); r is the centered scaled dot product.
# --------------------------------------------------------------------------

def _poly2() -> KernelSpec:
    return KernelSpec(
        "poly2", "dot",
        k0=lambda r: 0.5 * r * r,
        k1=lambda r: r,
        k2=lambda r: torch.ones_like(r),
        k3=lambda r: torch.zeros_like(r),
    )


def _poly(p: int) -> KernelSpec:
    p = int(p)
    if p < 2:
        raise ValueError("polynomial kernel needs p >= 2 for gradient GPs")

    return KernelSpec(
        f"poly{p}", "dot",
        k0=lambda r: r**p / (p * (p - 1)),
        k1=lambda r: r ** (p - 1) / (p - 1),
        k2=lambda r: r ** (p - 2),
        k3=lambda r: (p - 2) * r ** (p - 3) if p >= 3 else torch.zeros_like(r),
    )


def _exp_dot() -> KernelSpec:
    e = lambda r: torch.exp(r)
    return KernelSpec("expdot", "dot", e, e, e, e)


_REGISTRY: dict[str, Callable[[], KernelSpec]] = {
    "rbf": _rbf,
    "matern12": _matern12,
    "matern32": _matern32,
    "matern52": _matern52,
    "rq": _rational_quadratic,
    "poly2": _poly2,
    "poly3": lambda: _poly(3),
    "poly4": lambda: _poly(4),
    "expdot": _exp_dot,
}


def get_kernel(name: str, **kwargs) -> KernelSpec:
    """Look up a kernel by name. ``rq`` takes ``alpha``; ``poly<p>`` is fixed."""
    if name == "rq":
        return _rational_quadratic(**kwargs)
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(_REGISTRY)}")


def kernel_names() -> list[str]:
    return sorted(_REGISTRY)
