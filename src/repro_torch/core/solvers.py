"""Preconditioned conjugate gradients on the matrix-free Gram MVM.

Counterpart of ``repro/core/solvers.py`` (``cg`` in this slice). The JAX
``lax.while_loop`` becomes a Python loop: every iteration reads the
squared residual norm on the host to decide whether to go on.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


class CGResult(NamedTuple):
    x: Tensor
    iters: int
    resnorm: float


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def cg(
    matvec: Callable[[Tensor], Tensor],
    b: Tensor,
    x0: Tensor | None = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    M_inv: Callable[[Tensor], Tensor] | None = None,
) -> CGResult:
    """Preconditioned CG; stops when ||r|| <= tol * ||b|| or at maxiter.

    Shapes are whatever ``matvec`` accepts; inner products are full-array.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    if M_inv is None:
        M_inv = lambda v: v
    bnorm = math.sqrt(float(_dot(b, b)))
    atol2 = (tol * max(bnorm, 1e-30)) ** 2

    r = b - matvec(x)
    z = M_inv(r)
    p = z
    rz = _dot(r, z)
    it = 0
    while it < maxiter and float(_dot(r, r)) > atol2:
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return CGResult(x=x, iters=it, resnorm=math.sqrt(float(_dot(r, r))))
