"""Preconditioned conjugate gradients on the matrix-free Gram MVM.

Counterpart of ``repro/core/solvers.py``. The JAX ``lax.while_loop``
becomes a Python loop: every iteration reads the squared residual norm on
the host to decide whether to go on, so a solve that does not converge
costs ``maxiter`` host round trips; give the Gram solves an explicit
``maxiter`` at large D.

Preconditioner: the Kronecker term B = K1e x Lam is a free one,
B^-1 vec(V) = (K1e^-1 @ V) / lam, one ``small_matmul`` pass per iteration.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import backend
from .gram import GramFactors
from .mvm import gram_matvec, gram_matvec_multi

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


def gram_cg_solve(spec, f: GramFactors, G: Tensor, *, tol: float = 1e-6,
                  maxiter: int | None = None, precondition: bool = True,
                  jitter: float = 1e-10) -> CGResult:
    """Solve (grad K grad') vec(Z) = vec(G) iteratively (paper Sec. 5.2).

    Per iteration: ONE fused Gram MVM plus, when preconditioning, one
    ``backend.kron_precond`` pass. G may also be a stacked (R, N, D)
    batch: the operator is block-diagonal over R, so CG on the stacked
    array is plain CG on an SPD operator, each iteration ONE multi-RHS MVM
    that streams Xt once for all R systems; convergence is judged on the
    joint residual norm. ``maxiter`` defaults to N * D, as in the JAX
    package.
    """
    n, d = G.shape[-2:]
    maxiter = maxiter if maxiter is not None else n * d
    if G.ndim == 3:
        mv = lambda V: gram_matvec_multi(f, V, stationary=spec.is_stationary)
    else:
        mv = lambda V: gram_matvec(f, V, stationary=spec.is_stationary)
    M_inv = _kron_precond_fn(f, n, G.dtype, jitter) if precondition else None
    return cg(mv, G, tol=tol, maxiter=maxiter, M_inv=M_inv)


def _kron_precond_fn(f: GramFactors, n: int, dtype, jitter: float):
    """B^-1 for the free Kronecker preconditioner B = K1e x Lam."""
    eye = torch.eye(n, dtype=dtype, device=f.K1e.device)
    K1 = f.K1e + jitter * eye
    if f.noise:
        K1 = K1 + (f.noise / f.lam) * eye
    K1i = torch.linalg.inv(K1).contiguous()
    return lambda V: backend.kron_precond(K1i, V, f.lam)


def gram_cg_solve_multi(spec, f: GramFactors, G: Tensor, **kw) -> CGResult:
    """Stacked-RHS CG: G (R, N, D). The same solve as ``gram_cg_solve``;
    this name exists for call-site clarity."""
    if G.ndim != 3:
        raise ValueError(f"gram_cg_solve_multi takes G (R, N, D), got "
                         f"{tuple(G.shape)}")
    return gram_cg_solve(spec, f, G, **kw)
