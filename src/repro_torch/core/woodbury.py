"""Exact gradient-Gram solves via Woodbury (paper Sec. 2.3, App. C.1).

Counterpart of ``repro/core/woodbury.py``. Solves
(grad K grad') vec(Z) = vec(G) in O(N^2 D + N^6) instead of O((ND)^3).
The only O(D) work is one ``fused_factor_build`` sweep (S and C = G Xt^T)
and one ``gram_update`` output stream; the N^2 x N^2 inner system is built
and solved densely (N <= ~64).

Inner operator and solution (K1i = K1e^-1, S = (Xt*lam) @ Xt^T):

  dot:        F(Q) = Q^T / K2e + K1i @ Q @ S
              Z    = K1i @ (G / lam - Q @ Xt)
  stationary: F(Q) = -Q^T / K2e + lt_op(K1i @ l_op(Q) @ S)
              Z    = K1i @ (G / lam - l_op(Q) @ X)

Special case (paper Sec. 4.2): poly2 kernel + quadratic objective gives
Q = 1/2 S^-1 (Xt (G - g_c)^T)^T in closed form, O(N^2 D + N^3).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import backend
from .gram import FactorBundle, GramFactors
from .kernels import KernelSpec
from .mvm import l_op, lt_op

Tensor = torch.Tensor


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _materialize(op: Callable[[Tensor], Tensor], n: int,
                 like: Tensor) -> Tensor:
    """The dense (n^2, n^2) matrix of a linear operator on (n, n) matrices.

    ``op`` must act batched over a leading axis: it runs once on the stack
    of the n^2 basis matrices. Column k is the row-major vec of op(E_k),
    so A @ vec(Q) = vec(op(Q)), as the JAX function builds it.
    """
    basis = _eye(n * n, like).reshape(n * n, n, n)
    return op(basis).reshape(n * n, n * n).T


def _k1_noisy(f: GramFactors, K1: Tensor) -> Tensor:
    """K1e + (noise/lam) I: (K1e x Lam) + s I = (K1e + s/lam I) x Lam,
    which needs a scalar Lambda."""
    if not f.noise:
        return K1
    if isinstance(f.lam, Tensor) and f.lam.ndim != 0:
        raise ValueError("noise > 0 requires scalar Lambda on the exact path")
    return K1 + (f.noise / f.lam) * _eye(f.n, K1)


def _assemble(K1i: Tensor, QL: Tensor, G: Tensor, f: GramFactors) -> Tensor:
    """Z = K1i @ (G/lam - QL @ Xt) as ONE ``gram_update`` stream: the K1i
    factor is pushed through both terms, so no (N, D) intermediate
    materializes."""
    return backend.gram_update(K1i.contiguous(), -(K1i @ QL).contiguous(),
                               G, f.Xt, 1.0, v_scale=1.0 / f.lam)


def woodbury_solve(spec: KernelSpec, f: GramFactors, G: Tensor,
                   jitter: float = 1e-10,
                   bundle: FactorBundle | None = None) -> Tensor:
    """Z (N, D) with (grad K grad') vec(Z) = vec(G). Exact (paper Eq. 6-8).

    Pass ``bundle`` (from :func:`repro_torch.core.gram.build_factor_bundle`,
    which shares the sweep with the K1e/K2e build) to skip the one input
    sweep here.
    """
    n = f.n
    dtype = G.dtype
    K1 = _k1_noisy(f, f.K1e)
    K1i = torch.linalg.inv(K1 + jitter * _eye(n, K1))
    if bundle is None:
        S, _, _, C, _ = backend.fused_factor_build(f.Xt, f.Xt, G, f.lam)
    else:
        S, C = bundle.S, bundle.C
    S = S.to(dtype)
    T0 = K1i @ C.to(dtype)                 # = (K1i G) Xt^T, now O(N^3)
    K2e = f.K2e

    if spec.is_stationary:
        T = lt_op(T0)

        def inner(Q):
            return -Q.transpose(-1, -2) / K2e + lt_op(K1i @ l_op(Q) @ S)
    else:
        T = T0

        def inner(Q):
            return Q.transpose(-1, -2) / K2e + K1i @ Q @ S

    A = _materialize(inner, n, S)
    q = torch.linalg.solve(A + jitter * _eye(n * n, A), T.reshape(-1))
    Q = q.reshape(n, n)
    QL = l_op(Q) if spec.is_stationary else Q
    return _assemble(K1i, QL, G, f)


def poly2_quadratic_solve(f: GramFactors, G: Tensor,
                          g_c: Tensor | None = None,
                          jitter: float = 1e-12) -> Tensor:
    """O(N^2 D + N^3) exact solve for the poly2 kernel on a quadratic target.

    Paper Sec. 4.2 / App. C.1: with k(r) = r^2/2 (K2e == 1, K1e == S on
    data from f(x) = 1/2 (x-x*)^T A (x-x*), prior gradient mean
    g_c = A(c - x*)):

        Q = 1/2 S^-1 (Xt (G - g_c)^T)^T     -- one N x N solve
        Z = K1i @ ((G - g_c) / lam - Q^T @ Xt)
    """
    Gt = G if g_c is None else G - g_c
    n = f.n
    dtype = G.dtype
    # ONE sweep of (Xt, Gt): S = (Xt L) Xt^T and C = Gt Xt^T together
    S, _, _, C, _ = backend.fused_factor_build(f.Xt, f.Xt, Gt, f.lam)
    S = S.to(dtype)
    eye = _eye(n, S)
    # Sa = Xt Gt^T = C^T; Q = 1/2 Sa S^-1 solves F(Q) = T analytically
    Sa = C.T.to(dtype)
    Q = 0.5 * torch.linalg.solve((S + jitter * eye).T, Sa.T).T
    K1i = torch.linalg.inv(f.K1e + jitter * eye)
    return _assemble(K1i, Q, Gt, f)


def dense_solve(spec: KernelSpec, X: Tensor, G: Tensor, lam=1.0, c=None,
                noise: float = 0.0, jitter: float = 1e-10) -> Tensor:
    """O((ND)^3) reference solve against the materialized Gram (tests
    only)."""
    from .gram import dense_gram

    n, d = X.shape
    full = dense_gram(spec, X, lam=lam, c=c, noise=noise)
    z = torch.linalg.solve(full + jitter * _eye(n * d, full), G.reshape(-1))
    return z.reshape(n, d)
