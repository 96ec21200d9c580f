"""Structured gradient-Gram-matrix factors (paper Sec. 2.2).

Counterpart of ``repro/core/gram.py``. Data matrices are stored (N, D):
observations on the first axis, the dimension on the last. Lambda is a
scalar or a (D,) diagonal. The DN x DN Gram matrix is never materialized
outside the test-only dense oracles: (K1e, K2e, Xt, lam) describe it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import backend
from .kernels import KernelSpec

Tensor = torch.Tensor


def scaled_gram(A: Tensor, B: Tensor, lam) -> Tensor:
    """(N_a, N_b) matrix A Lambda B^T for (N, D)-layout inputs: the
    ``skinny_gram`` kernel on the card."""
    return backend.scaled_gram(A, B, lam)


def pairwise_r(spec: KernelSpec, A: Tensor, B: Tensor, lam, c=None) -> Tensor:
    """r(x_a, x_b) for all pairs; A: (Na, D), B: (Nb, D) -> (Na, Nb).

    Stationary kernels take the gram and both row-norm strips from one
    ``fused_gram_norms`` pass over A and B.
    """
    return backend.pairwise_r(spec, A, B, lam, c=c)


class GramFactors(NamedTuple):
    """Everything needed to act with the DN x DN gradient Gram matrix.

    K1e/K2e: (N, N) effective first/second kernel-derivative matrices.
    Xt:      (N, D) centered inputs (X - c for dot kernels, X stationary).
    lam:     scalar or (D,) diagonal of Lambda.
    noise:   sigma^2 added to the Gram diagonal (exact paths need a scalar
             lam when noise > 0, so that it folds into K1e).
    c:       dot-kernel center; queries are centered with it.
    """

    K1e: Tensor
    K2e: Tensor
    Xt: Tensor
    lam: Tensor | float
    noise: float = 0.0
    c: Optional[Tensor] = None

    @property
    def n(self) -> int:
        return self.Xt.shape[0]

    @property
    def d(self) -> int:
        return self.Xt.shape[1]


def build_factors(spec: KernelSpec, X: Tensor, lam=1.0,
                  c: Optional[Tensor] = None,
                  noise: float = 0.0) -> GramFactors:
    """The O(N^2 + ND) factor set for observations at the rows of X."""
    r = pairwise_r(spec, X, X, lam, c=c)
    Xt = X if (spec.is_stationary or c is None) else X - c
    return GramFactors(K1e=spec.k1e(r), K2e=spec.k2e(r), Xt=Xt, lam=lam,
                       noise=float(noise),
                       c=None if spec.is_stationary else c)


class FactorBundle(NamedTuple):
    """Single-sweep factor set for one exact solve.

    factors: the usual ``GramFactors`` (K1e/K2e from the same sweep).
    S:       (N, N) (Xt Lam) Xt^T -- Woodbury's inner-system gram.
    C:       (N, N) G Xt^T -- the right-hand contraction, so that
             T0 = (K1i G) Xt^T = K1i @ C never touches the D axis.
    """

    factors: GramFactors
    S: Tensor
    C: Tensor


def build_factor_bundle(spec: KernelSpec, X: Tensor, G: Tensor, lam=1.0,
                        c: Optional[Tensor] = None,
                        noise: float = 0.0) -> FactorBundle:
    """ONE ``fused_factor_build`` pass over (X, G) -> every skinny factor of
    an exact solve; the rest of the solve is D-free until its output
    assembly."""
    Xt = X if (spec.is_stationary or c is None) else X - c
    P, na, nb, C, _ = backend.fused_factor_build(Xt, Xt, G, lam)
    if spec.is_stationary:
        r = torch.clamp_min(na[:, None] + nb[None, :] - 2.0 * P, 0.0)
    else:
        r = P
    f = GramFactors(K1e=spec.k1e(r), K2e=spec.k2e(r), Xt=Xt, lam=lam,
                    noise=float(noise), c=None if spec.is_stationary else c)
    return FactorBundle(factors=f, S=P, C=C)


# --------------------------------------------------------------------------
# Dense reference assembly -- tests only (O((ND)^2) memory).
# --------------------------------------------------------------------------

def _lam_vec(lam, d: int, like: Tensor) -> Tensor:
    return torch.broadcast_to(
        torch.as_tensor(lam, dtype=like.dtype, device=like.device), (d,))


def dense_gram(spec: KernelSpec, X: Tensor, lam=1.0, c=None,
               noise: float = 0.0) -> Tensor:
    """Explicit (N*D, N*D) gradient Gram matrix; index = a*D + i (Eq. 19)."""
    n, d = X.shape
    f = build_factors(spec, X, lam=lam, c=c)
    base = torch.diag(_lam_vec(lam, d, X))
    if spec.is_stationary:
        delta = (X[:, None, :] - X[None, :, :]) * lam        # (n, n, d)
        outer = delta[..., :, None] * delta[..., None, :]
    else:
        u = f.Xt * lam                                        # Lam x~
        # block(a,b) = K1e ab * Lam + K2e ab * outer(Lam x~_b, Lam x~_a)
        outer = u[None, :, :, None] * u[:, None, None, :]
    blocks = (f.K1e[:, :, None, None] * base[None, None]
              + f.K2e[:, :, None, None] * outer)
    full = blocks.permute(0, 2, 1, 3).reshape(n * d, n * d)
    if noise:
        full = full + noise * torch.eye(n * d, dtype=X.dtype,
                                        device=X.device)
    return full


def dense_cross_gram(spec: KernelSpec, Xq: Tensor, X: Tensor, lam=1.0,
                     c=None) -> Tensor:
    """Cross covariance cov(grad f(Xq), grad f(X)): (Nq*D, N*D)."""
    nq, d = Xq.shape
    n = X.shape[0]
    r = pairwise_r(spec, Xq, X, lam, c=c)
    K1e, K2e = spec.k1e(r), spec.k2e(r)
    base = torch.diag(_lam_vec(lam, d, X))
    if spec.is_stationary:
        delta = (Xq[:, None, :] - X[None, :, :]) * lam
        outer = delta[..., :, None] * delta[..., None, :]
    else:
        uq = (Xq - (0.0 if c is None else c)) * lam
        ub = (X - (0.0 if c is None else c)) * lam
        outer = ub[None, :, :, None] * uq[:, None, None, :]
    blocks = (K1e[:, :, None, None] * base[None, None]
              + K2e[:, :, None, None] * outer)
    return blocks.permute(0, 2, 1, 3).reshape(nq * d, n * d)
