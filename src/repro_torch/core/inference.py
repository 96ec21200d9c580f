"""Posterior inference from gradient observations (paper Sec. 4, App. D/E).

Counterpart of ``repro/core/inference.py``. Given Z solving
(grad K grad') vec(Z) = vec(G - prior_grad):

  * posterior mean gradient at x_q      -- cross_grad_matvec (Eq. 26)
  * posterior mean function at x_q      -- cross_value_matvec (up to a constant)
  * posterior mean Hessian at x_q       -- Eq. 12 closed form, diag + rank-2N
  * posterior optimum ("GP-X", Eq. 13)  -- flipped inference x(g = 0)

  dot:        Hbar = Lam [ Xt^T M Xt + Z^T Mh Xt + Xt^T Mh Z ] Lam
              M  = diag(k3e(r_qb) * w_b),  w_b = x~_q^T Lam Z_b
              Mh = diag(k2e(r_qb))                     (no trace term)
  stationary: same structure with Xt -> (x_q - X), w -> m_b = (x_q-x_b)^T Lam Z_b,
              coefficients (-8 k''' m_b), (-4 k''), plus Lam * sum_b(-4 k'' m_b).

The Hessian's O(ND) sums and its (D, 2N) factor are plain PyTorch, as the
JAX package leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gram import GramFactors
from .kernels import KernelSpec
from .mvm import cross_grad_matvec, cross_value_matvec

Tensor = torch.Tensor


def posterior_grad(spec: KernelSpec, xq: Tensor, f: GramFactors,
                   Z: Tensor) -> Tensor:
    """Posterior mean of grad f at query points xq: (Nq, D)."""
    return cross_grad_matvec(spec, torch.atleast_2d(xq), f, Z)


def posterior_value(spec: KernelSpec, xq: Tensor, f: GramFactors,
                    Z: Tensor) -> Tensor:
    """Posterior mean of f at xq, up to the (unidentified) prior constant."""
    return cross_value_matvec(spec, torch.atleast_2d(xq), f, Z)


class HessianOperator(NamedTuple):
    """Posterior mean Hessian H = diag + P W P^T.

    P = [Lam Xt^T, Lam Z^T] (D, 2N) and W = [[M, Mh], [Mh, 0]] (2N, 2N);
    ``diag`` is the (D,) Lam * trace term. Stored factored, so it is
    applied or inverted in O(ND + N^3) (Woodbury again, paper Sec. 4.1.1).
    """

    P: Tensor          # (D, 2N)
    W: Tensor          # (2N, 2N)
    diag: Tensor       # (D,)

    @property
    def d(self) -> int:
        return self.P.shape[0]

    def matvec(self, v: Tensor) -> Tensor:
        return self.diag * v + self.P @ (self.W @ (self.P.T @ v))

    def dense(self) -> Tensor:
        return (torch.diag(torch.broadcast_to(self.diag, (self.d,)))
                + self.P @ self.W @ self.P.T)

    def solve(self, rhs: Tensor, jitter: float = 1e-8,
              diag_floor: float = 1e-8) -> Tensor:
        """H^-1 rhs via Woodbury on the diag + low-rank structure."""
        d0 = torch.broadcast_to(self.diag, (self.d,))
        # keep the base invertible; a sign-indefinite W goes to the dense
        # inner solve
        d0 = torch.where(torch.abs(d0) < diag_floor, diag_floor, d0)
        Pd = self.P / d0[:, None]                      # (D, 2N)
        eye = torch.eye(self.W.shape[0], dtype=rhs.dtype, device=rhs.device)
        inner = torch.linalg.inv(self.W + jitter * eye) + self.P.T @ Pd
        y = torch.linalg.solve(inner + jitter * eye, Pd.T @ rhs)
        return rhs / d0 - Pd @ y


def posterior_hessian(spec: KernelSpec, xq: Tensor, f: GramFactors,
                      Z: Tensor) -> HessianOperator:
    """Posterior mean Hessian at a single query point xq (D,) (Eq. 12)."""
    lam = f.lam
    n, d = f.Xt.shape
    lam_vec = torch.broadcast_to(
        torch.as_tensor(lam, dtype=xq.dtype, device=xq.device), (d,))
    if spec.is_stationary:
        Xt = xq[None, :] - f.Xt                       # (N, D), x_q - x_b
        r = torch.clamp_min(torch.sum((Xt * lam) * Xt, dim=-1), 0.0)
        m = torch.sum((Xt * lam) * Z, dim=-1)         # (N,)
        k2, k3 = spec.k2(r), spec.k3(r)
        M = torch.diag(-8.0 * k3 * m)
        Mh = torch.diag(-4.0 * k2)
        diag = lam_vec * torch.sum(-4.0 * k2 * m)
    else:
        xqt = xq if f.c is None else xq - f.c
        Xt = f.Xt                                     # x~_b, centered
        r = torch.sum((Xt * lam) * xqt[None, :], dim=-1)      # r_qb
        w = torch.sum(xqt[None, :] * lam * Z, dim=-1)         # x~_q^T Lam Z_b
        k2, k3 = spec.k2(r), spec.k3(r)
        M = torch.diag(k3 * w)
        Mh = torch.diag(k2)
        diag = torch.zeros((d,), dtype=xq.dtype, device=xq.device)
    P = torch.cat([(Xt * lam).T, (Z * lam).T], dim=1)          # (D, 2N)
    W = torch.cat([torch.cat([M, Mh], dim=1),
                   torch.cat([Mh, torch.zeros_like(M)], dim=1)], dim=0)
    return HessianOperator(P=P, W=W, diag=diag)


def infer_optimum(spec: KernelSpec, f_g: GramFactors, Z: Tensor,
                  x_t: Tensor, g_query: Tensor | None = None) -> Tensor:
    """GP-X: flipped inference of the input where the gradient is g_query.

    Paper Sec. 4.1.2 / Eq. 13: condition a gradient-GP whose *inputs* are
    the observed gradients G (factors f_g built on G) and whose
    *observations* are the displacements X - x_t; the posterior mean at
    g = g_query (default 0) is the step. Z solves the flipped system.
    """
    d = f_g.Xt.shape[1]
    gq = (torch.zeros((1, d), dtype=Z.dtype, device=Z.device)
          if g_query is None else torch.atleast_2d(g_query))
    step = cross_grad_matvec(spec, gq, f_g, Z)[0]
    return x_t + step
