"""Matrix-free products with the gradient Gram matrix (paper Alg. 2 / Eq. 9).

Counterpart of ``repro/core/mvm.py``. All D-sized objects are (N, D); the
Gram matrix acts on vec(V) with vec(V)[a*D + i] = V[a, i]:

  dot:         W = (K1e @ V + (K2e * M) @ Xt) * lam,      M = (Xt*lam) @ V^T
  stationary:  W = (K1e @ V + (diag(rowsum(Mt)) - Mt) @ X) * lam,
               Mt = K2e * (M - diag(M)[None, :])

Every product runs as ONE ``backend.fused_gram_mvm`` call.
"""
from __future__ import annotations

import torch

from . import backend
from .gram import GramFactors

Tensor = torch.Tensor


def l_op(Q: Tensor) -> Tensor:
    """L(Q) = diag(rowsum(Q)) - Q (paper App. A)."""
    return torch.diag(torch.sum(Q, dim=1)) - Q


def lt_op(M: Tensor) -> Tensor:
    """L^T(M)[a,b] = M[a,a] - M[a,b]."""
    return torch.diagonal(M)[:, None] - M


def gram_matvec(f: GramFactors, V: Tensor, *, stationary: bool) -> Tensor:
    """(grad K grad') vec(V) without materializing the Gram matrix.

    f.Xt is X - c for dot kernels and X for stationary ones.
    """
    return backend.fused_gram_mvm(f.K1e, f.K2e, f.Xt, V, f.lam,
                                  stationary=stationary, noise=f.noise)
