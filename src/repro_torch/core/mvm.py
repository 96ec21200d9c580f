"""Matrix-free products with the gradient Gram matrix (paper Alg. 2 / Eq. 9).

Counterpart of ``repro/core/mvm.py``. All D-sized objects are (N, D); the
Gram matrix acts on vec(V) with vec(V)[a*D + i] = V[a, i]:

  dot:         W = (K1e @ V + (K2e * M) @ Xt) * lam,      M = (Xt*lam) @ V^T
  stationary:  W = (K1e @ V + (diag(rowsum(Mt)) - Mt) @ X) * lam,
               Mt = K2e * (M - diag(M)[None, :])

Every Gram product runs as ONE ``backend.fused_gram_mvm`` call (a stacked
(R, N, D) V as one multi-RHS call). The cross products with query points
take their strips from ``scaled_gram`` / ``pairwise_r`` and their output
from one ``gram_update`` stream.
"""
from __future__ import annotations

import torch

from . import backend
from .gram import GramFactors, pairwise_r, scaled_gram
from .kernels import KernelSpec

Tensor = torch.Tensor


def l_op(Q: Tensor) -> Tensor:
    """L(Q) = diag(rowsum(Q)) - Q (paper App. A); batched over leading
    axes."""
    return torch.diag_embed(torch.sum(Q, dim=-1)) - Q


def lt_op(M: Tensor) -> Tensor:
    """L^T(M)[a,b] = M[a,a] - M[a,b]; batched over leading axes."""
    return torch.diagonal(M, dim1=-2, dim2=-1)[..., :, None] - M


def gram_matvec(f: GramFactors, V: Tensor, *, stationary: bool) -> Tensor:
    """(grad K grad') vec(V) without materializing the Gram matrix.

    f.Xt is X - c for dot kernels and X for stationary ones. A stacked V
    (R, N, D) gives (R, N, D) from one multi-RHS kernel call that streams
    Xt once for all R right-hand sides.
    """
    return backend.fused_gram_mvm(f.K1e, f.K2e, f.Xt, V, f.lam,
                                  stationary=stationary, noise=f.noise)


# The JAX package's name for the stacked form: the same call.
gram_matvec_multi = gram_matvec


def cross_grad_matvec(spec: KernelSpec, Xq: Tensor, f: GramFactors,
                      V: Tensor, lam=None) -> Tensor:
    """Posterior-mean style contraction: sum_b block(q, b) @ V[b].

    Xq: (Nq, D) query points; returns (Nq, D). With V = Z (the Gram solve
    of the observed gradients) this IS the posterior mean of grad f at Xq
    (paper Eq. 26 / App. D).
    """
    lam = f.lam if lam is None else lam
    if spec.is_stationary:
        r = pairwise_r(spec, Xq, f.Xt, lam)
        K1e, K2e = spec.k1e(r), spec.k2e(r)
        # m[q, b] = (x_q - x_b)^T Lam V[b]
        m = scaled_gram(Xq, V, lam) - backend.row_dots(f.Xt, V, lam)[None, :]
        Mt = K2e * m
        W = backend.gram_update(K1e, -Mt, V, f.Xt, lam)
        # W + (Xq * rowsum(Mt)) * lam in one pass over the (Nq, D) arrays
        return torch.addcmul(W, Xq, torch.sum(Mt, dim=1)[:, None] * lam)
    Xqt = Xq if f.c is None else Xq - f.c
    r = scaled_gram(Xqt, f.Xt, lam)
    # row q: sum_b K1e[q,b] Lam V[b] + K2e[q,b] (Lam x~_b) (x~_q . Lam V[b])
    m = scaled_gram(Xqt, V, lam)
    return backend.gram_update(spec.k1e(r), spec.k2e(r) * m, V, f.Xt, lam)


def cross_value_matvec(spec: KernelSpec, Xq: Tensor, f: GramFactors,
                       V: Tensor) -> Tensor:
    """cov(f(Xq), grad f(X)) contracted with V: (Nq,).

    cov(f(x_q), g_b)^j = k'(r) dr/dx_b^j with dr/dx_b = Lam x~_q (dot) or
    -2 Lam (x_q - x_b) (stationary). The posterior mean of the function
    from gradient observations, up to the prior's additive constant.
    """
    lam = f.lam
    if spec.is_stationary:
        r = pairwise_r(spec, Xq, f.Xt, lam)
        m = scaled_gram(Xq, V, lam) - backend.row_dots(f.Xt, V, lam)[None, :]
        return torch.sum(-2.0 * spec.k1(r) * m, dim=1)
    Xqt = Xq if f.c is None else Xq - f.c
    r = scaled_gram(Xqt, f.Xt, lam)
    m = scaled_gram(Xqt, V, lam)
    return torch.sum(spec.k1(r) * m, dim=1)
