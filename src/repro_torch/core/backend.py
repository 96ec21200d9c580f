"""The O(ND) contraction vocabulary of the solve and query paths.

Counterpart of ``repro/core/backend.py``. Every pass over an (N, D) array
at D ~ 1e6..1e9 is a memory-bound event, so the core modules never spell
those contractions out: they call the functions below, which go to the
wrappers in ``repro_torch.kernels.ops`` (``row_dots`` and the stacked
``kron_precond`` stay plain PyTorch, as the JAX package keeps them
outside Pallas). The device of the tensors decides the route there (CPU:
the plain PyTorch version; CUDA: the hand-written kernel). There is no
backend switch.

Also here: the device policy of the port's entry points and the stream
precision helpers (bf16 storage, f32 accumulation, f32 outputs).
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import ops as _k
from repro_torch.kernels.ref import acc as _acc

Tensor = torch.Tensor

_VALID_PRECISION = ("f32", "bf16")

__all__ = ["resolve_device", "resolve_precision", "stream_dtype", "_acc",
           "scaled_gram", "gram_norms", "fused_factor_build", "pairwise_r",
           "row_dots", "gram_update", "kron_precond", "fused_gram_mvm"]


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``"cuda"`` unless the caller names one.

    Raises when the device is CUDA and no CUDA device is present: the port
    does not carry on on the CPU unless asked to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "present; pass device='cpu' to run the plain PyTorch path")
    return dev


def resolve_precision() -> str:
    """The storage precision streams default to: 'f32' | 'bf16'
    (``REPRO_PRECISION``, default 'f32')."""
    env = os.environ.get("REPRO_PRECISION", "").strip().lower()
    return env if env in _VALID_PRECISION else "f32"


def stream_dtype(precision: str | None = None) -> torch.dtype:
    """The torch dtype of (N, D) stream storage under ``precision``."""
    p = resolve_precision() if precision is None else precision
    if p not in _VALID_PRECISION:
        raise ValueError(
            f"precision must be one of {_VALID_PRECISION}, got {p!r}")
    return torch.bfloat16 if p == "bf16" else torch.float32


def scaled_gram(A: Tensor, B: Tensor, lam) -> Tensor:
    """(N_a, N_b) matrix A Lambda B^T -- the hot contraction of the method."""
    return _k.skinny_gram(A, B, lam)


def gram_norms(A: Tensor, B: Tensor, lam):
    """(P, |A|^2_lam rowwise, |B|^2_lam rowwise) in one read of A and B."""
    return _k.fused_gram_norms(A, B, lam)


def fused_factor_build(A: Tensor, B: Tensor, V: Tensor | None, lam, *,
                       v_scale=1.0):
    """The single-sweep factor bundle (P, na, nb, C, tv): P = (A*lam) @ B^T,
    lam-weighted row norms na/nb, C = (V*v_scale) @ A^T, tv =
    rowdots(B, V, lam) -- one read of A, B and V."""
    return _k.fused_factor_build(A, B, V, lam, v_scale=v_scale)


def pairwise_r(spec, A: Tensor, B: Tensor, lam, c=None) -> Tensor:
    """r(x_a, x_b) for all pairs; A: (Na, D), B: (Nb, D) -> (Na, Nb)."""
    if spec.is_stationary:
        g, da, db = gram_norms(A, B, lam)
        return torch.clamp_min(da[:, None] + db[None, :] - 2.0 * g, 0.0)
    At = A if c is None else A - c
    Bt = B if c is None else B - c
    return scaled_gram(At, Bt, lam)


def row_dots(A: Tensor, B: Tensor, lam) -> Tensor:
    """sum_d A[:, d] * lam[d] * B[:, d] -- one (N,) strip; a single
    elementwise pass with a reduction, so there is no kernel for it."""
    A, B = _acc(A), _acc(B)
    return torch.sum((A * lam) * B, dim=-1)


def gram_update(K1: Tensor, small: Tensor, V: Tensor, X: Tensor, lam, *,
                v_scale=None, noise: float = 0.0) -> Tensor:
    """W = (K1 @ (V * v_scale) + small @ X) * lam + noise * V."""
    return _k.gram_update(K1, small, V, X, lam, v_scale=v_scale, noise=noise)


def kron_precond(K1i: Tensor, V: Tensor, lam) -> Tensor:
    """B^-1 vec(V) for the free Kronecker preconditioner B = K1e x Lam.

    V (N, D) is one ``small_matmul`` pass with the 1/lam scale fused in; a
    stacked (R, N, D) V is a plain batched product. K1i is the (N, N)
    inverse factor.
    """
    if V.ndim == 2:
        return _k.small_matmul(K1i, V, 1.0 / lam)
    return (_acc(K1i) @ _acc(V)) / lam


def fused_gram_mvm(K1e: Tensor, K2e: Tensor, Xt: Tensor, V: Tensor, lam, *,
                   stationary: bool, noise: float = 0.0) -> Tensor:
    """The full Alg.-2 Gram MVM as one fused op (paper Eq. 9); V (N, D) or
    stacked (R, N, D), which streams Xt once for all R."""
    return _k.fused_gram_mvm(K1e, K2e, Xt, V, lam, stationary=stationary,
                             noise=noise)
