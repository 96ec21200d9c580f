"""Plain PyTorch versions of the port's kernels, plus the Alg.-2 algebra.

Each ``*_ref`` computes the same function as its hand-written CUDA kernel
(``csrc/``) and returns the same shapes as the wrapper in ``ops.py``. They
run in the accumulation dtype of their inputs: bf16/f16 storage is upcast
to f32 (the kernels' bf16-in/f32-accumulate contract), f32 stays f32 and
f64 stays f64, so the CPU tests hold the port against the JAX package at
full precision.

``ops.py`` sends CPU tensors here. On the card the wrappers launch the
kernels instead; ``cuda_calls`` counts the plain versions that were handed
CUDA tensors, so a run can show the main path never took them.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

cuda_calls = {"fused_factor_build": 0, "gram_update": 0, "fused_gram_mvm": 0,
              "skinny_gram": 0, "fused_gram_norms": 0, "small_matmul": 0,
              "fused_gram_mvm_multi": 0}


def _note(name: str, t: Tensor) -> None:
    if t.is_cuda:
        cuda_calls[name] += 1


def acc(x):
    """Accumulation-dtype view: upcast sub-f32 storage, keep f32/f64."""
    if isinstance(x, Tensor) and x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


def _common(*xs):
    """acc() of each operand, then every tensor in their common dtype
    (bf16 streams beside an f64 operand accumulate in f64)."""
    xs = [acc(x) for x in xs]
    dts = [x.dtype for x in xs if isinstance(x, Tensor)]
    dt = dts[0]
    for other in dts[1:]:
        dt = torch.promote_types(dt, other)
    return [x.to(dt) if isinstance(x, Tensor) else x for x in xs]


def fused_factor_build_ref(A: Tensor, B: Tensor, V: Tensor | None, lam,
                           vs=1.0):
    """(P, na, nb, C, tv): the single-sweep factor bundle.

    P = (A*lam) @ B^T (Na, Nb); na (Na,) / nb (Nb,) the lam-weighted row
    norms; C = (V*vs) @ A^T (Nb, Na); tv = rowdots(B, V, lam) (Nb,).
    """
    _note("fused_factor_build", A)
    A, B, V, lam, vs = _common(A, B, B if V is None else V, lam, vs)
    P = (A * lam) @ B.T
    na = torch.sum((A * lam) * A, dim=-1)
    nb = torch.sum((B * lam) * B, dim=-1)
    C = (V * vs) @ A.T
    tv = torch.sum((B * lam) * V, dim=-1)
    return P, na, nb, C, tv


def gram_update_ref(K1: Tensor, M: Tensor, V: Tensor, X: Tensor, lam,
                    v_scale=None, noise: float = 0.0) -> Tensor:
    """W = (K1 @ (V*v_scale) + M @ X) * lam + noise*V."""
    _note("gram_update", V)
    K1, M, V, X, lam, v_scale = _common(K1, M, V, X, lam, v_scale)
    Vs = V if v_scale is None else V * v_scale
    W = (K1 @ Vs + M @ X) * lam
    if noise:
        W = W + noise * V
    return W


def skinny_gram_ref(A: Tensor, B: Tensor, lam) -> Tensor:
    """P = (A*lam) @ B^T (Na, Nb)."""
    _note("skinny_gram", A)
    A, B, lam = _common(A, B, lam)
    return (A * lam) @ B.T


def fused_gram_norms_ref(A: Tensor, B: Tensor, lam):
    """(P, na, nb): P = (A*lam) @ B^T and the lam-weighted row norms
    na (Na,) / nb (Nb,)."""
    _note("fused_gram_norms", A)
    A, B, lam = _common(A, B, lam)
    P = (A * lam) @ B.T
    na = torch.sum((A * lam) * A, dim=-1)
    nb = torch.sum((B * lam) * B, dim=-1)
    return P, na, nb


def small_matmul_ref(K: Tensor, V: Tensor, scale=1.0) -> Tensor:
    """W = (K @ V) * scale."""
    _note("small_matmul", V)
    K, V, scale = _common(K, V, scale)
    return (K @ V) * scale


def small_op(K2e: Tensor, M: Tensor, *, stationary: bool) -> Tensor:
    """The (N, N) Hadamard/L-operator algebra of Alg. 2.

    dot:        small = K2e * M
    stationary: small = diag(rowsum(Mt)) - Mt,  Mt = K2e * (M - diag(M)[None, :])
    """
    if not stationary:
        return K2e * M
    diag_m = torch.diagonal(M, dim1=-2, dim2=-1)
    mt = K2e * (M - diag_m[..., None, :])
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return eye * torch.sum(mt, dim=-1)[..., :, None] - mt


def gram_mvm_oracle(K1e: Tensor, K2e: Tensor, Xt: Tensor, V: Tensor, lam,
                    *, stationary: bool, noise: float = 0.0) -> Tensor:
    """Full Alg.-2 Gram MVM in the inputs' own dtype; V (N, D) or stacked
    (R, N, D), one product per right-hand side."""
    m = (Xt * lam) @ V.transpose(-1, -2)
    small = small_op(K2e, m, stationary=stationary)
    w = (K1e @ V + small @ Xt) * lam
    if noise:
        w = w + noise * V
    return w


def fused_gram_mvm_ref(K1e: Tensor, K2e: Tensor, Xt: Tensor, V: Tensor, lam,
                       *, stationary: bool, noise: float = 0.0) -> Tensor:
    """Alg.-2 Gram MVM in the accumulation dtype (bf16 storage -> f32);
    V (N, D) or stacked (R, N, D)."""
    _note("fused_gram_mvm_multi" if V.ndim == 3 else "fused_gram_mvm", V)
    K1e, K2e, Xt, V, lam = _common(K1e, K2e, Xt, V, lam)
    return gram_mvm_oracle(K1e, K2e, Xt, V, lam, stationary=stationary,
                           noise=noise)
