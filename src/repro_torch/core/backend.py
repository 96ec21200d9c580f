"""The O(ND) contraction vocabulary of the solve and query paths.

Counterpart of ``repro/core/backend.py``. Every pass over an (N, D) array
at D ~ 1e6..1e9 is a memory-bound event, so the core modules never spell
those contractions out: they call the three functions below, which go to
the wrappers in ``repro_torch.kernels.ops``. The device of the tensors
decides the route there (CPU: the plain PyTorch version; CUDA: the
hand-written kernel). There is no backend switch.

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
           "fused_factor_build", "gram_update", "fused_gram_mvm"]


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


def fused_factor_build(A: Tensor, B: Tensor, V: Tensor | None, lam, *,
                       v_scale=1.0):
    """The single-sweep factor bundle (P, na, nb, C, tv): P = (A*lam) @ B^T,
    lam-weighted row norms na/nb, C = (V*v_scale) @ A^T, tv =
    rowdots(B, V, lam) -- one read of A, B and V."""
    return _k.fused_factor_build(A, B, V, lam, v_scale=v_scale)


def gram_update(K1: Tensor, small: Tensor, V: Tensor, X: Tensor, lam, *,
                v_scale=None, noise: float = 0.0) -> Tensor:
    """W = (K1 @ (V * v_scale) + small @ X) * lam + noise * V."""
    return _k.gram_update(K1, small, V, X, lam, v_scale=v_scale, noise=noise)


def fused_gram_mvm(K1e: Tensor, K2e: Tensor, Xt: Tensor, V: Tensor, lam, *,
                   stationary: bool, noise: float = 0.0) -> Tensor:
    """The full Alg.-2 Gram MVM as one fused op (paper Eq. 9)."""
    return _k.fused_gram_mvm(K1e, K2e, Xt, V, lam, stationary=stationary,
                             noise=noise)
