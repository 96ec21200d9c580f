"""Structured gradient-Gram-matrix factors (paper Sec. 2.2).

Counterpart of ``repro/core/gram.py`` (``GramFactors`` only in this slice).
Data matrices are stored (N, D): observations on the first axis, the
dimension on the last. Lambda is a scalar or a (D,) diagonal. The DN x DN
Gram matrix is never materialized: (K1e, K2e, Xt, lam) describe it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class GramFactors(NamedTuple):
    """Everything needed to act with the DN x DN gradient Gram matrix.

    K1e/K2e: (N, N) effective first/second kernel-derivative matrices.
    Xt:      (N, D) centered inputs (X - c for dot kernels, X stationary).
    lam:     scalar or (D,) diagonal of Lambda.
    noise:   sigma^2 added to the Gram diagonal.
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
