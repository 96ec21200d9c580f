"""Persistent, incrementally-updatable posterior state (the serving core).

Counterpart of ``repro/core/state.py``:

  ``GPGData``   -- a fixed-capacity NamedTuple holding the zero-padded
                  ``GramFactors`` strips, the bordered Cholesky ``L`` of the
                  N x N matrix K1n = K1e + (s^2/lam) I and the solved
                  representers ``Z``.
  ``gpg_extend``-- appends one (x, grad) observation: one
                  ``fused_factor_build`` sweep for the factor border, an
                  O(N^2) bordered Cholesky update of L and a warm-started
                  preconditioned CG re-solve (one ``fused_gram_mvm`` per
                  iteration).
  ``gpg_evict`` -- drops the oldest observation: a rank-1 Cholesky update
                  restores L in O(N^2).
  ``gpg_refactor`` -- the full O(N^2 D + N^3) rebuild (bulk conditioning
                  through ``GPGState.from_data``, a Lambda refresh).

The functions return new tensors and leave their inputs as they were, as
the JAX functions do. Counters (count, n_solve, ...) are host integers:
PyTorch runs eagerly, so nothing needs them on the device.

Masking convention: arrays are padded to ``capacity`` rows; rows >= count
are zero (L carries an identity tail), so every contraction is exact on the
padded arrays.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import backend
from .gram import GramFactors
from .kernels import KernelSpec, get_kernel
from .mvm import gram_matvec
from .solvers import cg

Tensor = torch.Tensor

_TINY = 1e-30


def _later(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_} of the port "
        f"(ROADMAP.md, queue A)")


class GPGData(NamedTuple):
    """Posterior state (fixed capacity, zero-padded).

    X/G:    (cap, D) raw inputs / observed gradients (rows >= count are 0).
    Xt:     (cap, D) centered inputs (X - c for dot kernels, X stationary).
    K1e/K2e:(cap, cap) effective kernel-derivative strips, zero-padded.
    L:      (cap, cap) lower Cholesky of K1n = K1e + (noise/lam + jitter) I
            on the valid block, identity on the tail.
    Z:      (cap, D) representers solving (grad K grad') vec(Z) = vec(rhs).
    lam:    0-d or (D,) Lambda diagonal, on the state's device.
    count:  valid row count; n_refactor/n_solve: lifetime op counters;
    cg_iters/resnorm: stats of the most recent solve.
    """

    X: Tensor
    G: Tensor
    Xt: Tensor
    K1e: Tensor
    K2e: Tensor
    L: Tensor
    Z: Tensor
    lam: Tensor
    count: int
    n_refactor: int
    n_solve: int
    cg_iters: int
    resnorm: float
    c: Optional[Tensor] = None

    @property
    def capacity(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]


def _row_mask(data: GPGData) -> Tensor:
    return torch.arange(data.capacity, device=data.X.device) < data.count


def _diag_shift(lam: Tensor, noise: float, jitter: float):
    """(noise/lam + jitter) -- the scalar added to K1e's valid diagonal."""
    if noise and lam.ndim != 0:
        raise ValueError("noise > 0 requires scalar Lambda (as in woodbury)")
    return (noise / lam if noise else 0.0) + jitter


def gpg_init(spec: KernelSpec, d: int, capacity: int, *, lam=1.0,
             c: Optional[Tensor] = None, dtype=None,
             device=None) -> GPGData:
    """Empty state with room for ``capacity`` gradient observations."""
    device = backend.resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    cap = int(capacity)
    zmat = torch.zeros((cap, d), dtype=dtype, device=device)
    znn = torch.zeros((cap, cap), dtype=dtype, device=device)
    center = None
    if not spec.is_stationary and c is not None:
        center = torch.as_tensor(c, dtype=dtype, device=device)
    return GPGData(
        X=zmat, G=zmat.clone(), Xt=zmat.clone(), K1e=znn, K2e=znn.clone(),
        L=torch.eye(cap, dtype=dtype, device=device), Z=zmat.clone(),
        lam=torch.as_tensor(lam, dtype=dtype, device=device),
        count=0, n_refactor=0, n_solve=0, cg_iters=0, resnorm=0.0, c=center,
    )


# ---------------------------------------------------------------------------
# Internals: border rows, Cholesky surgery, the masked solve
# ---------------------------------------------------------------------------

def _border(spec: KernelSpec, data: GPGData, x: Tensor):
    """New factor border (xt_new, k1_col, k2_col, r_self): ONE
    ``fused_factor_build`` sweep of the stored (cap, D) strip emits the
    border gram column, both norm strips and the new point's self-dot."""
    mask = _row_mask(data)
    xt_new = x if (spec.is_stationary or data.c is None) else x - data.c
    P, na, nb, _, _ = backend.fused_factor_build(data.Xt, xt_new[None], None,
                                                 data.lam)
    if spec.is_stationary:
        r_col = torch.clamp_min(na + nb[0] - 2.0 * P[:, 0], 0.0)
        r_self = torch.zeros((), dtype=x.dtype, device=x.device)
    else:
        r_col = P[:, 0]
        r_self = nb[0]
    k1_col = torch.where(mask, spec.k1e(r_col), 0.0)
    k2_col = torch.where(mask, spec.k2e(r_col), 0.0)
    return xt_new, k1_col, k2_col, r_self


def _full_chol(data: GPGData, noise: float, jitter: float) -> Tensor:
    """O(N^3) Cholesky of the masked K1n (identity tail); the fallback."""
    mask = _row_mask(data)
    shift = torch.as_tensor(_diag_shift(data.lam, noise, jitter),
                            dtype=data.K1e.dtype, device=data.K1e.device)
    K1n = data.K1e + torch.diag(torch.where(mask, shift, 1.0))
    L, info = torch.linalg.cholesky_ex(K1n)
    if int(info) == 0 and bool(torch.isfinite(L).all()):
        return L
    # last-resort regularization if K1n lost positive-definiteness to
    # roundoff (near-duplicate observations): retry with a scaled jitter
    tr = torch.trace(K1n) / max(data.count, 1)
    return torch.linalg.cholesky(
        K1n + torch.diag(torch.where(mask, 1e-6 * tr, 0.0)))


def _chol_append(L: Tensor, k_col: Tensor, kappa: Tensor, n: int,
                 deg_thresh: float):
    """Bordered Cholesky: O(N^2) append of row n.
    Returns (L', degraded, pivot2).

    k_col must be zero at rows >= n (and L identity there), so the
    triangular solve is exact on the padded arrays.
    """
    l = torch.linalg.solve_triangular(L, k_col[:, None], upper=False)[:, 0]
    pivot2 = kappa - torch.dot(l, l)
    degraded = bool(pivot2 <= deg_thresh * torch.clamp_min(kappa, _TINY))
    row = torch.where(torch.arange(L.shape[0], device=L.device) < n, l, 0.0)
    row[n] = torch.sqrt(torch.clamp_min(pivot2, _TINY))
    L = L.clone()
    L[n] = row
    return L, degraded, pivot2


def _chol_rank1_update(L: Tensor, v: Tensor) -> Tensor:
    """chol(L L^T + v v^T) in O(N^2); identity-tail/zero-v rows are no-ops."""
    cap = L.shape[0]
    idx = torch.arange(cap, device=L.device)
    L = L.clone()
    for k in range(cap):
        Lkk, vk = L[k, k], v[k]
        r = torch.sqrt(Lkk * Lkk + vk * vk)
        cos = r / torch.clamp_min(Lkk, _TINY)
        sin = vk / torch.clamp_min(Lkk, _TINY)
        below = idx > k
        col = L[:, k]
        new_col = torch.where(below, (col + sin * v) / cos, col)
        new_col[k] = r
        v = torch.where(below, cos * v - sin * new_col, v)
        L[:, k] = new_col
    return L


def _solve(spec: KernelSpec, data: GPGData, rhs: Tensor, z0: Tensor, *,
           noise: float, tol: float, maxiter: int) -> GPGData:
    """Warm-started preconditioned CG on the masked padded Gram system.

    The preconditioner is the free Kronecker factor B = K1n x Lam, applied
    as one ``backend.kron_precond`` pass (K1n^-1 formed once per solve from
    the cached Cholesky, 1/lam fused into the same pass), plus ONE fused
    Gram MVM per iteration.
    """
    mask = _row_mask(data)[:, None]
    f = GramFactors(K1e=data.K1e, K2e=data.K2e,
                    Xt=torch.where(mask, data.Xt, 0.0), lam=data.lam,
                    noise=float(noise), c=data.c)
    mv = lambda V: gram_matvec(f, V, stationary=spec.is_stationary)
    K1n_inv = torch.cholesky_inverse(data.L).contiguous()
    M_inv = lambda V: backend.kron_precond(K1n_inv, V, data.lam)
    res = cg(mv, torch.where(mask, rhs, 0.0), x0=torch.where(mask, z0, 0.0),
             tol=tol, maxiter=maxiter, M_inv=M_inv)
    Z = torch.where(mask & torch.isfinite(res.x), res.x, 0.0)
    return data._replace(Z=Z, n_solve=data.n_solve + 1, cg_iters=res.iters,
                         resnorm=res.resnorm)


def _default_maxiter(data: GPGData, maxiter: Optional[int], *,
                     cond: Optional[float] = None,
                     tol: float = 1e-10) -> int:
    """Iteration budget for the warm-started CG re-solve.

    An explicit ``maxiter`` always wins. Otherwise the budget is the CG
    bound iters ~ sqrt(kappa) * log(2/tol) / 2 at a condition estimate
    ``cond``, clamped between a warm-start floor and the ``10 * capacity +
    50`` ceiling; without an estimate the ceiling is the budget.
    """
    if maxiter is not None:
        return int(maxiter)
    cap = data.capacity
    ceiling = 10 * cap + 50
    if cond is None or not math.isfinite(cond) or cond <= 1.0:
        return ceiling
    need = 0.5 * math.sqrt(cond) * math.log(2.0 / max(float(tol), 1e-300))
    return int(min(ceiling, max(cap // 2 + 16, math.ceil(need))))


# ---------------------------------------------------------------------------
# The public functional API
# ---------------------------------------------------------------------------

def gpg_extend(
    spec: KernelSpec,
    data: GPGData,
    x: Tensor,
    g: Tensor,
    *,
    noise: float = 0.0,
    jitter: float = 1e-10,
    deg_thresh: float = 1e-8,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    solve: bool = True,
    rhs: Optional[Tensor] = None,
) -> GPGData:
    """Append one (x, grad) observation with a bordered factor update.

    Requires count < capacity. ``rhs`` overrides the right-hand side of the
    re-solve (flipped GP-X inference); default G.
    """
    n = data.count
    if n >= data.capacity:
        raise ValueError(f"state is full (capacity {data.capacity})")
    x = torch.as_tensor(x, dtype=data.X.dtype, device=data.X.device)
    g = torch.as_tensor(g, dtype=data.X.dtype, device=data.X.device)
    xt_new, k1_col, k2_col, r_self = _border(spec, data, x)
    k1_diag = spec.k1e(r_self)
    shift = _diag_shift(data.lam, noise, jitter)

    K1e = data.K1e.clone()
    K1e[n, :] = k1_col
    K1e[:, n] = k1_col
    K1e[n, n] = k1_diag
    K2e = data.K2e.clone()
    K2e[n, :] = k2_col
    K2e[:, n] = k2_col
    K2e[n, n] = spec.k2e(r_self)
    X, G, Xt = data.X.clone(), data.G.clone(), data.Xt.clone()
    X[n], G[n], Xt[n] = x, g, xt_new
    data = data._replace(X=X, G=G, Xt=Xt, K1e=K1e, K2e=K2e, count=n + 1)

    L_new, degraded, _ = _chol_append(data.L, k1_col, k1_diag + shift, n,
                                      deg_thresh)
    if degraded:
        data = data._replace(L=_full_chol(data, noise, jitter),
                             n_refactor=data.n_refactor + 1)
    else:
        data = data._replace(L=L_new)
    if solve:
        data = _solve(spec, data, data.G if rhs is None else rhs, data.Z,
                      noise=noise, tol=tol,
                      maxiter=_default_maxiter(data, maxiter))
    return data


def gpg_evict(
    spec: KernelSpec,
    data: GPGData,
    *,
    noise: float = 0.0,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    solve: bool = True,
) -> GPGData:
    """Drop the OLDEST observation (sliding window) in O(N^2 + N D).

    Removing row 0 of K1n = L L^T leaves L21 L21^T + L22 L22^T, whose
    Cholesky is a rank-1 *update* of L22 -- no downdate ever occurs.
    """
    n = data.count
    cap = data.capacity
    keep = torch.arange(cap, device=data.X.device) < max(n - 1, 0)
    km = keep[:, None]
    kmm = keep[:, None] & keep[None, :]

    def up(A):  # shift rows up by one, zeroing the vacated tail
        return torch.where(km, torch.roll(A, -1, dims=0), 0.0)

    def upleft(A):
        return torch.where(kmm, torch.roll(A, (-1, -1), dims=(0, 1)), 0.0)

    Ls = upleft(data.L) + torch.diag(torch.where(keep, 0.0, 1.0).to(
        data.L.dtype))
    v = torch.where(keep, torch.roll(data.L[:, 0], -1), 0.0)
    data = data._replace(
        X=up(data.X), G=up(data.G), Xt=up(data.Xt), Z=up(data.Z),
        K1e=upleft(data.K1e), K2e=upleft(data.K2e),
        L=_chol_rank1_update(Ls, v),
        count=max(n - 1, 0),
    )
    if solve:
        data = _solve(spec, data, data.G, data.Z, noise=noise, tol=tol,
                      maxiter=_default_maxiter(data, maxiter))
    return data


def gpg_refactor(
    spec: KernelSpec,
    data: GPGData,
    lam=None,
    *,
    noise: float = 0.0,
    jitter: float = 1e-10,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    solve: bool = True,
    rhs: Optional[Tensor] = None,
) -> GPGData:
    """Full O(N^2 D + N^3) rebuild of factors + Cholesky (+ solve).

    The explicit refactorization entry point: a Lambda refresh and bulk
    conditioning (``GPGState.from_data``) land here. One ``pairwise_r``
    pass over the masked strip, never O(N^6).
    """
    if lam is not None:
        data = data._replace(lam=torch.as_tensor(lam, dtype=data.X.dtype,
                                                 device=data.X.device))
    mask = _row_mask(data)
    mm = mask[:, None] & mask[None, :]
    Xt = data.X if (spec.is_stationary or data.c is None) else \
        data.X - data.c
    Xt = torch.where(mask[:, None], Xt, 0.0)
    r = backend.pairwise_r(spec, Xt, Xt, data.lam)
    data = data._replace(
        Xt=Xt,
        K1e=torch.where(mm, spec.k1e(r), 0.0),
        K2e=torch.where(mm, spec.k2e(r), 0.0),
        n_refactor=data.n_refactor + 1,
    )
    data = data._replace(L=_full_chol(data, noise, jitter))
    if solve:
        data = _solve(spec, data, data.G if rhs is None else rhs, data.Z,
                      noise=noise, tol=tol,
                      maxiter=_default_maxiter(data, maxiter))
    return data


def gpg_resolve(
    spec: KernelSpec,
    data: GPGData,
    rhs: Tensor,
    *,
    noise: float = 0.0,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
) -> GPGData:
    """Re-solve against a NEW right-hand side, reusing factors + Cholesky."""
    return _solve(spec, data, rhs, data.Z, noise=noise, tol=tol,
                  maxiter=_default_maxiter(data, maxiter))


# ---------------------------------------------------------------------------
# Host-facing wrapper: sliding-window / growth policy + bookkeeping
# ---------------------------------------------------------------------------

class GPGState:
    """A conditioned gradient-GP posterior you can stream observations into.

    >>> st = GPGState("rbf", d=32, window=8, lam=1.0 / 32, noise=1e-8)
    >>> st.extend(x, g)          # O(N^2 D) bordered update, warm CG re-solve
    >>> pb = st.posterior(Xq)    # batched queries, zero re-solves

    ``window=m`` serves from a bounded sliding window (extend auto-evicts
    the oldest observation); ``window=None`` grows capacity geometrically
    (a pure zero-pad). ``device`` defaults to ``"cuda"``; without a CUDA
    device the constructor raises unless ``device="cpu"`` is given. On the
    card the state is float32.
    """

    def __init__(
        self,
        kernel: str | KernelSpec = "rbf",
        d: int | None = None,
        *,
        capacity: int = 8,
        window: int | None = None,
        lam=1.0,
        noise: float = 0.0,
        signal: float = 1.0,
        c=None,
        jitter: float = 1e-10,
        deg_thresh: float = 1e-8,
        tol: float = 1e-10,
        maxiter: int | None = None,
        dtype=None,
        precision: str | None = None,
        policy=None,
        device=None,
    ):
        if d is None:
            raise TypeError("GPGState needs the input dimension d")
        self.device = backend.resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        if self.device.type == "cuda" and dtype != torch.float32:
            raise ValueError("on the card the state is float32, got "
                             f"{dtype}")
        self.precision = (backend.resolve_precision() if precision is None
                          else precision)
        backend.stream_dtype(self.precision)  # validate early
        if self.precision != "f32":
            raise _later("bf16 stream storage", "the bf16-stream slice (A5)")
        if policy not in (None, "evict"):
            raise _later(f"the regime policy {policy!r}",
                         "the large-N regime slice (A9)")
        self.spec = get_kernel(kernel) if isinstance(kernel, str) else kernel
        self.noise = float(noise)
        self.signal = float(signal)
        self.jitter = float(jitter)
        self.deg_thresh = float(deg_thresh)
        self.tol = float(tol)
        self.maxiter = maxiter
        self.window = int(window) if window else None
        cap = self.window if self.window else int(capacity)
        self.data = gpg_init(self.spec, int(d), cap, lam=lam, c=c,
                             dtype=dtype, device=self.device)

    # -- streaming updates -------------------------------------------------

    @property
    def _noise_eff(self) -> float:
        """sigma^2 / s^2 -- the noise the UNSCALED Gram solves see."""
        return self.noise / self.signal

    def extend(self, x: Tensor, g: Tensor, *, solve: bool = True
               ) -> "GPGState":
        """Append one observation; a full window evicts the oldest first,
        a full capacity without a window zero-pad-grows."""
        if self.window and self.n >= self.window:
            self.data = gpg_evict(self.spec, self.data,
                                  noise=self._noise_eff, solve=False)
        if self.n >= self.data.capacity:
            self._grow()
        self.data = gpg_extend(
            self.spec, self.data, x, g, noise=self._noise_eff,
            jitter=self.jitter, deg_thresh=self.deg_thresh, tol=self.tol,
            maxiter=self.maxiter, solve=solve)
        self._check_finite()
        return self

    def _check_finite(self) -> None:
        """Healing non-finite factors (the jitter ladder) waits for the
        resilience slice; until then a non-finite state raises."""
        n = self.n
        pivot = float(self.data.L[n - 1, n - 1]) if n else 0.0
        if not (math.isfinite(pivot) and math.isfinite(self.data.resnorm)):
            raise _later("healing a non-finite factorization",
                         "the resilience slice (A12)")

    def evict(self, k: int = 1) -> "GPGState":
        """Drop the k oldest observations (one re-solve at the end)."""
        for i in range(k):
            self.data = gpg_evict(self.spec, self.data,
                                  noise=self._noise_eff, tol=self.tol,
                                  maxiter=self.maxiter,
                                  solve=(i == k - 1))
        return self

    def resolve(self, rhs: Tensor) -> Tensor:
        """Solve for a new RHS with cached factors; returns trimmed Z."""
        full = torch.zeros_like(self.data.G)
        full[: rhs.shape[0]] = torch.as_tensor(rhs, dtype=full.dtype,
                                               device=full.device)
        self.data = gpg_resolve(self.spec, self.data, full,
                                noise=self._noise_eff, tol=self.tol,
                                maxiter=self.maxiter)
        return self.Z

    def _grow(self):
        """Double capacity by zero-padding -- exact, no refactorization."""
        d0 = self.data
        cap = d0.capacity
        pad_r = lambda A: torch.cat([A, torch.zeros_like(A)], dim=0)

        def pad_nn(A):
            out = A.new_zeros((2 * cap, 2 * cap))
            out[:cap, :cap] = A
            return out

        L = pad_nn(d0.L)
        L[cap:, cap:] = torch.eye(cap, dtype=L.dtype, device=L.device)
        self.data = d0._replace(
            X=pad_r(d0.X), G=pad_r(d0.G), Xt=pad_r(d0.Xt), Z=pad_r(d0.Z),
            K1e=pad_nn(d0.K1e), K2e=pad_nn(d0.K2e), L=L)

    @classmethod
    def from_data(cls, kernel, X: Tensor, G: Tensor, **kw) -> "GPGState":
        """Bulk-condition on (X, G) with ONE solve (then stream via extend).

        Keywords go to the constructor; ``device`` defaults to ``"cuda"``
        as there.
        """
        X = torch.atleast_2d(torch.as_tensor(X))
        n, d = X.shape
        kw.setdefault("capacity", max(n, 1))
        st = cls(kernel, d, **kw)
        if st.window and n > st.window:
            raise ValueError(f"{n} observations exceed window={st.window}")
        if n > st.data.capacity:
            raise ValueError(f"{n} observations exceed "
                             f"capacity={st.data.capacity}")
        Xp = torch.zeros_like(st.data.X)
        Gp = torch.zeros_like(st.data.G)
        Xp[:n] = X
        Gp[:n] = torch.as_tensor(G)
        st.data = st.data._replace(X=Xp, G=Gp, count=n)
        st.data = gpg_refactor(st.spec, st.data, noise=st._noise_eff,
                               jitter=st.jitter, tol=st.tol,
                               maxiter=st.maxiter)
        return st

    def refactor(self, lam=None) -> "GPGState":
        """Explicit full refactorization (e.g. after a Lambda refresh)."""
        self.data = gpg_refactor(self.spec, self.data, lam,
                                 noise=self._noise_eff, jitter=self.jitter,
                                 tol=self.tol, maxiter=self.maxiter)
        return self

    # -- branches of the JAX state that later slices port ------------------

    def mll(self, **kw):
        raise _later("GPGState.mll", "the model-selection slice (A7)")

    def refit(self, **kw):
        raise _later("GPGState.refit", "the model-selection slice (A7)")

    def set_precision(self, precision: str) -> "GPGState":
        backend.stream_dtype(precision)  # validate
        if precision != "f32":
            raise _later("bf16 stream storage", "the bf16-stream slice (A5)")
        return self

    # -- views -------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.data.count

    @property
    def d(self) -> int:
        return self.data.d

    @property
    def X(self) -> Tensor:
        return self.data.X[: self.n]

    @property
    def G(self) -> Tensor:
        return self.data.G[: self.n]

    @property
    def Z(self) -> Tensor:
        return self.data.Z[: self.n]

    @property
    def factors(self) -> GramFactors:
        """GramFactors trimmed to the valid rows."""
        k = self.n
        return GramFactors(K1e=self.data.K1e[:k, :k],
                           K2e=self.data.K2e[:k, :k],
                           Xt=self.data.Xt[:k], lam=self.data.lam,
                           noise=self._noise_eff, c=self.data.c)

    @property
    def padded_factors(self) -> GramFactors:
        """Fixed-capacity GramFactors views (shape-stable across extend()).

        The zero rows are exact for the cross-covariance query paths: every
        padded kernel coefficient multiplies a zero Z/Xt row.
        """
        d = self.data
        return GramFactors(K1e=d.K1e, K2e=d.K2e, Xt=d.Xt, lam=d.lam,
                           noise=self._noise_eff, c=d.c)

    @property
    def stats(self) -> dict:
        return {
            "n": self.n,
            "n_refactor": self.data.n_refactor,
            "n_solve": self.data.n_solve,
            "cg_iters": self.data.cg_iters,
            "resnorm": self.data.resnorm,
        }

    def posterior(self, Xq: Tensor, *, probe: Tensor | None = None,
                  microbatch: int | None = None, return_std: bool = False,
                  return_grad_std: bool = False):
        """Batched posterior means against the cached solve (zero
        re-solves); see :func:`repro_torch.core.query.posterior_batch`."""
        from .query import posterior_batch

        k = self.n
        f = self.factors
        return posterior_batch(self.spec, torch.atleast_2d(Xq), f,
                               self.data.Z[:k], probe=probe,
                               microbatch=microbatch, return_std=return_std,
                               return_grad_std=return_grad_std,
                               precision=self.precision)

    def __repr__(self):
        s = self.stats
        return (f"GPGState(kernel={self.spec.name!r}, n={s['n']}, "
                f"d={self.d}, window={self.window}, "
                f"solves={s['n_solve']}, refactors={s['n_refactor']}, "
                f"device={self.device})")
