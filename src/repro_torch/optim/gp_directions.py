"""GP-H / GP-X step directions (paper Alg. 1).

Counterpart of ``repro/optim/gp_directions.py``. Two API levels:

* ``gph_direction`` / ``gpx_direction`` -- stateless: take the history
  (X, G) as (N, D) matrices and solve from scratch (exact Woodbury, one
  ``build_factor_bundle`` sweep).
* ``gph_direction_state`` / ``gpx_direction_state`` -- incremental: take a
  conditioned ``GPGState`` whose factors and solve ``extend()``/``evict()``
  maintain, so no step refactorizes.

GP-H (Sec. 4.1.1): condition a gradient-GP on (X, G), read off the
posterior-mean Hessian at x_t (Eq. 12, diag + rank-2N) and return
-H^-1 g_t through its factored Woodbury solve.

GP-X (Sec. 4.1.2 / Eq. 13): flip inputs and outputs -- condition a GP
whose inputs are the observed gradients and whose observations are the
displacements X - x_t, then query the posterior mean at g = 0. The step
is x* - x_t. In state form the flipped state extends with (g, x) pairs
and each step re-solves only the right-hand side X - x_t.
"""
from __future__ import annotations

import torch

from repro_torch.core.gram import build_factor_bundle
from repro_torch.core.inference import infer_optimum, posterior_hessian
from repro_torch.core.kernels import get_kernel
from repro_torch.core.woodbury import woodbury_solve

Tensor = torch.Tensor


def gph_direction(X: Tensor, G: Tensor, x_t: Tensor, g_t: Tensor, *,
                  kernel: str = "rbf", lam=1.0, noise: float = 0.0,
                  jitter: float = 1e-8) -> Tensor:
    """Quasi-Newton step -H(x_t)^-1 g_t from the gradient history (X, G)."""
    spec = get_kernel(kernel)
    b = build_factor_bundle(spec, X, G, lam=lam, noise=noise)
    Z = woodbury_solve(spec, b.factors, G, jitter=jitter, bundle=b)
    H = posterior_hessian(spec, x_t, b.factors, Z)
    return -H.solve(g_t, jitter=jitter)


def gpx_direction(X: Tensor, G: Tensor, x_t: Tensor, *, kernel: str = "rbf",
                  lam=1.0, noise: float = 0.0,
                  jitter: float = 1e-8) -> Tensor:
    """Step towards the inferred optimum x*(g = 0) (flipped inference)."""
    spec = get_kernel(kernel)
    dX = X - x_t
    b = build_factor_bundle(spec, G, dX, lam=lam, noise=noise)
    Z = woodbury_solve(spec, b.factors, dX, jitter=jitter, bundle=b)
    return infer_optimum(spec, b.factors, Z, x_t) - x_t


def gph_direction_state(state, x_t: Tensor, g_t: Tensor, *,
                        jitter: float = 1e-8) -> Tensor:
    """GP-H step from an incrementally maintained ``GPGState`` on (X, G):
    the state's cached Z is reused, only the O(ND + N^3) factored Hessian
    solve runs."""
    H = posterior_hessian(state.spec, x_t, state.factors, state.Z)
    return -H.solve(g_t, jitter=jitter)


def gpx_direction_state(state_g, x_t: Tensor) -> Tensor:
    """GP-X step from a FLIPPED ``GPGState`` (inputs = gradients), extended
    with (g, x) pairs: only the new right-hand side X - x_t is re-solved
    against the cached factors."""
    Z = state_g.resolve(state_g.G - x_t)
    return infer_optimum(state_g.spec, state_g.factors, Z, x_t) - x_t


def auto_lengthscale(X: Tensor, factor: float = 10.0) -> Tensor:
    """Isotropic Lambda = 1 / (factor * mean pairwise squared distance), a
    0-d tensor on X's device.

    The paper fixes l^2 = 10 D for the D-dim Rosenbrock (App. F.2); here
    l^2 = factor * mean ||x_a - x_b||^2 over the history.
    """
    sq = torch.sum(X * X, dim=1)
    r = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    n = X.shape[0]
    mean_r = torch.sum(torch.clamp_min(r, 0.0)) / max(n * (n - 1), 1)
    return 1.0 / torch.clamp_min(factor * mean_r, 1e-20)
