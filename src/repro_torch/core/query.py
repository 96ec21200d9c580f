"""Batched posterior query serving (factor reuse; zero re-solves).

Counterpart of ``repro/core/query.py`` (means and Hessian probes). Once
a ``GPGState`` (or a plain ``GramFactors`` + solved ``Z``) exists, any number
of posterior queries are cross-covariance contractions against the SAME
cached solve: O(Q N D) for Q query points, no inner system touched again.

Per microbatch the value and grad means come off ONE
``backend.fused_factor_build`` sweep (cross gram, norm strips, cross
contraction and row-dot correction in the same read of Xq/Xt/Z) plus one
``backend.gram_update`` output stream for grad:

  value:    posterior mean of f       (Q,)  -- up to the prior constant
  grad:     posterior mean of grad f  (Q, D) -- paper Eq. 26
  hess_v:   posterior mean Hessian @ probe (Q, D) -- paper Eq. 12, one
            query at a time, so no (Q, D, 2N) factor is ever held

Posterior stds need ``hyper/``, which a later slice ports; asking for
them raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import backend
from .gram import GramFactors
from .inference import posterior_hessian
from .kernels import KernelSpec
from .state import _later

Tensor = torch.Tensor


class PosteriorBatch(NamedTuple):
    """Batched posterior means (and optional stds) at Q query points."""

    value: Tensor                      # (Q,)   mean of f (up to prior const)
    grad: Tensor                       # (Q, D) mean of grad f
    hess_v: Optional[Tensor] = None    # (Q, D) mean Hessian @ probe
    std: Optional[Tensor] = None       # (Q,)   std of f
    grad_std: Optional[Tensor] = None  # (Q, D) std of grad f

    @property
    def q(self) -> int:
        return self.grad.shape[0]


def _mean_chunk(spec: KernelSpec, Xq: Tensor, f: GramFactors, Z: Tensor,
                stream_dt=None):
    """Value + grad posterior means off ONE factor sweep.

    ``stream_dt`` quantizes the Xt/Xq streams to storage precision here;
    stationary coordinates are shifted to the first data row BEFORE
    casting (everything below is translation invariant, and quantizing
    absolute coordinates of clustered data would destroy the r and m
    cancellations). Z is never quantized: it is a solve output.
    """
    if stream_dt is not None and f.Xt.dtype != stream_dt:
        if spec.is_stationary:
            shift = f.Xt[0]
            f = f._replace(Xt=(f.Xt - shift).to(stream_dt))
            Xq = (Xq - shift).to(stream_dt)
        else:
            Xqt0 = Xq if f.c is None else Xq - f.c
            f = f._replace(Xt=f.Xt.to(stream_dt), c=None)
            Xq = Xqt0.to(stream_dt)
    if not spec.is_stationary and f.c is not None:
        Xq = Xq - f.c
        f = f._replace(c=None)
    strips = _mean_strips(Xq, f, Z)
    return _mean_assemble(spec, strips, Xq, f, Z)


def _mean_strips(Xq: Tensor, f: GramFactors, Z: Tensor):
    """The ONE D-touching reduction of the mean path: a fused factor sweep
    returning (P, naq, nbd, C, tz) -- cross gram, both norm strips, cross
    contraction C = (Z*lam) @ Xq^T and the row-dot correction."""
    return backend.fused_factor_build(Xq, f.Xt, Z, f.lam, v_scale=f.lam)


def _mean_assemble(spec: KernelSpec, strips, Xq: Tensor, f: GramFactors,
                   Z: Tensor):
    """Strips -> (value, grad): O(Q N) algebra plus the one output stream
    (and, for stationary kernels, the Xq-proportional term)."""
    lam = f.lam
    if spec.is_stationary:
        P, naq, nbd, C, tz = strips
        r = torch.clamp_min(naq[:, None] + nbd[None, :] - 2.0 * P, 0.0)
        m = C.T - tz[None, :]
        value = torch.sum(-2.0 * spec.k1(r) * m, dim=1)
        Mt = (spec.k2e(r) * m).contiguous()
        W = backend.gram_update(spec.k1e(r).contiguous(), -Mt, Z, f.Xt, lam)
        # W + (Xq * rowsum(Mt)) * lam in one pass over the (Q, D) arrays
        grad = torch.addcmul(W, Xq, torch.sum(Mt, dim=1)[:, None] * lam)
    else:
        P, _, _, C, _ = strips
        m = C.T
        value = torch.sum(spec.k1(P) * m, dim=1)
        grad = backend.gram_update(spec.k1e(P).contiguous(),
                                   (spec.k2e(P) * m).contiguous(), Z, f.Xt,
                                   lam)
    return value, grad


def _query_chunk(spec: KernelSpec, Xq: Tensor, f: GramFactors, Z: Tensor,
                 probe: Optional[Tensor] = None,
                 stream_dt=None) -> PosteriorBatch:
    """One microbatch: fused cross-covariance contractions, no solves.

    The Hessian probe runs on the unquantized Xq and factors; each query's
    (D, 2N) Hessian factor is built, applied and dropped in turn.
    """
    value, grad = _mean_chunk(spec, Xq, f, Z, stream_dt)
    hess_v = None
    if probe is not None:
        hess_v = torch.stack([posterior_hessian(spec, xq, f, Z).matvec(probe)
                              for xq in Xq])
    return PosteriorBatch(value=value, grad=grad, hess_v=hess_v)


def cat_batches(chunks, with_probe: bool) -> PosteriorBatch:
    """One PosteriorBatch from the microbatches of a request."""
    return PosteriorBatch(
        value=torch.cat([c.value for c in chunks]),
        grad=torch.cat([c.grad for c in chunks]),
        hess_v=(torch.cat([c.hess_v for c in chunks]) if with_probe
                else None))


def posterior_batch(
    spec: KernelSpec,
    Xq: Tensor,
    f: GramFactors,
    Z: Tensor,
    *,
    probe: Optional[Tensor] = None,
    microbatch: Optional[int] = None,
    return_std: bool = False,
    return_grad_std: bool = False,
    precision: Optional[str] = None,
) -> PosteriorBatch:
    """Evaluate posterior mean value/grad (and Hessian @ ``probe``) at Xq
    (Q, D).

    ``microbatch`` bounds the per-chunk query count (peak memory
    O(microbatch * N * D)); None evaluates in one chunk. Q queries cost
    O(Q N D) and perform ZERO solves. ``precision='bf16'`` streams Xq/Xt in
    bf16 storage for the means (f32 accumulation and outputs).
    """
    if return_std or return_grad_std:
        raise _later("posterior stds", "the model-selection slice (A7)")
    Xq = torch.atleast_2d(Xq)
    sd = backend.stream_dtype(precision)
    stream_dt = sd if sd != torch.float32 else None
    q = Xq.shape[0]
    if not microbatch or microbatch >= q:
        return _query_chunk(spec, Xq, f, Z, probe, stream_dt)
    chunks = [_query_chunk(spec, Xq[i:i + microbatch], f, Z, probe,
                           stream_dt)
              for i in range(0, q, microbatch)]
    return cat_batches(chunks, probe is not None)


def make_query_fn(spec: KernelSpec, *, with_probe: bool = False,
                  with_std: bool = False, with_grad_std: bool = False):
    """A (f, Z, Xq[, probe]) -> PosteriorBatch evaluator of one microbatch.

    The factors and Z are arguments, not captures, so one function serves
    every state revision (``train/serve.py``). ``with_probe`` is accepted
    for the JAX signature: the evaluator takes ``probe`` either way.
    """
    if with_std or with_grad_std:
        raise _later("posterior stds", "the model-selection slice (A7)")

    def fn(f: GramFactors, Z: Tensor, Xq: Tensor,
           probe: Optional[Tensor] = None) -> PosteriorBatch:
        return _query_chunk(spec, Xq, f, Z, probe)
    return fn
