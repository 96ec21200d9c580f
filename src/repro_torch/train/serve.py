"""The batched GP posterior-query serving step (counterpart of
``build_gp_serve_step`` in ``repro/train/serve.py``: means and Hessian
probes).

``GPServeBundle.query(Xq)`` answers a request in fixed-size microbatches
against the CURRENT state revision: each microbatch is one
``fused_factor_build`` sweep plus one ``gram_update`` stream, and no
request ever re-solves. The step runs eagerly, and the last microbatch of
a ragged request is simply shorter: the kernels take any number of rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.paper_gp import GP_SERVE
from repro_torch.core import backend
from repro_torch.core.query import PosteriorBatch, cat_batches, make_query_fn


@dataclasses.dataclass
class GPServeBundle:
    """A batched-query endpoint over a live ``GPGState``.

    ``query(Xq)`` runs ``step`` on each ``microbatch``-row slice of the
    request against the state's current factors (read per call, so
    extend() between requests is seen), with ``probe`` when the step was
    built for Hessian probes.
    """

    state: Any                       # GPGState
    microbatch: int
    step: Callable                   # (factors, Z, chunk[, probe]) -> batch
    probe: Optional[torch.Tensor] = None

    def query(self, Xq: torch.Tensor) -> PosteriorBatch:
        Xq = torch.atleast_2d(Xq)
        b = self.microbatch
        f, Z = self.state.padded_factors, self.state.data.Z
        Xq = Xq.to(f.Xt.dtype)
        extra = () if self.probe is None else (self.probe,)
        chunks = [self.step(f, Z, Xq[i:i + b], *extra)
                  for i in range(0, Xq.shape[0], b)]
        if len(chunks) == 1:  # no copy for a one-microbatch request
            return chunks[0]
        return cat_batches(chunks, self.probe is not None)


def build_gp_serve_step(state, *, microbatch: int | None = None, probe=None,
                        return_std: bool = False,
                        return_grad_std: bool = False,
                        precision: str | None = None,
                        config=None, device=None) -> GPServeBundle:
    """A batched posterior query step for a ``GPGState``: means, and the
    posterior mean Hessian applied to ``probe`` (D,) when one is given.

    ``config`` (a ``repro_torch.configs.GPServeConfig``) supplies the
    ``microbatch`` default and, as in the JAX package, its ``tol`` /
    ``maxiter`` solve knobs are applied to the state: they shape the
    extend-time CG re-solves this bundle's queries are served from.
    Stds and bf16 streams come with later slices.

    ``device`` defaults to ``"cuda"`` (raising without a CUDA device) and
    must be the state's device.
    """
    device = backend.resolve_device(device)
    if device != state.device:
        raise ValueError(f"serve step on {device}, state on {state.device}")
    if config is not None and precision is None:
        precision = config.precision
    if microbatch is None:
        microbatch = (config or GP_SERVE).microbatch
    if config is not None:
        state.tol = float(config.tol)
        state.maxiter = config.maxiter
    if precision is not None:
        state.set_precision(precision)
    fn = make_query_fn(state.spec, with_probe=probe is not None,
                       with_std=return_std, with_grad_std=return_grad_std)
    if probe is not None:
        probe = torch.as_tensor(probe, dtype=state.data.X.dtype,
                                device=state.device)
    return GPServeBundle(state=state, microbatch=int(microbatch), step=fn,
                         probe=probe)
