"""The port's core: kernels, factors, MVMs, the exact and iterative solves,
posterior inference, the incremental state and batched queries."""
from . import backend
from .backend import resolve_precision, stream_dtype
from .gram import (FactorBundle, GramFactors, build_factor_bundle,
                   build_factors, dense_cross_gram, dense_gram, pairwise_r,
                   scaled_gram)
from .inference import (HessianOperator, infer_optimum, posterior_grad,
                        posterior_hessian, posterior_value)
from .kernels import KernelSpec, get_kernel, kernel_names
from .mvm import (cross_grad_matvec, cross_value_matvec, gram_matvec,
                  gram_matvec_multi, l_op, lt_op)
from .query import PosteriorBatch, make_query_fn, posterior_batch
from .solvers import CGResult, cg, gram_cg_solve, gram_cg_solve_multi
from .state import (GPGData, GPGState, gpg_evict, gpg_extend, gpg_init,
                    gpg_refactor, gpg_resolve)
from .woodbury import dense_solve, poly2_quadratic_solve, woodbury_solve

__all__ = [
    "FactorBundle", "GramFactors", "backend", "build_factor_bundle",
    "build_factors", "dense_gram", "dense_cross_gram", "pairwise_r",
    "scaled_gram", "HessianOperator", "infer_optimum", "posterior_grad",
    "posterior_hessian", "posterior_value", "KernelSpec", "get_kernel",
    "kernel_names", "cross_grad_matvec", "cross_value_matvec",
    "gram_matvec", "gram_matvec_multi", "l_op", "lt_op", "CGResult", "cg",
    "gram_cg_solve", "gram_cg_solve_multi", "resolve_precision",
    "stream_dtype", "dense_solve", "poly2_quadratic_solve", "woodbury_solve",
    "GPGData", "GPGState", "gpg_evict", "gpg_extend", "gpg_init",
    "gpg_refactor", "gpg_resolve", "PosteriorBatch", "make_query_fn",
    "posterior_batch",
]
