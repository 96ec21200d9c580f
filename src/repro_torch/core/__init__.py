"""The port's core: kernels, factors, MVM, CG, the incremental state and
batched queries."""
from .gram import GramFactors
from .kernels import KernelSpec, get_kernel, kernel_names
from .query import PosteriorBatch, make_query_fn, posterior_batch
from .solvers import CGResult, cg
from .state import (GPGData, GPGState, gpg_evict, gpg_extend, gpg_init,
                    gpg_resolve)

__all__ = ["CGResult", "GPGData", "GPGState", "GramFactors", "KernelSpec",
           "PosteriorBatch", "cg", "get_kernel", "gpg_evict", "gpg_extend",
           "gpg_init", "gpg_resolve", "kernel_names", "make_query_fn",
           "posterior_batch"]
