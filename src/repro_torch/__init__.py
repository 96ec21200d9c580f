"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It imports torch and numpy, never JAX and nothing of ``repro``. Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, where every kernel wrapper takes its plain PyTorch version.
"""
from .configs import GP_SERVE, GPServeConfig
from .core import (FactorBundle, GPGData, GPGState, GramFactors,
                   HessianOperator, KernelSpec, PosteriorBatch,
                   build_factor_bundle, build_factors, get_kernel, gpg_evict,
                   gpg_extend, gpg_init, gpg_refactor, gpg_resolve,
                   gram_cg_solve, gram_cg_solve_multi, infer_optimum,
                   poly2_quadratic_solve, posterior_batch, posterior_grad,
                   posterior_hessian, posterior_value, woodbury_solve)
from .train import GPServeBundle, build_gp_serve_step

__all__ = ["GP_SERVE", "FactorBundle", "GPGData", "GPGState",
           "GPServeBundle", "GPServeConfig", "GramFactors",
           "HessianOperator", "KernelSpec", "PosteriorBatch",
           "build_factor_bundle", "build_factors", "build_gp_serve_step",
           "get_kernel", "gpg_evict", "gpg_extend", "gpg_init",
           "gpg_refactor", "gpg_resolve", "gram_cg_solve",
           "gram_cg_solve_multi", "infer_optimum", "poly2_quadratic_solve",
           "posterior_batch", "posterior_grad", "posterior_hessian",
           "posterior_value", "woodbury_solve"]
