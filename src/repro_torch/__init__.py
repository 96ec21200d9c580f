"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It imports torch and numpy, never JAX and nothing of ``repro``. Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, where every kernel wrapper takes its plain PyTorch version.
"""
from .configs import GP_SERVE, GPServeConfig
from .core import (GPGData, GPGState, GramFactors, KernelSpec, PosteriorBatch,
                   get_kernel, gpg_evict, gpg_extend, gpg_init, gpg_resolve,
                   posterior_batch)
from .train import GPServeBundle, build_gp_serve_step

__all__ = ["GP_SERVE", "GPGData", "GPGState", "GPServeBundle",
           "GPServeConfig", "GramFactors", "KernelSpec", "PosteriorBatch",
           "build_gp_serve_step", "get_kernel", "gpg_evict", "gpg_extend",
           "gpg_init", "gpg_resolve", "posterior_batch"]
