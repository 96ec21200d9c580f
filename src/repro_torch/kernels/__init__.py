"""The port's hand-written CUDA kernels (``csrc/``), their wrappers
(``ops``) and their plain PyTorch versions (``ref``)."""
from .ops import (fused_factor_build, fused_gram_mvm, fused_gram_norms,
                  gram_update, launches, reset_launches, skinny_gram,
                  small_matmul)

__all__ = ["fused_factor_build", "fused_gram_mvm", "fused_gram_norms",
           "gram_update", "launches", "reset_launches", "skinny_gram",
           "small_matmul"]
