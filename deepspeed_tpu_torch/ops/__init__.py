"""Kernel-backed ops of the port: each module holds a CUDA kernel's
wrapper (with its launch counter) and the plain PyTorch version of the
same function.  Kernels build on first use (`_build.py`), never at
import."""
from .evoformer import DS4Sci_EvoformerAttention, evoformer_attention
from .fused_adam8 import fused_adam8_leaf, fused_adam8_leaf_reference
from .sparse_attention import (BigBirdSparsityConfig,
                               BSLongformerSparsityConfig,
                               DenseSparsityConfig, FixedSparsityConfig,
                               LocalSlidingWindowSparsityConfig,
                               SparseSelfAttention, SparsityConfig,
                               VariableSparsityConfig,
                               block_sparse_attention)
from .sparse_flash import (block_sparse_flash_attention,
                           block_sparse_flash_backward,
                           block_sparse_flash_dkv, block_sparse_flash_dq,
                           reverse_gather)

__all__ = ["evoformer_attention", "DS4Sci_EvoformerAttention",
           "fused_adam8_leaf", "fused_adam8_leaf_reference",
           "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
           "SparseSelfAttention", "block_sparse_attention",
           "block_sparse_flash_attention", "block_sparse_flash_backward",
           "block_sparse_flash_dq", "block_sparse_flash_dkv",
           "reverse_gather"]
