"""Causal attention entry point of the model code.

Counterpart of `deepspeed_tpu/ops/attention.py`.  `causal_attention` sends
a CUDA tensor to the flash kernels (`ops/flash_attention.py`) and a CPU
tensor to the plain versions; `plain=True` selects the plain versions
explicitly (the engines' `plain_kernels` option, for comparisons on the
card).  It is differentiable: with inputs that require grad, the
backward runs the flash backward kernels.  There is no fallback: a kernel
that cannot take its inputs raises.
"""
from __future__ import annotations

from .flash_attention import flash_attention, flash_attention_reference

__all__ = ["causal_attention", "attention_reference"]


def attention_reference(q, k, v, causal: bool = True):
    """Plain PyTorch attention. q: [B,S,NH,D], k/v: [B,S,NKV,D] ->
    [B,S,NH,D]; softmax in f32."""
    return flash_attention_reference(q, k, v, causal)[0]


def causal_attention(q, k, v, plain: bool = False):
    """Causal attention, q [B,S,NH,D], k/v [B,S,NKV,D]."""
    return flash_attention(q, k, v, causal=True, plain=plain)
