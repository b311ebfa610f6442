"""Causal attention entry point of the model code.

Counterpart of `deepspeed_tpu/ops/attention.py`.  `causal_attention` sends
a CUDA tensor to the flash kernels (`ops/flash_attention.py`) and a CPU
tensor to the plain versions; `plain=True` selects the plain versions
explicitly (the engines' `plain_kernels` option, for comparisons on the
card).  It is differentiable: with inputs that require grad, the
backward runs the flash backward kernels.  There is no fallback: a kernel
that cannot take its inputs raises.  A score bias (ALiBi) or a sliding
window runs the plain version on the CPU; the flash kernels take
neither, so on a CUDA tensor they raise by name.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import flash_attention, flash_attention_reference

__all__ = ["causal_attention", "attention_reference"]


def attention_reference(q, k, v, causal: bool = True, bias=None,
                        sliding_window=None):
    """Plain PyTorch attention. q: [B,S,NH,D], k/v: [B,S,NKV,D] ->
    [B,S,NH,D]; softmax in f32.  `bias`: an additive score bias
    broadcastable to [B, NH, S, S] (ALiBi); `sliding_window`: keys at or
    before q_pos - window are masked (the reference's arguments)."""
    if bias is None and sliding_window is None:
        return flash_attention_reference(q, k, v, causal)[0]
    NH, S = q.shape[2], q.shape[1]
    kk, vv = k.float(), v.float()
    if k.shape[2] != NH:
        kk = kk.repeat_interleave(NH // k.shape[2], dim=2)
        vv = vv.repeat_interleave(NH // k.shape[2], dim=2)
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), kk) / math.sqrt(
        q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(S, device=q.device)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if sliding_window is not None:
        keep &= pos[None, :] > pos[:, None] - sliding_window
    s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p, vv).to(q.dtype)


def causal_attention(q, k, v, plain: bool = False, bias=None,
                     sliding_window=None):
    """Causal attention, q [B,S,NH,D], k/v [B,S,NKV,D].  With a `bias` or
    a `sliding_window` only the plain version runs, and only on the CPU:
    the flash kernels take neither."""
    if bias is None and sliding_window is None:
        return flash_attention(q, k, v, causal=True, plain=plain)
    if q.device.type != "cpu":
        raise NotImplementedError(
            "attention with an ALiBi bias or a sliding window on "
            f"{q.device}: the PyTorch port's flash kernels take neither "
            "(training these architectures is not carried yet; serving "
            "runs them through the paged kernels)")
    return attention_reference(q, k, v, True, bias, sliding_window)
