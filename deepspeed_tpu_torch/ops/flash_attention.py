"""Causal flash-attention forward.

Counterpart of the forward half of `deepspeed_tpu/ops/flash_attention.py`
(`flash_attention` / `_fwd`).  The kernel is `csrc/flash_fwd.cu`
(hand-written CUDA for sm_90a, bound with ctypes): FlashAttention-2 online
softmax in f32, key tiles past the diagonal skipped, GQA without a KV
repeat, out plus the row logsumexp (kept for the training slice's
backward).  `flash_attention_reference` is the plain PyTorch version of
the same function; `flash_attention` runs it for tensors on the CPU and
the kernel for tensors on a CUDA device.

Layout is the JAX public one: q [B, S, NH, D], k/v [B, S, NKV, D]; lse
[B, NH, S] f32.  On the card S need not be a multiple of any tile (the
TPU gate in `ops/attention.py` has no counterpart here); D is 64 or 128.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, causal: bool = True):
    """Plain PyTorch version: dense scores and softmax in f32.  Returns
    (out [B, S, NH, D] in q.dtype, lse [B, NH, S] f32)."""
    B, S, NH, D = q.shape
    NKV = k.shape[2]
    kk, vv = k.float(), v.float()
    if NKV != NH:
        kk = kk.repeat_interleave(NH // NKV, dim=2)
        vv = vv.repeat_interleave(NH // NKV, dim=2)
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), kk) / math.sqrt(D)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", p, vv)
    return out.to(q.dtype), lse


def _check(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (kernel takes bf16 or f32)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,S,NH,D] and k/v [B,S,NKV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, NH, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError("k/v batch, length and head dim must match q")
    if D not in (64, 128):
        raise ValueError(f"head dim {D} (kernel takes 64 or 128)")
    if NH % k.shape[2]:
        raise ValueError(f"NH={NH} is not a multiple of NKV={k.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """Flash attention over [B, S, N, D] tensors (kv may have fewer
    heads).  Returns out, or (out, lse) with `return_lse`."""
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, causal)
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check(q, k, v)
    B, S, NH, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, NH, S), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_fwd", "dstt_flash_fwd", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, NH, k.shape[2], D, int(bool(causal)),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
