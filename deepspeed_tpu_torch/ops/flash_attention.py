"""Causal flash attention, forward and backward.

Counterpart of `deepspeed_tpu/ops/flash_attention.py` (`flash_attention`,
`_fwd`, `_bwd_vjp`).  Hand-written CUDA kernels for sm_90a, bound with
ctypes:

- `flash_attention_fwd` (`csrc/flash_fwd.cu`): FlashAttention-2 online
  softmax in f32, key tiles past the diagonal skipped, GQA without a KV
  repeat; out plus the row logsumexp;
- `flash_attention_bwd_dq` and `flash_attention_bwd_dkv`
  (`csrc/flash_bwd.cu`): the gradient from the forward's residuals
  (q, k, v, out, lse) and dO; dk/dv summed over the GQA group in f32
  inside the kernel.  In bf16 both are TMA + wgmma kernels that read
  delta = rowsum(dO * out) from `flash_attention_bwd_delta` (one launch
  per backward, shared by the two); the f32 kernels compute delta
  themselves.  `bwd_variant` names the kernel a dtype takes, and
  `launches_by_variant` on each wrapper counts its launches per kernel.

Each has a plain PyTorch version of the same function
(`flash_attention_reference`, `flash_attention_bwd_dq_reference`,
`flash_attention_bwd_dkv_reference`, `flash_attention_bwd_delta_reference`,
dense and f32) that runs for tensors on the CPU; a tensor on a CUDA device
takes the kernel or an error.

`flash_attention` is the differentiable entry point: with no input that
requires grad it calls the forward directly (the serving path pays nothing
for autograd); otherwise it runs the `dstt::flash_attention` custom op,
whose backward is the delta and the two backward kernels.  Being one op,
it can be named in a selective-checkpoint policy: the `save_attn` remat
policy (`runtime/activation_checkpointing`) keeps its out and lse and never
reruns the forward kernel.

Layout is the JAX public one: q [B, S, NH, D], k/v [B, S, NKV, D]; lse
and delta [B, NH, S] f32.  On the card S need not be a multiple of any
tile (the TPU gate in `ops/attention.py` has no counterpart here); D is
32, 64, 80, 96 or 128 for the forward (`HEAD_DIMS`), 32, 64 or 128 for
the backward (`BWD_HEAD_DIMS`).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_bwd_delta", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_reference",
           "flash_attention_bwd_delta_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "bwd_variant",
           "BWD_VARIANTS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_DELTA_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_DQ_ARGS = (_P,) * 8 + (_I,) * 7 + (_P,)
_DKV_ARGS = (_P,) * 9 + (_I,) * 7 + (_P,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 96, 128)   # the forward's
BWD_HEAD_DIMS = (32, 64, 128)       # the backward kernels'

# the backward kernels: TMA + wgmma (bf16, reads delta), CUDA cores (f32)
BWD_VARIANTS = ("wgmma", "f32")


def bwd_variant(dtype) -> str:
    """The backward kernel pair that inputs of `dtype` take on the card:
    "wgmma" for bf16 (every head dim, GQA group and length: TMA reads any
    of them), "f32" for float32."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} (the kernels take bf16 or f32)")
    return "wgmma" if dtype == torch.bfloat16 else "f32"


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _dense_probs(q, k, causal):
    """f32 scores of q against k with the kv heads repeated up to NH:
    (s [B, NH, S, S] scaled and masked, k as f32 [B, S, NH, D])."""
    B, S, NH, D = q.shape
    NKV = k.shape[2]
    kk = k.float()
    if NKV != NH:
        kk = kk.repeat_interleave(NH // NKV, dim=2)
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), kk) / math.sqrt(D)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s, kk


def flash_attention_reference(q, k, v, causal: bool = True):
    """Plain PyTorch version: dense scores and softmax in f32.  Returns
    (out [B, S, NH, D] in q.dtype, lse [B, NH, S] f32)."""
    NH, NKV = q.shape[2], k.shape[2]
    s, _ = _dense_probs(q, k, causal)
    vv = v.float()
    if NKV != NH:
        vv = vv.repeat_interleave(NH // NKV, dim=2)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", p, vv)
    return out.to(q.dtype), lse


def flash_attention_bwd_delta_reference(out, do):
    """Plain PyTorch version of the delta kernel: rowsum(dO * out) in f32,
    [B, NH, S]."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_reference(q, k, v, out, lse, do, causal):
    """(dq, dk, dv) of the plain backward, f32 math; dk/dv summed over
    the GQA group."""
    B, S, NH, D = q.shape
    NKV = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s, kk = _dense_probs(q, k, causal)
    vv = v.float()
    if NKV != NH:
        vv = vv.repeat_interleave(NH // NKV, dim=2)
    p = torch.exp(s - lse.float()[..., None])             # [B, NH, S, S]
    dof = do.float()
    delta = (dof * out.float()).sum(-1).transpose(1, 2)    # [B, NH, S]
    dp = torch.einsum("bqnd,bknd->bnqk", dof, vv)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kk) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float()) * scale
    dv = torch.einsum("bnqk,bqnd->bknd", p, dof)
    if NKV != NH:
        dk = dk.reshape(B, S, NKV, NH // NKV, D).sum(3)
        dv = dv.reshape(B, S, NKV, NH // NKV, D).sum(3)
    return dq, dk, dv


def flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                     causal: bool = True):
    """Plain PyTorch version of the dq kernel: dense, f32.  Returns dq
    [B, S, NH, D] in q.dtype."""
    return _bwd_reference(q, k, v, out, lse, do, causal)[0].to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, out, lse, do,
                                      causal: bool = True):
    """Plain PyTorch version of the dk/dv kernel: dense, f32, the GQA
    group summed.  Returns (dk, dv) [B, S, NKV, D] in k.dtype."""
    _, dk, dv = _bwd_reference(q, k, v, out, lse, do, causal)
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _check(q, k, v, *rest):
    """Raise on anything the kernels do not take.  `rest` are the
    backward's (out, lse, do)."""
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
    dims = BWD_HEAD_DIMS if rest else HEAD_DIMS
    if D not in dims:
        raise ValueError(f"head dim {D} (the {'backward' if rest else 'forward'}"
                         f" kernels take {dims})")
    if NH % k.shape[2]:
        raise ValueError(f"NH={NH} is not a multiple of NKV={k.shape[2]}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if rest:
        out, lse, do = rest
        for name, t in (("out", out), ("do", do)):
            if t.shape != q.shape or t.dtype != q.dtype or \
                    t.device != q.device:
                raise ValueError(f"{name} must match q's shape, dtype and "
                                 f"device")
        if lse.shape != (B, NH, S) or lse.dtype != torch.float32 or \
                lse.device != q.device:
            raise ValueError(f"lse must be f32 [B, NH, S] = "
                             f"{(B, NH, S)} on q's device")
        tensors += [("out", out), ("lse", lse), ("do", do)]
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, causal: bool = True):
    """Flash attention forward over [B, S, N, D] tensors (kv may have
    fewer heads).  Returns (out, lse)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check(q, k, v)
    B, S, NH, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, NH, S), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_fwd", "dstt_flash_fwd", _FWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, NH, k.shape[2], D, int(bool(causal)),
            _DTYPES[q.dtype], _stream(q))
    _build.check(rc, "flash attention")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_delta(out, do):
    """delta = rowsum(dO * out) in f32 [B, NH, S] from out and dO
    [B, S, NH, D]: the input the bf16 dq and dk/dv kernels share (one
    launch per backward)."""
    if out.device.type == "cpu":
        return flash_attention_bwd_delta_reference(out, do)
    if out.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device "
                         f"{out.device}")
    if do.shape != out.shape or do.dtype != out.dtype or \
            do.device != out.device:
        raise ValueError("do must match out's shape, dtype and device")
    if out.dtype not in _DTYPES or out.dim() != 4 or \
            out.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"out must be bf16 or f32 [B, S, NH, D] with D in "
                         f"{BWD_HEAD_DIMS}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    for name, t in (("out", out), ("do", do)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    B, S, NH, D = out.shape
    delta = torch.empty((B, NH, S), dtype=torch.float32, device=out.device)
    fn = _build.function("flash_bwd", "dstt_flash_bwd_delta", _DELTA_ARGS)
    rc = fn(out.data_ptr(), do.data_ptr(), delta.data_ptr(), B, S, NH, D,
            _DTYPES[out.dtype], _stream(out))
    _build.check(rc, "flash attention delta")
    flash_attention_bwd_delta.launches += 1
    return delta


def _delta_for(q, out, do, delta):
    """The delta a backward kernel takes: the bf16 kernels read `delta`
    (computed here when the caller has none to share), the f32 ones
    compute their own (None)."""
    if bwd_variant(q.dtype) == "f32":
        return None
    if delta is None:
        return flash_attention_bwd_delta(out, do)
    B, S, NH, _ = q.shape
    if delta.shape != (B, NH, S) or delta.dtype != torch.float32 or \
            delta.device != q.device or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous f32 [B, NH, S] = "
                         f"{(B, NH, S)} on q's device")
    return delta


def _count(wrapper, variant):
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


def flash_attention_bwd_dq(q, k, v, out, lse, do, causal: bool = True,
                           delta=None):
    """dq of flash attention from the forward's residuals and dO (the
    `_bwd_dq_kernel` counterpart).  `delta` is
    `flash_attention_bwd_delta(out, do)` where the caller shares it with
    the dk/dv kernel (None computes it).  Returns dq like q."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                                causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check(q, k, v, out, lse, do)
    delta = _delta_for(q, out, do, delta)
    B, S, NH, D = q.shape
    dq = torch.empty_like(q)
    fn = _build.function("flash_bwd", "dstt_flash_bwd_dq", _DQ_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(),
            None if delta is None else delta.data_ptr(), dq.data_ptr(), B,
            S, NH, k.shape[2], D, int(bool(causal)), _DTYPES[q.dtype],
            _stream(q))
    _build.check(rc, "flash attention dq")
    _count(flash_attention_bwd_dq, bwd_variant(q.dtype))
    return dq


def flash_attention_bwd_dkv(q, k, v, out, lse, do, causal: bool = True,
                            delta=None):
    """dk and dv of flash attention, summed over each kv head's GQA group
    (the `_bwd_dkv_kernel` counterpart); `delta` as for
    `flash_attention_bwd_dq`.  Returns (dk, dv) like k."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, out, lse, do,
                                                 causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check(q, k, v, out, lse, do)
    delta = _delta_for(q, out, do, delta)
    B, S, NH, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.function("flash_bwd", "dstt_flash_bwd_dkv", _DKV_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(),
            None if delta is None else delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, NH, k.shape[2], D, int(bool(causal)),
            _DTYPES[q.dtype], _stream(q))
    _build.check(rc, "flash attention dk/dv")
    _count(flash_attention_bwd_dkv, bwd_variant(q.dtype))
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_delta.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
# launches per kernel (BWD_VARIANTS); a caller resets it with `launches`
flash_attention_bwd_dq.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
flash_attention_bwd_dkv.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)


# ----------------------------------------------------------------------
# the differentiable op
# ----------------------------------------------------------------------
@torch.library.custom_op("dstt::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, plain: bool) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    if plain:
        return flash_attention_reference(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal)


@_flash_op.register_fake
def _(q, k, v, causal, plain):
    B, S, NH, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, NH, S), dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, plain = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.plain = causal, plain


def _flash_backward(ctx, dout, _dlse):
    # lse is a residual, not a model output: its cotangent is dropped, as
    # the JAX custom_vjp never exposes it
    q, k, v, out, lse = ctx.saved_tensors
    do = dout.contiguous()   # autograd may hand over a strided dO
    if ctx.plain:
        dq, dk, dv = _bwd_reference(q, k, v, out, lse, do, ctx.causal)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None)
    # one delta launch for both kernels (None where the f32 pair runs)
    delta = _delta_for(q, out, do, None) if q.device.type == "cuda" else None
    dq = flash_attention_bwd_dq(q, k, v, out, lse, do, ctx.causal, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, do, ctx.causal,
                                     delta)
    return dq, dk, dv, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)

FLASH_OP = torch.ops.dstt.flash_attention.default


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False,
                    plain: bool = False):
    """Flash attention over [B, S, N, D] tensors (kv may have fewer
    heads), differentiable in q, k and v.  Returns out, or (out, lse) with
    `return_lse`.  `plain` selects the plain versions on any device."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _flash_op(q, k, v, bool(causal), bool(plain))
    elif plain:
        out, lse = flash_attention_reference(q, k, v, causal)
    else:
        out, lse = flash_attention_fwd(q, k, v, causal)
    return (out, lse) if return_lse else out
