"""Evoformer attention (MSA row and triangle attention with a mask bias and
a pair bias), forward and backward.

Counterpart of `deepspeed_tpu/ops/evoformer_flash.py`
(`evoformer_flash_forward`, `evoformer_flash_forward_dmajor`,
`evoformer_flash_backward`).  Four hand-written CUDA kernels for sm_90a
(`csrc/evoformer_flash.cu`), bound with ctypes:

- `evoformer_flash_forward`: online softmax over key tiles of
  `s = q.k * scale + b1 + b2`; out [B, N, L, H, D] in q's dtype and, with
  `return_lse`, the lse [B*N, H, L] f32 as the JAX one lays it out.
  `evoformer_flash_forward_dmajor` is the same function under the JAX name
  of its D-major twin (a TPU lane-padding rule with no counterpart here);
- `evoformer_flash_dq`: dq, and delta = rowsum(dO * O) [B*N, H, L] f32
  from `out` as stored, which the other two kernels read;
- `evoformer_flash_dkv`: dk and dv, and with `need_db1` the mask-bias
  gradient db1 as its epilogue (counted on `evoformer_flash_db1`);
  `bwd_variant` names the kernel pair (dq, dk/dv) inputs take on the card
  (warp-specialised TMA + wgmma, mma.sync through registers, or the f32
  CUDA-core pair) and each of the two wrappers counts its launches per
  variant in `launches_by_variant`;
- `evoformer_flash_db2`: the pair-bias gradient, summed over the N rows
  in a fixed order.
`evoformer_flash_backward` runs the three backward kernels.  Nothing
accumulates with float atomics: two runs give the same bits.  db1 and db2
are summed in f32 and written in their bias's dtype.

A row whose every key carries the -1e30 mask gives out 0, a finite lse
(-1e30) and zero gradients; scores at or below -5e29 are re-masked, the
-1e9 mask of AlphaFold-class models is not.

Each has a plain PyTorch version of the same function (`*_reference`, f32
math over the dense [B, N, H, L, L] scores) that runs for tensors on the
CPU; a tensor on a CUDA device takes the kernel or an error.  The kernels
take q/k/v in bf16 (tensor cores) or f32 (CUDA cores), biases in f32 or
bf16, any L, and head dims D % 8 == 0 up to 128; other inputs raise.
"""
from __future__ import annotations

import ctypes
import math
import types
from typing import Optional

import torch

from . import _build

__all__ = ["evoformer_flash_forward", "evoformer_flash_forward_dmajor",
           "evoformer_flash_dq", "evoformer_flash_dkv",
           "evoformer_flash_db2", "evoformer_flash_backward",
           "evoformer_flash_db1", "evoformer_flash_forward_reference",
           "evoformer_flash_dq_reference", "evoformer_flash_dkv_reference",
           "evoformer_flash_db2_reference",
           "evoformer_flash_backward_reference", "bwd_variant",
           "pair_bias_pitch", "BWD_VARIANTS", "NEG_INF"]

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = (_I,) * 6 + (_F, _I, _P)      # B, N, L, H, D, bias dtypes; rest
_WG_SHAPE = (_I,) * 6 + (_F, _I, _P)   # ..., scale, the pair bias's pitch
_FWD_ARGS = (_P,) * 7 + _SHAPE
_DQ_ARGS = (_P,) * 10 + _SHAPE
_DKV_ARGS = (_P,) * 11 + _SHAPE
_DB2_ARGS = (_P,) * 9 + _SHAPE
# each backward pair kernel's C entry points: (mma / f32, wgmma)
_PAIR_ARGS = {"dq": (_DQ_ARGS, (_P,) * 10 + _WG_SHAPE),
              "dkv": (_DKV_ARGS, (_P,) * 11 + _WG_SHAPE)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_DTYPES = (torch.float32, torch.bfloat16)
# the dq and dk/dv kernel pairs: TMA + wgmma (bf16, D 32/64/128),
# mma.sync through registers (bf16, every other D), CUDA cores (f32)
BWD_VARIANTS = ("wgmma", "mma", "f32")
WGMMA_HEAD_DIMS = (32, 64, 128)

# The dk/dv kernel's launches that also computed db1 (its epilogue stands
# for the TPU's separate db1 kernel).
evoformer_flash_db1 = types.SimpleNamespace(__name__="evoformer_flash_db1",
                                            launches=0)


def bwd_variant(dtype, D: int, L: int) -> str:
    """The dq and dk/dv kernel pair that inputs of `dtype`, head dim `D`
    and length `L` take on the card: "f32" for float32 (CUDA cores, exact
    f32 products); for bf16 "wgmma" (warp-specialised TMA + wgmma) at D
    32, 64 and 128, and "mma" (mma.sync through registers) at every other
    D % 8 == 0 up to 128: wgmma contracts D in whole 16-column steps of a
    swizzled row, and D 8 (the extra-MSA width) would run 4x padded.
    Every L takes the same pair (TMA zero-fills the tails; a pair bias
    whose rows TMA cannot address is copied, `pair_bias_pitch`)."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the Evoformer kernels take bf16 "
                        f"or f32")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the Evoformer kernels take "
                         f"D % 8 == 0 and D <= {MAX_HEAD_DIM}")
    if L < 1:
        raise ValueError(f"length {L}")
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if D in WGMMA_HEAD_DIMS else "mma"


def pair_bias_pitch(L: int, dtype) -> int:
    """Elements between rows of the pair bias [B, 1, H, L, L] that the
    wgmma pair reads by TMA, whose rows must start on 16-byte boundaries:
    L where L elements of `dtype` fill whole 16-byte units, else L
    rounded up to one, in a zero-padded copy that the wrappers make and
    count (`pair_bias_copies`)."""
    unit = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-L // unit) * unit


def _scale(scale, D):
    return float(scale if scale is not None else 1.0 / math.sqrt(D))


def _heads(x):
    """[B, N, L, H, D] -> [B, N, H, L, D] f32."""
    return x.float().permute(0, 1, 3, 2, 4)


def _unheads(x, dtype):
    return x.permute(0, 1, 3, 2, 4).to(dtype)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _scores(q, k, b1, b2, scale):
    """f32 scores [B, N, H, L, L]: (q * scale).k + b1 + b2, added in that
    order as the TPU kernels do; and q * scale, k as [B, N, H, L, D]."""
    qh = _heads(q) * scale
    kh = _heads(k)
    s = qh @ kh.transpose(-1, -2)
    if b1 is not None:
        s = s + b1.float()          # [B, N, 1, 1, L] broadcasts
    if b2 is not None:
        s = s + b2.float()          # [B, 1, H, L, L] broadcasts
    return s, qh, kh


def _lse_rows(lse_or_delta, q):
    B, N, L, H, _ = q.shape
    return lse_or_delta.float().reshape(B, N, H, L, 1)


def evoformer_flash_forward_reference(q, k, v, b1=None, b2=None,
                                      scale: Optional[float] = None):
    """Plain PyTorch version of the forward kernel: f32 math.  Returns
    (out [B, N, L, H, D] in q.dtype, lse [B*N, H, L] f32)."""
    B, N, L, H, D = q.shape
    s, _, _ = _scores(q, k, b1, b2, _scale(scale, D))
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-9)
    out = (p @ _heads(v)) / l
    lse = (m + torch.log(l)).reshape(B * N, H, L)
    return _unheads(out, q.dtype), lse


def _delta(out, do):
    """rowsum(dO * O) in f32 from the stored tensors: [B*N, H, L]."""
    B, N, L, H, _ = out.shape
    d = (do.float() * out.float()).sum(-1)              # [B, N, L, H]
    return d.permute(0, 1, 3, 2).reshape(B * N, H, L)


def _probs_ds(q, k, v, b1, b2, do, lse, delta, scale):
    """(P, dS, q * scale, k as f32, dO as f32), each [B, N, H, ...]."""
    s, qh, kh = _scores(q, k, b1, b2, scale)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - _lse_rows(lse, q)), 0.0)
    doh = _heads(do)
    dp = doh @ _heads(v).transpose(-1, -2)
    ds = p * (dp - _lse_rows(delta, q))
    return p, ds, qh, kh, doh


def evoformer_flash_dq_reference(q, k, v, b1, b2, out, do, lse,
                                 scale: Optional[float] = None):
    """Plain PyTorch version of the dq kernel: f32 math.  Returns (dq like
    q, delta [B*N, H, L] f32)."""
    scale = _scale(scale, q.shape[-1])
    delta = _delta(out, do)
    _, ds, _, kh, _ = _probs_ds(q, k, v, b1, b2, do, lse, delta, scale)
    return _unheads((ds @ kh) * scale, q.dtype), delta


def evoformer_flash_dkv_reference(q, k, v, b1, b2, do, lse, delta,
                                  need_db1: bool = True,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the dk/dv kernel: f32 math.  Returns (dk,
    dv like k, db1 [B, N, 1, 1, L] in b1's dtype or None)."""
    scale = _scale(scale, q.shape[-1])
    p, ds, qh, _, doh = _probs_ds(q, k, v, b1, b2, do, lse, delta, scale)
    dk = _unheads(ds.transpose(-1, -2) @ qh, k.dtype)
    dv = _unheads(p.transpose(-1, -2) @ doh, v.dtype)
    db1 = None
    if b1 is not None and need_db1:     # summed over heads and queries
        db1 = ds.sum((2, 3)).reshape(b1.shape).to(b1.dtype)
    return dk, dv, db1


def evoformer_flash_db2_reference(q, k, v, b1, b2, do, lse, delta,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the db2 kernel: f32 math.  Returns db2
    [B, 1, H, L, L] in b2's dtype."""
    scale = _scale(scale, q.shape[-1])
    _, ds, _, _, _ = _probs_ds(q, k, v, b1, b2, do, lse, delta, scale)
    return ds.sum(1, keepdim=True).to(b2.dtype)     # summed over the rows


def evoformer_flash_backward_reference(q, k, v, b1, b2, out, do, lse,
                                       need_db1: bool = True,
                                       need_db2: bool = True,
                                       scale: Optional[float] = None):
    """Plain PyTorch version of `evoformer_flash_backward`: the three
    kernels' plain versions in turn.  Returns (dq, dk, dv, db1, db2);
    db1 / db2 are None when their bias is absent or not asked for."""
    dq, delta = evoformer_flash_dq_reference(q, k, v, b1, b2, out, do, lse,
                                             scale)
    dk, dv, db1 = evoformer_flash_dkv_reference(q, k, v, b1, b2, do, lse,
                                                delta, need_db1, scale)
    db2 = (evoformer_flash_db2_reference(q, k, v, b1, b2, do, lse, delta,
                                         scale)
           if b2 is not None and need_db2 else None)
    return dq, dk, dv, db1, db2


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _not_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"no Evoformer attention kernel for device "
                         f"{t.device}")


def _check(q, k, v, b1, b2, like_q=(), rows=()):
    """Raise, naming the rule, on anything the kernels do not take.
    `like_q`: tensors of q's shape and dtype (out, dO); `rows`: lse/delta
    [B*N, H, L] f32."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the Evoformer kernels take "
                        f"bf16 or f32")
    if q.dim() != 5:
        raise ValueError(f"need q/k/v [B, N, L, H, D], got "
                         f"{tuple(q.shape)}")
    B, N, L, H, D = q.shape
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the Evoformer kernels take "
                         f"D % 8 == 0 and D <= {MAX_HEAD_DIM}")
    for t in (k, v) + tuple(like_q):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("k, v, out and dO must match q's shape, dtype "
                             "and device")
    for name, b, shape in (("mask bias b1", b1, (B, N, 1, 1, L)),
                           ("pair bias b2", b2, (B, 1, H, L, L))):
        if b is None:
            continue
        if tuple(b.shape) != shape or b.dtype not in _BIAS_DTYPES:
            raise ValueError(f"{name} must be {shape} f32 or bf16, got "
                             f"{tuple(b.shape)} {b.dtype}")
        if b.device != q.device:
            raise ValueError(f"{name} must be on q's device")
    for t in rows:
        if (tuple(t.shape) != (B * N, H, L) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"lse and delta must be f32 {(B * N, H, L)} "
                             f"on q's device")
    for t in (q, k, v, b1, b2) + tuple(like_q) + tuple(rows):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("inputs must start on a 16-byte boundary")


def _bias_args(b1, b2):
    """(b1 pointer, b2 pointer, the bias dtype bits) for the C entry
    points: bit 0 b1 bf16, bit 1 b2 bf16."""
    bits = ((b1 is not None and b1.dtype == torch.bfloat16)
            | (b2 is not None and b2.dtype == torch.bfloat16) << 1)
    return (b1.data_ptr() if b1 is not None else None,
            b2.data_ptr() if b2 is not None else None, int(bits))


def _shape_args(q, bias_bits, scale):
    B, N, L, H, D = q.shape
    return (B, N, L, H, D, bias_bits, _scale(scale, D), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _tma_pair_bias(wrapper, b2, L):
    """(the pair bias as the wgmma pair reads it, its row pitch): `b2`
    itself where TMA can address its rows, else a zero-padded copy of
    pitch `pair_bias_pitch` (counted on the wrapper's
    `pair_bias_copies`)."""
    if b2 is None:
        return None, L
    pitch = pair_bias_pitch(L, b2.dtype)
    if pitch == L:
        return b2, L
    padded = b2.new_zeros(b2.shape[:-1] + (pitch,))
    padded[..., :L] = b2
    wrapper.pair_bias_copies += 1
    return padded, pitch


def _run_pair(wrapper, kernel, q, k, v, b1, b2, rest, scale):
    """Launch the dq or dk/dv kernel (`kernel` "dq" or "dkv") of the pair
    that `bwd_variant` names, `rest` being the pointers after the biases;
    count the launch on `wrapper` by variant."""
    B, N, L, H, D = q.shape
    variant = bwd_variant(q.dtype, D, L)
    if variant == "wgmma":
        b2, pitch = _tma_pair_bias(wrapper, b2, L)
    p1, p2, bits = _bias_args(b1, b2)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), p1, p2) + rest
    plain_args, wgmma_args = _PAIR_ARGS[kernel]
    if variant == "wgmma":
        fn = _build.function("evoformer_flash", f"dstt_evo_{kernel}_wgmma",
                             wgmma_args)
        rc = fn(*args, B, N, L, H, D, bits, _scale(scale, D), pitch,
                torch.cuda.current_stream(q.device).cuda_stream)
    else:
        fn = _build.function("evoformer_flash", f"dstt_evo_{kernel}",
                             plain_args)
        rc = fn(*args, *_shape_args(q, bits, scale))
    _build.check(rc, f"Evoformer attention {kernel}")
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


def evoformer_flash_forward(q, k, v, b1=None, b2=None,
                            scale: Optional[float] = None,
                            return_lse: bool = False):
    """q/k/v: [B, N, L, H, D]; b1: [B, N, 1, 1, L] mask bias or None; b2:
    [B, 1, H, L, L] pair bias or None.  Returns out [B, N, L, H, D] in
    q.dtype (with `return_lse` also the lse [B*N, H, L] f32 the backward
    kernels consume)."""
    if q.device.type == "cpu":
        out, lse = evoformer_flash_forward_reference(q, k, v, b1, b2, scale)
        return (out, lse) if return_lse else out
    _not_cuda(q)
    _check(q, k, v, b1, b2)
    B, N, L, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * N, H, L), dtype=torch.float32, device=q.device)
    p1, p2, bits = _bias_args(b1, b2)
    fn = _build.function("evoformer_flash", "dstt_evo_fwd", _FWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p1, p2,
            out.data_ptr(), lse.data_ptr(), *_shape_args(q, bits, scale))
    _build.check(rc, "Evoformer attention")
    evoformer_flash_forward.launches += 1
    return (out, lse) if return_lse else out


# the D-major twin of the TPU forward is the same kernel here
evoformer_flash_forward_dmajor = evoformer_flash_forward


def evoformer_flash_dq(q, k, v, b1, b2, out, do, lse,
                       scale: Optional[float] = None):
    """dq from the forward's residuals and dO.  Returns (dq like q, delta
    = rowsum(dO * O) [B*N, H, L] f32, which `evoformer_flash_dkv` and
    `evoformer_flash_db2` take)."""
    if q.device.type == "cpu":
        return evoformer_flash_dq_reference(q, k, v, b1, b2, out, do, lse,
                                            scale)
    _not_cuda(q)
    _check(q, k, v, b1, b2, (out, do), (lse,))
    B, N, L, H, D = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((B * N, H, L), dtype=torch.float32, device=q.device)
    _run_pair(evoformer_flash_dq, "dq", q, k, v, b1, b2,
              (out.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
               delta.data_ptr()), scale)
    return dq, delta


def evoformer_flash_dkv(q, k, v, b1, b2, do, lse, delta,
                        need_db1: bool = True,
                        scale: Optional[float] = None):
    """dk and dv, and with `need_db1` (and b1 given) the mask-bias
    gradient.  Returns (dk, dv like k, db1 [B, N, 1, 1, L] in b1's dtype
    or None)."""
    if q.device.type == "cpu":
        return evoformer_flash_dkv_reference(q, k, v, b1, b2, do, lse,
                                             delta, need_db1, scale)
    _not_cuda(q)
    _check(q, k, v, b1, b2, (do,), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    db1 = torch.empty_like(b1) if b1 is not None and need_db1 else None
    _run_pair(evoformer_flash_dkv, "dkv", q, k, v, b1, b2,
              (do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dk.data_ptr(), dv.data_ptr(),
               db1.data_ptr() if db1 is not None else None), scale)
    if db1 is not None:
        evoformer_flash_db1.launches += 1
    return dk, dv, db1


def evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta,
                        scale: Optional[float] = None):
    """The pair-bias gradient [B, 1, H, L, L] in b2's dtype: dS summed
    over the N rows."""
    if b2 is None:
        raise ValueError("db2 needs the pair bias b2")
    if q.device.type == "cpu":
        return evoformer_flash_db2_reference(q, k, v, b1, b2, do, lse,
                                             delta, scale)
    _not_cuda(q)
    _check(q, k, v, b1, b2, (do,), (lse, delta))
    db2 = torch.empty_like(b2)
    p1, p2, bits = _bias_args(b1, b2)
    fn = _build.function("evoformer_flash", "dstt_evo_db2", _DB2_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p1, p2, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), db2.data_ptr(),
            *_shape_args(q, bits, scale))
    _build.check(rc, "Evoformer attention db2")
    evoformer_flash_db2.launches += 1
    return db2


def evoformer_flash_backward(q, k, v, b1, b2, out, do, lse,
                             need_db1: bool = True, need_db2: bool = True,
                             scale: Optional[float] = None):
    """Backward of `evoformer_flash_forward`: (dq, dk, dv, db1, db2) from
    q/k/v/out/dO [B, N, L, H, D] and the forward's lse [B*N, H, L] f32;
    db1 / db2 are None when their bias is absent or not asked for."""
    dq, delta = evoformer_flash_dq(q, k, v, b1, b2, out, do, lse, scale)
    dk, dv, db1 = evoformer_flash_dkv(q, k, v, b1, b2, do, lse, delta,
                                      need_db1, scale)
    db2 = (evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta, scale)
           if b2 is not None and need_db2 else None)
    return dq, dk, dv, db1, db2


evoformer_flash_forward.launches = 0
evoformer_flash_dq.launches = 0
evoformer_flash_dkv.launches = 0
evoformer_flash_db2.launches = 0
# launches per kernel pair (BWD_VARIANTS), reset with `launches`; and the
# wgmma launches that read a padded copy of the pair bias
evoformer_flash_dq.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
evoformer_flash_dkv.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
evoformer_flash_dq.pair_bias_copies = 0
evoformer_flash_dkv.pair_bias_copies = 0
