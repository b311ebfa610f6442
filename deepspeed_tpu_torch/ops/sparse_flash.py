"""Block-sparse flash attention, forward and backward, over a gather table.

Counterpart of `deepspeed_tpu/ops/sparse_flash.py`
(`block_sparse_flash_attention`, `block_sparse_flash_backward`,
`reverse_gather`).  Three hand-written CUDA kernels for sm_90a
(`csrc/sparse_flash.cu`), bound with ctypes:

- `block_sparse_flash_attention`: one CTA per (batch, head, q-block)
  walks its row of the gather table `kb_idx [H, nqb, A]` (ascending, -1
  padding last) up to the first -1 with an online softmax; out, and with
  `return_lse` the row logsumexp [B, H, nqb, block] f32;
- `block_sparse_flash_dq`: dq along the same table;
- `block_sparse_flash_dkv`: dk and dv, one CTA per (batch, head,
  key-block) walking the reverse table `rev [H, nkb, R]`
  (`reverse_gather`), summed in f32 and written once, no atomics.
`block_sparse_flash_backward` runs the two backward kernels.

A row whose every key is masked gives out 0 and a finite lse (the TPU
kernel's -1e30 sentinel and re-mask), and then dq, dk and dv 0.

Each has a plain PyTorch version of the same function (`*_reference`,
f32 math over gathered copies of the active blocks; the backward from the
forward's residuals) that runs for tensors on the CPU; a tensor on a CUDA
device takes the kernel or an error.  The forward's plain version is also
the plain path of `sparse_attention.block_sparse_attention`, where
PyTorch's autograd differentiates it.  The kernels take bf16 (tensor
cores) or f32 (CUDA cores), blocks that are multiples of 8 up to 128 and
head dims 64 and 128; other shapes raise.

Layout is the JAX public one: q, k, v [B, S, H, D].
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["block_sparse_flash_attention", "block_sparse_flash_backward",
           "block_sparse_flash_dq", "block_sparse_flash_dkv",
           "reverse_gather", "block_sparse_flash_attention_reference",
           "block_sparse_flash_backward_reference",
           "block_sparse_flash_dq_reference",
           "block_sparse_flash_dkv_reference", "NEG_INF"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_BLOCK = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (_P,) * 6 + (_I,) * 7 + (_F, _I, _P)
_DQ_ARGS = (_P,) * 8 + (_I,) * 7 + (_F, _I, _P)
_DKV_ARGS = (_P,) * 9 + (_I,) * 7 + (_F, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reverse_gather(kb_idx) -> np.ndarray:
    """Invert the [H, nqb, A] gather table: rev[h, kb, r] lists, in
    ascending order, the q-blocks whose row visits key block kb (-1
    padded, R = max(1, the most visitors of any key block))."""
    kb_idx = np.asarray(kb_idx)
    H, nqb, _ = kb_idx.shape
    visits = np.zeros((H, nqb, nqb), bool)              # [h, kb, qb]
    h, i, a = np.nonzero(kb_idx >= 0)
    visits[h, kb_idx[h, i, a], i] = True
    counts = visits.sum(-1)
    R = max(1, int(counts.max()))
    hh, kb, qb = np.nonzero(visits)
    row = hh * nqb + kb
    starts = np.concatenate([[0], np.cumsum(counts.ravel())[:-1]])
    rev = np.full((H * nqb, R), -1, np.int32)
    rev[row, np.arange(row.size) - starts[row]] = qb
    return rev.reshape(H, nqb, R)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _blocks(x, block):
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, H, S // block, block, D)


def _unblocks(x):
    B, H, nb, block, D = x.shape
    return x.reshape(B, H, nb * block, D).permute(0, 2, 1, 3)


def _table(kb_idx, device):
    if isinstance(kb_idx, torch.Tensor):
        return kb_idx.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(kb_idx, np.int64)).to(device)


def _scores(q, k, v, kb_idx, block, causal, scale):
    """f32 scores of each q-block against its gathered key blocks, masked
    to NEG_INF, [B, H, nqb, block, A*block], and the gathered k and v
    [B, H, nqb, A, block, D] as f32."""
    B, S, H, D = q.shape
    idx = _table(kb_idx, q.device)
    A = idx.shape[-1]
    safe = idx.clamp_min(0)
    h_ar = torch.arange(H, device=q.device)[:, None, None]
    gk = _blocks(k, block)[:, h_ar, safe].float()
    gv = _blocks(v, block)[:, h_ar, safe].float()
    qs = _blocks(q, block).float() * scale
    s = torch.einsum("bhqid,bhqajd->bhqiaj", qs, gk)
    valid = (idx >= 0)[:, :, None, :, None]
    if causal:
        nqb = S // block
        ar = torch.arange(block, device=q.device)
        qpos = torch.arange(nqb, device=q.device)[:, None] * block + ar
        kpos = idx[..., None] * block + ar                  # [H, nqb, A, j]
        valid = valid & (kpos[:, :, None, :, :]
                         <= qpos[None, :, :, None, None])
    s = torch.where(valid, s, NEG_INF)
    return s.reshape(*s.shape[:4], A * block), gk, gv, qs


def block_sparse_flash_attention_reference(q, k, v, kb_idx, block: int,
                                           causal: bool = True,
                                           scale: Optional[float] = None,
                                           round_p: bool = False):
    """Plain PyTorch version of the forward kernel: f32 math, differentiable
    in q, k and v.  Returns (out [B, S, H, D] in q.dtype, lse [B, H, nqb,
    block] f32).  `round_p` rounds the normalised probabilities to q.dtype
    before the product with V, as the JAX package's jnp path does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, _, gv, _ = _scores(q, k, v, kb_idx, block, causal, scale)
    # the softmax does not depend on m: no gradient flows through it
    m = s.amax(-1, keepdim=True).detach()
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    B, H, nqb, bl, _ = s.shape
    gv = gv.reshape(B, H, nqb, -1, gv.shape[-1])
    if round_p:
        out = torch.einsum("bhqik,bhqkd->bhqid",
                           (p / l).to(q.dtype).float(), gv)
    else:
        out = torch.einsum("bhqik,bhqkd->bhqid", p, gv) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return _unblocks(out).to(q.dtype), lse


def _bwd_reference(q, k, v, kb_idx, out, do, lse, block, causal, scale):
    """(dq, dk, dv) in f32 from the forward's residuals and dO."""
    B, S, H, D = q.shape
    nb = S // block
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, gk, gv, qs = _scores(q, k, v, kb_idx, block, causal, scale)
    A = gk.shape[3]
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - lse.float()[..., None]),
                    0.0).reshape(B, H, nb, block, A, block)
    dob = _blocks(do, block).float()
    delta = (dob * _blocks(out, block).float()).sum(-1)    # [B, H, nqb, bl]
    dp = torch.einsum("bhqid,bhqajd->bhqiaj", dob, gv)
    ds = p * (dp - delta[..., None, None])
    dq = torch.einsum("bhqiaj,bhqajd->bhqid", ds, gk) * scale
    dk_g = torch.einsum("bhqiaj,bhqid->bhqajd", ds, qs)
    dv_g = torch.einsum("bhqiaj,bhqid->bhqajd", p, dob)
    # scatter the gathered blocks' gradients back onto their key blocks
    idx = _table(kb_idx, q.device).clamp_min(0)
    dest = (torch.arange(H, device=q.device)[:, None, None] * nb
            + idx).reshape(-1)
    dk = torch.zeros(B, H * nb, block, D, device=q.device)
    dv = torch.zeros(B, H * nb, block, D, device=q.device)
    dk.index_add_(1, dest, dk_g.reshape(B, -1, block, D))
    dv.index_add_(1, dest, dv_g.reshape(B, -1, block, D))
    return (_unblocks(dq), _unblocks(dk.view(B, H, nb, block, D)),
            _unblocks(dv.view(B, H, nb, block, D)))


def block_sparse_flash_backward_reference(q, k, v, kb_idx, out, do, lse,
                                          block: int, causal: bool = True,
                                          scale: Optional[float] = None):
    """Plain PyTorch version of `block_sparse_flash_backward`: f32 math.
    Returns (dq, dk, dv) like q."""
    return tuple(t.to(q.dtype) for t in _bwd_reference(
        q, k, v, kb_idx, out, do, lse, block, causal, scale))


def block_sparse_flash_dq_reference(q, k, v, kb_idx, out, do, lse,
                                    block: int, causal: bool = True,
                                    scale: Optional[float] = None):
    """Plain PyTorch version of the dq kernel: f32 math.  Returns dq like
    q."""
    return _bwd_reference(q, k, v, kb_idx, out, do, lse, block, causal,
                          scale)[0].to(q.dtype)


def block_sparse_flash_dkv_reference(q, k, v, kb_idx, out, do, lse,
                                     block: int, causal: bool = True,
                                     scale: Optional[float] = None):
    """Plain PyTorch version of the dk/dv kernel: f32 math.  Returns (dk,
    dv) like k."""
    _, dk, dv = _bwd_reference(q, k, v, kb_idx, out, do, lse, block,
                               causal, scale)
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _check(q, k, v, table, block, rest=()):
    """Raise on anything the kernels do not take; `rest` are the
    backward's (out, do, lse)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (kernels take bf16 or f32)")
    if q.dim() != 4:
        raise ValueError(f"need q/k/v [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS})")
    if block % 8 or not 8 <= block <= MAX_BLOCK:
        raise ValueError(f"block {block} (kernels take multiples of 8 up to "
                         f"{MAX_BLOCK})")
    if S % block:
        raise ValueError(f"seq len {S} is not a multiple of block {block}")
    for name, t in (("k", k), ("v", v)) + tuple(zip(("out", "do"), rest)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and "
                             f"device")
    if rest and (rest[2].shape != (B, H, S // block, block)
                 or rest[2].dtype != torch.float32
                 or rest[2].device != q.device):
        raise ValueError(f"lse must be f32 {(B, H, S // block, block)} on "
                         f"q's device")
    if (table.dtype != torch.int32 or table.dim() != 3
            or table.shape[:2] != (H, S // block)
            or table.device != q.device):
        raise ValueError(f"gather tables must be int32 [H, {S // block}, n] "
                         f"on q's device, got {tuple(table.shape)} "
                         f"{table.dtype} on {table.device}")
    for t in (q, k, v, table) + tuple(rest):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _device_table(t, device):
    if isinstance(t, torch.Tensor):
        return t
    return torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(device)


def _scale(scale, D):
    return float(scale if scale is not None else 1.0 / math.sqrt(D))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _not_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"no block-sparse attention kernel for device "
                         f"{t.device}")


def block_sparse_flash_attention(q, k, v, kb_idx, block: int,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 return_lse: bool = False):
    """Block-sparse attention over the gather table `kb_idx` [H, nqb, A]
    (numpy or an int32 tensor; -1 padding).  Returns out [B, S, H, D] in
    q.dtype, and with `return_lse` also the lse [B, H, nqb, block] f32."""
    if q.device.type == "cpu":
        out, lse = block_sparse_flash_attention_reference(
            q, k, v, kb_idx, block, causal, scale)
        return (out, lse) if return_lse else out
    _not_cuda(q)
    idx = _device_table(kb_idx, q.device)
    _check(q, k, v, idx, block)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S // block, block), dtype=torch.float32,
                      device=q.device)
    fn = _build.function("sparse_flash", "dstt_sparse_fwd", _FWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), idx.data_ptr(), B, S, H, D, block, idx.shape[2],
            int(bool(causal)), _scale(scale, D), _DTYPES[q.dtype], _stream(q))
    _build.check(rc, "block-sparse attention")
    block_sparse_flash_attention.launches += 1
    return (out, lse) if return_lse else out


def block_sparse_flash_dq(q, k, v, kb_idx, out, do, lse, block: int,
                          causal: bool = True,
                          scale: Optional[float] = None):
    """dq of block-sparse attention along the gather table, from the
    forward's residuals and dO.  Returns dq like q."""
    if q.device.type == "cpu":
        return block_sparse_flash_dq_reference(q, k, v, kb_idx, out, do,
                                               lse, block, causal, scale)
    _not_cuda(q)
    idx = _device_table(kb_idx, q.device)
    _check(q, k, v, idx, block, (out, do, lse))
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    fn = _build.function("sparse_flash", "dstt_sparse_dq", _DQ_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), idx.data_ptr(), B,
            S, H, D, block, idx.shape[2], int(bool(causal)),
            _scale(scale, D), _DTYPES[q.dtype], _stream(q))
    _build.check(rc, "block-sparse attention dq")
    block_sparse_flash_dq.launches += 1
    return dq


def block_sparse_flash_dkv(q, k, v, kb_idx, rev_idx, out, do, lse,
                           block: int, causal: bool = True,
                           scale: Optional[float] = None):
    """dk and dv of block-sparse attention, each key block walking the
    q-blocks of the reverse table `rev_idx` [H, nkb, R].  Returns (dk, dv)
    like k."""
    if q.device.type == "cpu":
        return block_sparse_flash_dkv_reference(q, k, v, kb_idx, out, do,
                                                lse, block, causal, scale)
    _not_cuda(q)
    rev = _device_table(rev_idx, q.device)
    _check(q, k, v, rev, block, (out, do, lse))
    B, S, H, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.function("sparse_flash", "dstt_sparse_dkv", _DKV_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            rev.data_ptr(), B, S, H, D, block, rev.shape[2],
            int(bool(causal)), _scale(scale, D), _DTYPES[q.dtype],
            _stream(q))
    _build.check(rc, "block-sparse attention dk/dv")
    block_sparse_flash_dkv.launches += 1
    return dk, dv


def block_sparse_flash_backward(q, k, v, kb_idx, rev_idx, out, do, lse,
                                block: int, causal: bool = True,
                                scale: Optional[float] = None):
    """(dq, dk, dv) for `block_sparse_flash_attention`: the dq kernel over
    `kb_idx`, the dk/dv kernel over its reverse `rev_idx`."""
    dq = block_sparse_flash_dq(q, k, v, kb_idx, out, do, lse, block,
                               causal, scale)
    dk, dv = block_sparse_flash_dkv(q, k, v, kb_idx, rev_idx, out, do, lse,
                                    block, causal, scale)
    return dq, dk, dv


block_sparse_flash_attention.launches = 0
block_sparse_flash_dq.launches = 0
block_sparse_flash_dkv.launches = 0
