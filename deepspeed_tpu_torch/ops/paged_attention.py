"""Paged decode attention: one query token per sequence over its KV blocks
in the shared arena.

Counterpart of `deepspeed_tpu/ops/paged_attention.py`.  The kernel is
`csrc/paged_decode.cu` (hand-written CUDA for sm_90a, bound with ctypes);
`paged_decode_reference` is the plain PyTorch version of the same
function.  `paged_decode_attention` runs the plain version for tensors on
the CPU and the kernel for tensors on a CUDA device — never the plain
version there.

Masking: block j of a table holds key positions [j*bs, (j+1)*bs); keys
with position > lens[b] are masked; lens[b] < 0 marks an inactive
(padded) row, whose output is zeros.  Table entries past a sequence's
live blocks may be garbage: they are clamped to [0, nb-1] and masked.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_decode_attention", "paged_decode_reference"]

NEG_INF = -1e30
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _I,
         _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_reference(q, arena_k, arena_v, block_tables, lens,
                           layer_idx=None):
    """Plain PyTorch version (dense gather, f32 softmax and products).

    q: [B, NH, D]; arena_k/v: [nb, bs, NKV, D], or the full
    [L, nb, bs, NKV, D] arena with `layer_idx`; block_tables: [B, MB];
    lens: [B] current token position (inclusive key bound; < 0 =
    inactive).  Returns [B, NH, D] in q.dtype."""
    if layer_idx is not None:
        arena_k, arena_v = arena_k[layer_idx], arena_v[layer_idx]
    B, NH, D = q.shape
    nb, bs, NKV, _ = arena_k.shape
    MB = block_tables.shape[1]
    idx = block_tables.long().clamp(0, nb - 1)
    kk = arena_k[idx].reshape(B, MB * bs, NKV, D).float()
    vv = arena_v[idx].reshape(B, MB * bs, NKV, D).float()
    if NKV != NH:
        kk = kk.repeat_interleave(NH // NKV, dim=2)
        vv = vv.repeat_interleave(NH // NKV, dim=2)
    s = torch.einsum("bnd,bmnd->bnm", q.float(), kk) / math.sqrt(D)
    key_pos = torch.arange(MB * bs, device=q.device)[None, None, :]
    lens = lens.to(q.device).long()
    s = torch.where(key_pos <= lens[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnm,bmnd->bnd", p, vv)
    out = torch.where((lens < 0)[:, None, None], torch.zeros_like(out), out)
    return out.to(q.dtype)


def _check(q, arena_k, arena_v, block_tables, lens, layer_idx):
    dev = q.device
    for name, t in (("arena_k", arena_k), ("arena_v", arena_v),
                    ("block_tables", block_tables), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (kernel takes bf16 or f32)")
    if arena_k.dtype != q.dtype or arena_v.dtype != q.dtype:
        raise TypeError("arena dtype must match q")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lens must be int32")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, NH, D], got {tuple(q.shape)}")
    want = 5 if layer_idx is not None else 4
    if arena_k.dim() != want or arena_k.shape != arena_v.shape:
        raise ValueError(f"arena must be {want}-D, got "
                         f"{tuple(arena_k.shape)} / {tuple(arena_v.shape)}")
    B, NH, D = q.shape
    NKV = arena_k.shape[-2]
    if arena_k.shape[-1] != D or D not in (32, 64, 128):
        raise ValueError(f"head dim {D} (kernel takes 32, 64 or 128, "
                         f"matching the arena)")
    if NH % NKV or NH // NKV > 8:
        raise ValueError(f"NH={NH}, NKV={NKV}: need NH % NKV == 0 and a "
                         f"group of at most 8 heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            lens.shape != (B,):
        raise ValueError("block_tables must be [B, MB] and lens [B]")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v),
                    ("block_tables", block_tables), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if layer_idx is not None and not 0 <= int(layer_idx) < arena_k.shape[0]:
        raise ValueError(f"layer_idx {layer_idx} out of range")


def launch(q, arena_k, arena_v, block_tables, lens, layer_idx=None):
    """Check the inputs and launch the kernel on `q`'s CUDA device,
    without counting the launch (the wrappers over it count theirs)."""
    _check(q, arena_k, arena_v, block_tables, lens, layer_idx)
    B, NH, D = q.shape
    nb, bs, NKV = arena_k.shape[-4], arena_k.shape[-3], arena_k.shape[-2]
    MB = block_tables.shape[1]
    layer_off = 0 if layer_idx is None else int(layer_idx) * nb * bs * NKV * D
    splits = _build.function("paged_decode", "dstt_paged_decode_splits",
                             (_I, _I))(MB, bs)
    # the split-KV pass's partial states (see csrc/paged_decode.cu)
    part = torch.empty(B * NH * splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    fn = _build.function("paged_decode", "dstt_paged_decode", _ARGS)
    rc = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), part.data_ptr(),
            out.data_ptr(), B, NH, NKV, D, nb, bs, MB, layer_off,
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged decode")
    return out


def paged_decode_attention(q, arena_k, arena_v, block_tables, lens,
                           layer_idx=None):
    """Paged decode attention (see module docstring); shapes as in
    `paged_decode_reference`.  With `layer_idx`, arena_k/v keep their
    full [L, nb, bs, NKV, D] shape and the kernel reads layer `layer_idx`
    at a pointer offset — no layer slice is copied."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, arena_k, arena_v, block_tables,
                                      lens, layer_idx)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    out = launch(q, arena_k, arena_v, block_tables, lens, layer_idx)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
