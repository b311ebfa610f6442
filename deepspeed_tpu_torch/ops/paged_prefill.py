"""Blocked-flash prefill over the paged KV arena.

Counterpart of `deepspeed_tpu/ops/paged_prefill.py`.  The kernel is
`csrc/paged_prefill.cu` (hand-written CUDA for sm_90a, bound with
ctypes); `paged_prefill_reference` is the plain PyTorch version of the
same function.  `paged_prefill_attention` runs the plain version for
tensors on the CPU and the kernel for tensors on a CUDA device.

C chunk queries sit at absolute positions [pos0, pos0+C); block j of the
table holds key positions [j*bs, (j+1)*bs); causal = key_pos <= q_pos,
and a sliding window additionally masks key_pos <= q_pos - window.  Rows
c >= n_valid are padding: the caller drops them, and neither version
promises zeros there.  Every C >= 1 is served (the TPU kernel's VMEM
tile plan has no counterpart on the card).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["paged_prefill_attention", "paged_prefill_reference"]

NEG_INF = -1e30
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _I, _I, _I,
         _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_prefill_reference(q, arena_k, arena_v, block_table, pos0,
                            n_valid, sliding_window: Optional[int] = None,
                            layer_idx=None):
    """Plain PyTorch version (dense gather, f32 softmax and products).

    q: [C, NH, D]; arena_k/v: [nb, bs, NKV, D], or the full
    [L, nb, bs, NKV, D] arena with `layer_idx`; block_table: [MB];
    pos0/n_valid: ints.  Returns [C, NH, D] in q.dtype."""
    if layer_idx is not None:
        arena_k, arena_v = arena_k[layer_idx], arena_v[layer_idx]
    C, NH, D = q.shape
    nb, bs, NKV, _ = arena_k.shape
    MB = block_table.shape[0]
    max_kv = MB * bs
    idx = block_table.long().clamp(0, nb - 1)
    kk = arena_k[idx].reshape(max_kv, NKV, D).float()
    vv = arena_v[idx].reshape(max_kv, NKV, D).float()
    if NKV != NH:
        kk = kk.repeat_interleave(NH // NKV, dim=1)
        vv = vv.repeat_interleave(NH // NKV, dim=1)
    s = torch.einsum("cnd,mnd->ncm", q.float(), kk) / math.sqrt(D)
    key_pos = torch.arange(max_kv, device=q.device)[None, None, :]
    q_pos = (int(pos0) + torch.arange(C, device=q.device))[None, :, None]
    mask = key_pos <= q_pos
    if sliding_window is not None:
        mask &= key_pos > q_pos - sliding_window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("ncm,mnd->cnd", p, vv)
    return out.to(q.dtype)


def _check(q, arena_k, arena_v, block_table, layer_idx, window):
    dev = q.device
    for name, t in (("arena_k", arena_k), ("arena_v", arena_v),
                    ("block_table", block_table)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (kernel takes bf16 or f32)")
    if arena_k.dtype != q.dtype or arena_v.dtype != q.dtype:
        raise TypeError("arena dtype must match q")
    if block_table.dtype != torch.int32 or block_table.dim() != 1:
        raise TypeError("block_table must be a 1-D int32 tensor")
    if q.dim() != 3 or q.shape[0] < 1:
        raise ValueError(f"q must be [C>=1, NH, D], got {tuple(q.shape)}")
    want = 5 if layer_idx is not None else 4
    if arena_k.dim() != want or arena_k.shape != arena_v.shape:
        raise ValueError(f"arena must be {want}-D, got "
                         f"{tuple(arena_k.shape)} / {tuple(arena_v.shape)}")
    C, NH, D = q.shape
    NKV = arena_k.shape[-2]
    if arena_k.shape[-1] != D or D not in (32, 64, 128):
        raise ValueError(f"head dim {D} (kernel takes 32, 64 or 128, "
                         f"matching the arena)")
    if NH % NKV:
        raise ValueError(f"NH={NH} is not a multiple of NKV={NKV}")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v),
                    ("block_table", block_table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if layer_idx is not None and not 0 <= int(layer_idx) < arena_k.shape[0]:
        raise ValueError(f"layer_idx {layer_idx} out of range")
    if window is not None and window <= 0:
        raise ValueError(f"sliding_window must be positive, got {window}")


def launch(q, arena_k, arena_v, block_table, pos0, n_valid,
           sliding_window: Optional[int] = None, layer_idx=None):
    """Check the inputs and launch the kernel on `q`'s CUDA device,
    without counting the launch (the wrappers over it count theirs)."""
    _check(q, arena_k, arena_v, block_table, layer_idx, sliding_window)
    C, NH, D = q.shape
    nb, bs, NKV = arena_k.shape[-4], arena_k.shape[-3], arena_k.shape[-2]
    MB = block_table.shape[0]
    layer_off = 0 if layer_idx is None else int(layer_idx) * nb * bs * NKV * D
    out = torch.empty_like(q)
    fn = _build.function("paged_prefill", "dstt_paged_prefill", _ARGS)
    rc = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            block_table.data_ptr(), out.data_ptr(), C, NH, NKV, D, nb, bs,
            MB, layer_off, int(pos0), int(n_valid),
            int(sliding_window or 0), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged prefill")
    return out


def paged_prefill_attention(q, arena_k, arena_v, block_table, pos0,
                            n_valid, sliding_window: Optional[int] = None,
                            layer_idx=None):
    """Blocked-flash prefill (see module docstring); shapes as in
    `paged_prefill_reference`.  With `layer_idx`, arena_k/v keep their
    full [L, nb, bs, NKV, D] shape and the kernel reads the layer at a
    pointer offset."""
    if q.device.type == "cpu":
        return paged_prefill_reference(q, arena_k, arena_v, block_table,
                                       pos0, n_valid, sliding_window,
                                       layer_idx)
    if q.device.type != "cuda":
        raise ValueError(f"no paged prefill kernel for device {q.device}")
    out = launch(q, arena_k, arena_v, block_table, pos0, n_valid,
                 sliding_window, layer_idx)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
