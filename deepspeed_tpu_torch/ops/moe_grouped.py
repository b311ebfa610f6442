"""Grouped GEMM of exact top-k MoE serving.

    out [M, N] f32:  rows [offsets[g], offsets[g+1]) of x [M, K]  @  w[g]

x holds the token-expert assignments sorted by group (bf16 or f32), w the
stacked expert weights [G, K, N] in their stored (in-first) layout, and
`offsets` [G+1] int32 the groups' row ranges, on x's device.  It is the
reference's `lax.ragged_dot(x, w, group_sizes, preferred_element_type=
f32)` (deepspeed_tpu/models/transformer.py `_moe_inference`): XLA's
product, not a TPU kernel.  Rows outside [offsets[0], offsets[G]) are
zero, as ragged_dot leaves the rows past its groups.

The kernel is `csrc/moe_grouped.cu` (hand-written CUDA for sm_90a, bound
with ctypes): its grid is fixed by M, G and N, known on the host, and
each CTA finds its (group, row tile) from `offsets` on the device, so no
group size is read back and a decode step that calls it can be captured
in a CUDA graph.  `grouped_matmul_reference` is the plain PyTorch
version: a loop over the groups, whose sizes it reads on the host.
`grouped_matmul` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grouped_matmul", "grouped_matmul_reference", "VARIANTS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# "mma": the bf16 kernel (mma.sync); "f32": the CUDA-core kernel
VARIANTS = ("mma", "f32")


def _row_tile(M: int, G: int) -> int:
    """The bf16 kernel's row tile: 16 where a group holds fewer than 32
    rows on average (decode: a tile of 64 would be mostly padding), 64
    otherwise (prefill)."""
    return 16 if M < 32 * G else 64


def grouped_matmul_reference(x, w, offsets):
    """Plain version: each group's rows times its weight as an f32
    product of the inputs widened to f32 (exact for bf16), f32 sums (the
    reference's ragged_dot with preferred_element_type=f32).  Reads the
    offsets on the host."""
    G = w.shape[0]
    off = [int(o) for o in offsets.tolist()]
    out = torch.zeros(x.shape[0], w.shape[2], dtype=torch.float32,
                      device=x.device)
    for g in range(G):
        s, e = off[g], off[g + 1]
        if e > s:
            out[s:e] = x[s:e].float() @ w[g].float()
    return out


def _check(x, w, offsets):
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_matmul needs x [M, K] and w [G, K, N], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if offsets.dim() != 1 or offsets.shape[0] != w.shape[0] + 1:
        raise ValueError(f"grouped_matmul needs offsets [G+1] = "
                         f"[{w.shape[0] + 1}], got {tuple(offsets.shape)}")


def grouped_matmul(x, w, offsets):
    """`x [M, K]` rows grouped by `offsets` [G+1] times `w [G, K, N]` ->
    f32 [M, N].  The kernel for CUDA tensors (bf16 or f32 x and w of one
    dtype, int32 offsets, all on one device, contiguous; anything else
    raises), the plain version for CPU tensors."""
    _check(x, w, offsets)
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped matmul kernel for device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul takes bf16 or f32 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"grouped_matmul takes int32 offsets, got "
                        f"{offsets.dtype}")
    if not (w.device == x.device == offsets.device):
        raise ValueError(f"x, w and offsets on {x.device}, {w.device} and "
                         f"{offsets.device}: the kernel reads all three on "
                         f"one card")
    if not (x.is_contiguous() and w.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("grouped_matmul takes contiguous x, w and offsets "
                         "(the kernel walks their rows by shape)")
    M, K = x.shape
    G, _, N = w.shape
    out = torch.zeros(M, N, dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    variant = "mma" if x.dtype == torch.bfloat16 else "f32"
    vec = (K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    fn = _build.function("moe_grouped", "dstt_moe_grouped", _ARGS)
    rc = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            M, K, N, G, _DTYPES[x.dtype], _row_tile(M, G), int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "grouped matmul")
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_variant[variant] += 1
    return out


grouped_matmul.launches = 0
# launches per kernel (VARIANTS); a caller resets it with `launches`
grouped_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
