"""Grouped GEMM of exact top-k MoE serving.

    out [M, N] f32:  rows [offsets[g], offsets[g+1]) of x [M, K]  @  w[g]

x holds the token-expert assignments sorted by group (bf16 or f32), w the
stacked expert weights [G, K, N] in their stored (in-first) layout, and
`offsets` [G+1] int32 the groups' row ranges, on x's device.  It is the
reference's `lax.ragged_dot(x, w, group_sizes, preferred_element_type=
f32)` (deepspeed_tpu/models/transformer.py `_moe_inference`): XLA's
product, not a TPU kernel.  Rows outside [offsets[0], offsets[G]) are
zero, as ragged_dot leaves the rows past its groups.

The kernels are `csrc/moe_grouped.cu` (hand-written CUDA for sm_90a,
bound with ctypes): each grid is fixed by M, G, N and K, known on the
host, and each CTA finds its (group, row tile) from `offsets` on the
device, so no group size is read back and a decode step that calls it can
be captured in a CUDA graph.  `grouped_plan` (pure Python) picks the
kernel, its row tile and its split of K for a shape: the TMA + wgmma
kernel at prefill, its decode form (the split-K stream) where a group
holds a few rows, and the cp.async kernel (bf16) or the CUDA-core kernel
(f32) where TMA cannot go.  `grouped_matmul_reference` is the plain
PyTorch version: a loop over the groups, whose sizes it reads on the
host.  `grouped_matmul` runs the plain version for tensors on the CPU and
a kernel for tensors on a CUDA device; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build, _scratch

__all__ = ["grouped_matmul", "grouped_matmul_reference", "grouped_plan",
           "GroupedPlan", "grouped_edge_reason", "VARIANTS"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _I, _I, _P)
_TMA_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I,
             _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# "wgmma" (prefill) and "stream" (decode) read x and w with TMA; "mma" and
# "f32" are the kernels for what TMA cannot take (csrc/moe_grouped.cu says
# what each does)
VARIANTS = ("wgmma", "stream", "mma", "f32")
STREAM_TOK = 16             # the stream's row tile (decode)
WGMMA_TOKS = (32, 64, 128)  # the wgmma kernel's row tiles (prefill)
TMA_BN = 128                # output columns per TMA CTA
OLD_BN = 64                 # output columns per mma.sync / f32 CTA
SPLIT_KT = 64               # K rows per ring slot; K ranges are whole slots
H100_SMS = 132
MAX_GRID_Y = 65535


@dataclass(frozen=True)
class GroupedPlan:
    """One grouped GEMM launch, whose grid the kernels take from here:
    the kernel (`variant`, one of VARIANTS), why an old kernel serves the
    shape (`reason`, "" for the TMA ones), its row tile (`tok` rows of one
    group a CTA), output columns a CTA (`bn`, the kernel's, which the
    launch checks), the row-tile slots (a bound on the tiles any offsets
    need: ceil(M / tok) + min(G, M) for the TMA kernels, ceil(M / tok) +
    G for the old ones; slots past the last tile exit), the column tiles
    and the K split (the kernel's `split_range` gives each split its
    whole SPLIT_KT-row slots; the partials are added in split order)."""
    variant: str
    reason: str
    tok: int
    bn: int
    slots: int
    n_tiles: int
    splits: int


def _row_tile(M: int, G: int) -> int:
    """The mma.sync kernel's row tile: 16 where a group holds fewer than
    32 rows on average (decode: a tile of 64 would be mostly padding), 64
    otherwise (prefill)."""
    return 16 if M < 32 * G else 64


def grouped_edge_reason(M: int, K: int, N: int, G: int, dtype,
                        aligned: bool) -> str:
    """Why the TMA kernels cannot take a shape ("" where they can): they
    read bf16, need 16-byte-aligned bases and row strides that are
    multiples of 16 bytes (K and N multiples of 8), and the grid's y axis
    holds at most 65535 column tiles."""
    if dtype != torch.bfloat16:
        return f"{dtype} (the CUDA-core kernel)"
    if not aligned:
        return "a base off the 16-byte boundary"
    if K % 8 or N % 8:
        return "K or N not a multiple of 8"
    if K == 0:
        return "K = 0"
    if -(-N // TMA_BN) > MAX_GRID_Y:
        return "more than 65535 column tiles"
    return ""


@functools.lru_cache(maxsize=4096)
def grouped_plan(M: int, K: int, N: int, G: int, dtype,
                 aligned: bool = True,
                 sm_count: int = H100_SMS) -> GroupedPlan:
    """The launch `grouped_matmul` makes for x [M, K] over G groups @ w
    [G, K, N] of `dtype` (`aligned`: x and w start on 16-byte boundaries)
    on a card of `sm_count` SMs.  A pure function of host-known values:
    it never reads the offsets.

    - The row tile: the smallest of 16, 32, 64 and 128 that holds 1.5x
      the rows of an average group (M over the min(G, M) groups that can
      hold rows), so one tile covers a typical group and each expert's
      weight is streamed once; 16 (the decode stream) or more (wgmma);
    - K split where the expected tiles (groups x row tiles a group x
      column tiles) fall short of a wave: two waves of sm_count CTAs for
      the stream (three CTAs an SM), one for the wgmma kernel (one CTA an
      SM), into ceil(wave / tiles) ranges, never more than K tiles.  A
      split costs a partial's store and the last CTA's sum: on an H100
      80GB HBM3 at 700.00 W it lost wherever the tiles already filled a
      wave (Mixtral prefill down, 256 CTAs: 0.3397 ms unsplit, 0.3654 in
      2) and won below it (Mixtral decode down, 256 stream CTAs: 0.2482
      unsplit, 0.2327 in 2);
    - what `grouped_edge_reason` names: the cp.async kernel (bf16) or the
      CUDA-core kernel (f32), K unsplit.

    Cached: a serving wave asks for a few shapes thousands of times."""
    reason = grouped_edge_reason(M, K, N, G, dtype, aligned)
    if reason:
        return _old_plan("f32" if dtype == torch.float32 else "mma",
                         reason, M, K, N, G)
    groups = max(1, min(G, M))
    per_group = M / groups
    tok = next((t for t in (STREAM_TOK,) + WGMMA_TOKS
                if 1.5 * per_group <= t), WGMMA_TOKS[-1])
    n_tiles = -(-N // TMA_BN)
    nkt = -(-K // SPLIT_KT)
    tiles = groups * -(-M // (groups * tok)) * n_tiles
    wave = (2 if tok == STREAM_TOK else 1) * sm_count
    splits = 1
    if tiles < wave:
        splits = min(nkt, -(-wave // tiles))
    return GroupedPlan("stream" if tok == STREAM_TOK else "wgmma", "", tok,
                       TMA_BN, -(-M // tok) + min(G, M), n_tiles, splits)


def _old_plan(variant: str, reason: str, M: int, K: int, N: int,
              G: int) -> GroupedPlan:
    tok = 32 if variant == "f32" else _row_tile(M, G)
    return GroupedPlan(variant, reason, tok, OLD_BN, -(-M // tok) + G,
                       -(-N // OLD_BN), 1)


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


def grouped_matmul(x, w, offsets, *, variant: Optional[str] = None):
    """`x [M, K]` rows grouped by `offsets` [G+1] times `w [G, K, N]` ->
    f32 [M, N].  A kernel for CUDA tensors (bf16 or f32 x and w of one
    dtype, int32 offsets, all on one device, contiguous; anything else
    raises), the plain version for CPU tensors.  The kernel is the one
    `grouped_plan` names; `variant="mma"` asks for the mma.sync kernel on
    a bf16 shape instead (the tests and the chip scripts time both)."""
    _check(x, w, offsets)
    if variant not in (None, "mma"):
        raise ValueError(f"grouped_matmul variant {variant!r}: None (the "
                         f"plan's kernel) or 'mma'")
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
    if M == 0 or N == 0:
        return torch.zeros(M, N, dtype=torch.float32, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = grouped_plan(M, K, N, G, x.dtype, aligned,
                        _scratch.sm_count(x.device))
    if variant == "mma" and plan.variant != "mma":
        if x.dtype != torch.bfloat16:
            raise TypeError("variant='mma' is the bf16 kernel")
        plan = _old_plan("mma", "asked for", M, K, N, G)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.variant in ("wgmma", "stream"):
        # the kernel writes every row, zeros outside the groups
        out = torch.empty(M, N, dtype=torch.float32, device=x.device)
        ws = tickets = None
        if plan.splits > 1:
            ws = _scratch.buffer("moe_ws", x.device, stream,
                                 plan.splits * M * N, torch.float32)
            # one zeroed int per (slot, column tile), left zeroed
            tickets = _scratch.buffer("moe_tickets", x.device, stream,
                                      plan.slots * plan.n_tiles,
                                      torch.int32)
        fn = _build.function("moe_grouped", "dstt_moe_grouped_tma",
                             _TMA_ARGS)
        rc = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), M, K, N, G,
                plan.tok, plan.slots, plan.n_tiles, plan.bn, plan.splits,
                stream)
    else:
        out = torch.zeros(M, N, dtype=torch.float32, device=x.device)
        vec = K % 8 == 0 and N % 8 == 0 and aligned
        fn = _build.function("moe_grouped", "dstt_moe_grouped", _ARGS)
        rc = fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), M, K, N, G, _DTYPES[x.dtype], plan.tok,
                int(vec), plan.slots, plan.n_tiles, plan.bn, stream)
    _build.check(rc, f"grouped matmul ({plan.variant})")
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_variant[plan.variant] += 1
    return out


grouped_matmul.launches = 0
# launches per kernel (VARIANTS); a caller resets it with `launches`
grouped_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
