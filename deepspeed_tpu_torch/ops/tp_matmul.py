"""Fused compute-collective matmuls for tensor-parallel decode.

Counterpart of `deepspeed_tpu/ops/tp_matmul.py`.  The Megatron-style TP
block pays two collectives per transformer block; the fused path hides
them behind GEMMs instead of serializing with them (arXiv 2305.06942,
2504.18658):

- `ag_matmul`, the all-gather producer: this rank's row chunk of the
  row-sharded activation travels around the ring while each chunk that
  has arrived multiplies through this rank's weight columns;
- `matmul_rs`, the reduce-scatter consumer: partial products of the row
  chunks are computed just in time and accumulated (in f32) around the
  ring, so each rank ends holding its own row chunk fully reduced.

Each ring hop is one `torch.distributed.batch_isend_irecv` of a send to
one neighbour and a receive from the other, on the tp process group, and
the hop's GEMM is issued before the hop's `wait()`: on NCCL the transfer
runs on NCCL's stream while the GEMM runs on the compute stream.  The
neighbour directions and the chunk order are the reference's.
`ag_matmul_xla` / `matmul_rs_xla` keep the same signatures over one
all-gather or one reduce-scatter (the reference's unfused twins).

The per-hop GEMM is `tile_matmul`: `x [M, K] @ w [K, N]` to f32, by the
hand-written kernels of `csrc/tile_matmul.cu` for tensors on the card (any
M, K and N: the TPU kernel's MXU tile rule, `tile_matmul_supported`, has
no counterpart) and by the plain version, the f32 product of the exactly
widened inputs, for tensors on the CPU.  `tile_plan` (pure Python) picks
the kernel and its split of K for a shape: the split-K TMA stream at the
decode hops (M <= 16), TMA + wgmma at the prefill hops, and the cp.async
kernel (bf16) or the CUDA-core kernel (f32) where TMA cannot go.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from ..comm import comm
from . import _build, _scratch

__all__ = ["tile_matmul", "tile_matmul_reference", "tile_plan", "TilePlan",
           "tile_edge_reason", "TILE_VARIANTS", "ag_matmul", "matmul_rs",
           "ag_matmul_xla", "matmul_rs_xla"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_TMA_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# ----------------------------------------------------------------------
# the host plan: which kernel, and how K is split
# ----------------------------------------------------------------------
# "stream" and "wgmma" read x and w with TMA; "cp_async" and "f32" are
# the kernels for what TMA cannot take (csrc/tile_matmul.cu says what
# each does)
TILE_VARIANTS = ("stream", "wgmma", "cp_async", "f32")
_TMA_CODES = {"stream": 0, "wgmma": 1}
STREAM_MAX_M = 16       # decode hops: the decode batch over tp rows
STREAM_BN = 128         # output columns per stream CTA
WGMMA_BM = WGMMA_BN = 128
SPLIT_KT = 64           # K rows per ring slot; K ranges are whole slots
STREAM_MAX_KR = 1024    # K rows per stream CTA (x's slice in shared mem)
WGMMA_MIN_KR = 1024     # K rows per wgmma split, at least
H100_SMS = 132
MAX_GRID_Y = 65535


@dataclass(frozen=True)
class TilePlan:
    """One tile GEMM launch: the kernel (`variant`, one of TILE_VARIANTS),
    why an old kernel serves the shape (`reason`, "" for the TMA ones),
    its output tiles, and the K split: split i sums K tiles
    [i*nkt//splits, (i+1)*nkt//splits) of SPLIT_KT rows (the kernel's own
    formula), splits summed 0..s-1 in order."""
    variant: str
    reason: str
    tiles: int
    splits: int
    K: int

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    @property
    def k_ranges(self) -> List[Tuple[int, int]]:
        nkt = -(-self.K // SPLIT_KT)
        return [(i * nkt // self.splits * SPLIT_KT,
                 min(self.K, (i + 1) * nkt // self.splits * SPLIT_KT))
                for i in range(self.splits)]


def tile_edge_reason(M: int, K: int, N: int, dtype,
                     aligned: bool) -> str:
    """Why TMA cannot take a shape ("" where it can): TMA reads bf16 here,
    needs 16-byte-aligned bases and row strides that are multiples of 16
    bytes (K and N multiples of 8), and the wgmma grid's y axis holds at
    most 65535 row tiles."""
    if dtype != torch.bfloat16:
        return f"{dtype} (the CUDA-core kernel)"
    if not aligned:
        return "a base off the 16-byte boundary"
    if K % 8 or N % 8:
        return "K or N not a multiple of 8"
    if K == 0:
        return "K = 0"
    if M > STREAM_MAX_M and -(-M // WGMMA_BM) > MAX_GRID_Y:
        return "more than 65535 row tiles"
    return ""


@functools.lru_cache(maxsize=4096)
def tile_plan(M: int, K: int, N: int, dtype, aligned: bool = True,
              sm_count: int = H100_SMS) -> TilePlan:
    """The launch `tile_matmul` makes for x [M, K] @ w [K, N] of `dtype`
    (`aligned`: x and w start on 16-byte boundaries) on a card of
    `sm_count` SMs.

    - decode hops (M <= STREAM_MAX_M): the split-K stream, 128 columns a
      CTA, K split so that column tiles x splits >= 2 x sm_count CTAs
      (bytes in flight on every SM) and each split holds at most
      STREAM_MAX_KR rows, never more splits than K tiles;
    - prefill hops: TMA + wgmma on 128 x 128 tiles, K split only where
      the tiles would leave three quarters of the SMs idle, into
      floor(sm_count / tiles) ranges of at least WGMMA_MIN_KR rows (one
      CTA sums a tile's partials, so a split pays back only over a long
      K: measured on the card at the NC=2 hops, PERF.md);
    - what `tile_edge_reason` names: the cp.async kernel (bf16) or the
      CUDA-core kernel (f32), K unsplit.

    Cached: a serving wave asks for a few shapes thousands of times."""
    reason = tile_edge_reason(M, K, N, dtype, aligned)
    nkt = -(-K // SPLIT_KT)
    if reason:
        variant = "f32" if dtype == torch.float32 else "cp_async"
        bm = 32 if variant == "f32" else (16 if M <= 16 else 64)
        return TilePlan(variant, reason, -(-M // bm) * -(-N // 64), 1, K)
    if M <= STREAM_MAX_M:
        tiles = -(-N // STREAM_BN)
        splits = max(-(-2 * sm_count // tiles), -(-K // STREAM_MAX_KR))
        return TilePlan("stream", "", tiles, min(splits, nkt), K)
    tiles = -(-M // WGMMA_BM) * -(-N // WGMMA_BN)
    splits = 1
    if tiles <= sm_count // 4:
        splits = max(1, min(sm_count // tiles, K // WGMMA_MIN_KR))
    return TilePlan("wgmma", "", tiles, splits, K)


def tile_matmul_reference(x, w):
    """Plain version: x [M, K] @ w [K, N] as an f32 product of the inputs
    widened to f32 (exact for bf16), f32 sums (the reference's
    `jnp.dot(..., preferred_element_type=f32)`)."""
    return x.float() @ w.float()


def _check(x, w):
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"tile_matmul takes bf16 or f32 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tile_matmul needs contiguous x and w")
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 2 ** 31:
        raise ValueError("tile_matmul dimensions must stay below 2^31")


def tile_matmul(x, w, *, impl: str = "auto"):
    """2-D matmul with f32 accumulation: `x [M, K] @ w [K, N] -> f32`.

    impl="auto" launches the kernel for a CUDA tensor (or raises) and runs
    the plain version for a CPU tensor; "kernel" insists on the kernel
    (raising on the CPU, where there is none); "plain" is the explicit
    plain version on any device (the engines' `plain_kernels` switch)."""
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be auto|kernel|plain, got {impl!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tile_matmul needs x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if impl == "plain":
        return tile_matmul_reference(x, w)
    if x.device.type == "cpu":
        if impl == "kernel":
            raise ValueError("impl='kernel': the tile matmul kernel runs on "
                             "a CUDA device only")
        return tile_matmul_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no tile matmul kernel for device {x.device}")
    _check(x, w)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = tile_plan(M, K, N, x.dtype, aligned, _scratch.sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.variant in _TMA_CODES:
        ws = tickets = None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, M, N), dtype=torch.float32,
                             device=x.device)
            # one zeroed int per output tile, left zeroed by the kernel
            tickets = _scratch.buffer("tile_tickets", x.device, stream,
                                      plan.tiles, torch.int32)
        fn = _build.function("tile_matmul", "dstt_tile_matmul_tma",
                             _TMA_ARGS)
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), M, K, N,
                _TMA_CODES[plan.variant], plan.splits, stream)
    else:
        vec = K % 8 == 0 and N % 8 == 0 and aligned
        fn = _build.function("tile_matmul", "dstt_tile_matmul", _ARGS)
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
                _DTYPES[x.dtype], int(vec), stream)
    _build.check(rc, f"tile matmul ({plan.variant})")
    tile_matmul.launches += 1
    tile_matmul.launches_by_variant[plan.variant] += 1
    return out


tile_matmul.launches = 0
# launches per kernel (TILE_VARIANTS); a caller resets it with `launches`
tile_matmul.launches_by_variant = dict.fromkeys(TILE_VARIANTS, 0)

# ----------------------------------------------------------------------
# fused ring collective-matmuls (every rank of the group calls them)
# ----------------------------------------------------------------------
def _hop(send, recv, to: int, frm: int, group):
    """One ring hop: send `send` to group rank `to` and receive `recv`
    from group rank `frm`, as one batched P2P call; returns its works."""
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, comm.global_rank(group, to), group),
        dist.P2POp(dist.irecv, recv, comm.global_rank(group, frm), group)])


def _wait(works) -> None:
    for w in works:
        w.wait()


def ag_matmul(x_local, group, tp: int,
              mm: Callable[[torch.Tensor], torch.Tensor]):
    """All-gather-producer matmul (fused).  x_local: [s, K], this rank's
    row chunk of the logically [tp*s, K] activation (chunk i on group rank
    i).  `mm` maps one [s, K] chunk to its [s, N] product.  Returns
    [tp*s, N]: full rows, this rank's N columns.  Step k multiplies the
    chunk that started at rank (idx + k) while the ring forwards it on
    (each rank sends to idx - 1 and receives from idx + 1)."""
    idx = comm.get_rank(group)
    s = x_local.shape[0]
    chunk = x_local.contiguous()
    out = None
    for k in range(tp):
        works = None
        if k < tp - 1:
            nxt = torch.empty_like(chunk)
            works = _hop(chunk, nxt, (idx - 1) % tp, (idx + 1) % tp, group)
        y = mm(chunk)
        if out is None:
            out = y.new_empty((tp * s,) + tuple(y.shape[1:]))
        src = (idx + k) % tp
        out[src * s:(src + 1) * s] = y
        if works is not None:
            _wait(works)
            chunk = nxt
    return out


def matmul_rs(x, group, tp: int,
              mm: Callable[[torch.Tensor], torch.Tensor]):
    """Matmul-reduce-scatter consumer (fused).  x: [S, K_local], full rows
    with this rank's slice of the contraction dim.  `mm` maps a [S/tp,
    K_local] row chunk to its [S/tp, N] f32 partial product.  Returns
    [S/tp, N] f32: row chunk `idx` summed over every rank (the caller
    casts once after the ring).  Chunk c's sum starts at rank c + 1 and
    travels toward idx + 1, ending at c."""
    idx = comm.get_rank(group)
    s = x.shape[0] // tp

    def part(c):
        return mm(x[c * s:(c + 1) * s])

    acc = part((idx + tp - 1) % tp)
    for k in range(1, tp):
        recv = torch.empty_like(acc)
        works = _hop(acc, recv, (idx + 1) % tp, (idx - 1) % tp, group)
        p = part((idx + tp - 1 - k) % tp)
        _wait(works)
        acc = recv + p
    return acc


# ----------------------------------------------------------------------
# unfused twins: one collective, one GEMM
# ----------------------------------------------------------------------
def ag_matmul_xla(x_local, group, tp: int,
                  mm: Callable[[torch.Tensor], torch.Tensor]):
    """Same contract as `ag_matmul`: one all-gather, then one GEMM."""
    del tp
    return mm(comm.all_gather(x_local, group))


def matmul_rs_xla(x, group, tp: int,
                  mm: Callable[[torch.Tensor], torch.Tensor]):
    """Same contract as `matmul_rs`: one GEMM, then one reduce-scatter of
    the whole partial product."""
    del tp
    return comm.reduce_scatter(mm(x), group)
