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
hand-written kernel `csrc/tile_matmul.cu` for tensors on the card (any M,
K and N: the TPU kernel's MXU tile rule, `tile_matmul_supported`, has no
counterpart) and by the plain version, the f32 product of the exactly
widened inputs, for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.distributed as dist

from ..comm import comm
from . import _build

__all__ = ["tile_matmul", "tile_matmul_reference", "ag_matmul", "matmul_rs",
           "ag_matmul_xla", "matmul_rs_xla"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    vec = (K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    fn = _build.function("tile_matmul", "dstt_tile_matmul", _ARGS)
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
            _DTYPES[x.dtype], int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "tile matmul")
    tile_matmul.launches += 1
    return out


tile_matmul.launches = 0


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
