"""Paged decode attention: one query token per sequence over its KV blocks
in the shared arena.

Counterpart of `deepspeed_tpu/ops/paged_attention.py`.  The kernels are
in `csrc/paged_decode.cu` (hand-written CUDA for sm_90a, bound with
ctypes); `paged_decode_reference` is the plain PyTorch version of the
same function.  `paged_decode_attention` runs the plain version for
tensors on the CPU and a kernel for tensors on a CUDA device — never the
plain version there: `decode_variant` names which ("tma": the one-launch
TMA kernel, for bf16 at head dims 32, 64, 80, 96, 128 and a block size TMA can
tile; "mma": the split-KV pass and its merge, for other bf16 block sizes;
"f32"); `decode_plan` sizes the TMA kernel's workspace from the table's
length alone, and `decode_work` is its work list (equal shares of all key
tiles per CTA) in Python.  The wrappers count their launches in all and
by variant.

Masking: block j of a table holds key positions [j*bs, (j+1)*bs); keys
with position > lens[b] are masked; lens[b] < 0 marks an inactive
(padded) row, whose output is zeros.  Table entries past a sequence's
live blocks may be garbage: they are clamped to [0, nb-1] and masked.
A `sliding_window` w also masks keys at or before lens[b] - w (the
kernels walk only the key tiles from the window's start), and
`alibi_slopes` [NH] f32 adds -slope[h] (lens[b] - k_pos) to each score
(qk/sqrt(D); slopes already divided by sqrt(D) where the model adds the
bias before the scale).  Any GQA group is served: a group above
GROUP_PASS q heads takes ceil(G / GROUP_PASS) passes over its kv head,
each pass one work unit of the kernels (Falcon-7B: 71 heads, 9 passes).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from . import _build, _scratch
from .paged_prefill import (HEAD_DIMS, TILE, VARIANTS, count, named_variant,
                            tma_block_size)

__all__ = ["paged_decode_attention", "paged_decode_reference",
           "decode_variant", "decode_plan", "decode_work", "tma_ctas",
           "group_passes", "window_tiles", "VARIANTS"]

NEG_INF = -1e30
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P,) * 7 + (_I,) * 7 + (_LL, _I, _P, _I, _P)
_TMA_ARGS = (_P,) * 8 + (_I,) * 10 + (_I, _P, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_PASS = 8     # q heads of a kv head one pass (a work unit) serves
MAX_BATCH = 4096   # sequences the TMA kernel's work list holds


def group_passes(G: int) -> Tuple[int, int]:
    """(heads a pass, passes) of a GQA group of G q heads: one pass of G
    up to GROUP_PASS, else ceil(G / GROUP_PASS) passes of GROUP_PASS
    (the last one shorter), the kernels' own arithmetic."""
    hg = min(G, GROUP_PASS)
    return hg, -(-G // hg)


def window_tiles(pos: int, window: Optional[int]) -> Tuple[int, int]:
    """(first key, first key tile) a row at position `pos` (its lens)
    reads under `window`: key pos + 1 - window (positions at or before
    pos - window are masked), and its 64-key tile; (0, 0) with no
    window."""
    if not window:
        return 0, 0
    k_lo = max(0, pos + 1 - window)
    return k_lo, k_lo // TILE


def decode_variant(dtype, D: int, bs: int, G: int,
                   B: Optional[int] = None) -> str:
    """The kernels a call of `dtype`, head dim `D`, block size `bs` and
    GQA group `G` takes on the card: "f32" for float32; for bf16 "tma"
    where TMA can tile the pages (`paged_prefill.tma_block_size`) and the
    batch `B`, where given, is at most MAX_BATCH (the TMA kernel's work
    list), else "mma".  Every group G >= 1 is taken (in passes of
    GROUP_PASS heads).  Raises on what no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the paged decode kernels take "
                        f"bf16 or f32")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS})")
    if G < 1:
        raise ValueError(f"GQA group {G} (kernels take 1 or more)")
    if dtype == torch.float32:
        return "f32"
    fits = B is None or B <= MAX_BATCH
    return "tma" if tma_block_size(bs) and fits else "mma"


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The TMA kernel's workspace: a (sequence, work unit)'s key tiles are
    shared by at most `segs` CTAs, each leaving a partial state."""
    segs: int


@functools.lru_cache(maxsize=256)
def decode_plan(MB: int, bs: int) -> DecodePlan:
    """The workspace a table of MB blocks of bs keys needs: the host does
    not read lens (the kernel builds its work list from them), so room
    for a split at every key tile of the longest table."""
    return DecodePlan(-(-MB * bs // TILE))


@dataclasses.dataclass(frozen=True)
class DecodeWork:
    """The TMA kernel's work list for these lens on `ctas` CTAs: each
    CTA's number of key tiles, and for each (sequence, work unit) with
    keys the key ranges [k0, k1) of the CTAs that share its tiles, in CTA
    order (the order of the merge).  Unit u is pass u % passes of kv head
    u // passes (`group_passes`); k0 is on a tile edge, and a window's
    first tile is masked below its first key (`window_tiles`)."""
    tiles_per_cta: Tuple[int, ...]
    segments: Dict[Tuple[int, int], List[Tuple[int, int]]]


def decode_work(lens, NKV: int, MB: int, bs: int, ctas: int,
                window: Optional[int] = None, G: int = 1) -> DecodeWork:
    """The kernel's own arithmetic (csrc/paged_decode.cu): the key tiles
    of every (sequence, work unit) in that order, from the window's first
    tile, T in all, CTA c taking positions [c T / N, (c + 1) T / N) of
    N = min(ctas, T)."""
    units = NKV * group_passes(G)[1]
    tiles, first = [], []
    for n in lens:
        n_keys = min(int(n) + 1, MB * bs)
        t0 = window_tiles(int(n), window)[1] if n_keys > 0 else 0
        n_tiles = -(-n_keys // TILE) - t0 if n_keys > 0 else 0
        tiles.append(max(0, n_tiles))
        first.append(t0)
    T = units * sum(tiles)
    N = min(ctas, T)
    bounds = [c * T // N for c in range(N + 1)] if N else [0]
    segments: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    pos = 0
    for b, n in enumerate(tiles):
        n_keys = min(int(lens[b]) + 1, MB * bs)
        for unit in range(units if n else 0):
            start, stop = pos, pos + n
            segs = []
            for c in range(N):
                lo, hi = max(bounds[c], start), min(bounds[c + 1], stop)
                if lo < hi:
                    segs.append(((first[b] + lo - start) * TILE,
                                 min((first[b] + hi - start) * TILE,
                                     n_keys)))
            segments[(b, unit)] = segs
            pos = stop
    return DecodeWork(tuple(bounds[c + 1] - bounds[c] for c in range(N)),
                      segments)


def paged_decode_reference(q, arena_k, arena_v, block_tables, lens,
                           layer_idx=None, sliding_window=None,
                           alibi_slopes=None):
    """Plain PyTorch version (dense gather, f32 softmax and products).

    q: [B, NH, D]; arena_k/v: [nb, bs, NKV, D], or the full
    [L, nb, bs, NKV, D] arena with `layer_idx`; block_tables: [B, MB];
    lens: [B] current token position (inclusive key bound; < 0 =
    inactive); `sliding_window` and `alibi_slopes` [NH] as in the module
    docstring.  Returns [B, NH, D] in q.dtype."""
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
    if alibi_slopes is not None:
        dist = (lens[:, None, None] - key_pos).clamp_min(0).float()
        s = s - alibi_slopes.to(q.device).float()[None, :, None] * dist
    keep = key_pos <= lens[:, None, None]
    if sliding_window is not None:
        keep &= key_pos > lens[:, None, None] - sliding_window
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnm,bmnd->bnd", p, vv)
    out = torch.where((lens < 0)[:, None, None], torch.zeros_like(out), out)
    return out.to(q.dtype)


def check_extras(q, window, slopes) -> None:
    """The window and ALiBi arguments of a kernel call on `q` [.., NH,
    D]: a positive window; slopes [NH] f32, contiguous, on q's device."""
    if window is not None and window <= 0:
        raise ValueError(f"sliding_window must be positive, got {window}")
    if slopes is None:
        return
    if slopes.device != q.device or slopes.dtype != torch.float32 or \
            slopes.shape != (q.shape[-2],) or not slopes.is_contiguous():
        raise ValueError(
            f"alibi_slopes must be a contiguous [{q.shape[-2]}] float32 "
            f"tensor on {q.device}, got {tuple(slopes.shape)} "
            f"{slopes.dtype} on {slopes.device}")


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
    if arena_k.shape[-1] != D or D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS}, "
                         f"matching the arena)")
    if NH % NKV:
        raise ValueError(f"NH={NH} is not a multiple of NKV={NKV}")
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


def library(D: int) -> str:
    """The kernel library that holds head dim D's builds: the decode source
    compiles twice (csrc/paged_decode.cu), D 80 and 96 into
    "paged_decode_wide", the others into "paged_decode"."""
    return "paged_decode_wide" if D in (80, 96) else "paged_decode"


def tma_ctas(D: int, G: int, B: int) -> int:
    """The TMA kernel's grid on the current card for head dim D, group G
    and batch B (the CTAs that share its work list; `decode_work`)."""
    return _build.function(library(D), "dstt_paged_decode_tma_ctas",
                           (_I, _I, _I))(D, G, B)


def launch(q, arena_k, arena_v, block_tables, lens, layer_idx=None,
           variant: Optional[str] = None, sliding_window=None,
           alibi_slopes=None):
    """Check the inputs and launch the kernels on `q`'s CUDA device (those
    `decode_variant` names, or `variant` where it can take the call),
    without counting the launch (the wrappers over it count theirs).
    Returns (out, the variant launched)."""
    _check(q, arena_k, arena_v, block_tables, lens, layer_idx)
    check_extras(q, sliding_window, alibi_slopes)
    B, NH, D = q.shape
    nb, bs, NKV = arena_k.shape[-4], arena_k.shape[-3], arena_k.shape[-2]
    MB = block_tables.shape[1]
    variant = named_variant(
        decode_variant(q.dtype, D, bs, NH // NKV, B), variant,
        f"{q.dtype} at head dim {D}, block size {bs}, batch {B}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    window = int(sliding_window or 0)
    slopes = None if alibi_slopes is None else alibi_slopes.data_ptr()
    if variant == "tma":
        L = arena_k.shape[0] if layer_idx is not None else 1
        plan = decode_plan(MB, bs)
        hg, passes = group_passes(NH // NKV)
        units = B * NKV * passes
        ws = _scratch.buffer("decode_ws", q.device, stream,
                             units * hg * plan.segs * (D + 2),
                             torch.float32)
        tickets = _scratch.buffer("decode_tickets", q.device, stream,
                                  units, torch.int32)
        fn = _build.function(library(D), "dstt_paged_decode_tma",
                             _TMA_ARGS)
        rc = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
                block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                ws.data_ptr(), tickets.data_ptr(), B, NH, NKV, D, L, nb, bs,
                MB, int(layer_idx or 0), plan.segs, window, slopes, stream)
    else:
        layer_off = (0 if layer_idx is None
                     else int(layer_idx) * nb * bs * NKV * D)
        splits = _build.function(library(D), "dstt_paged_decode_splits",
                                 (_I, _I))(MB, bs)
        # the split-KV pass's partial states (see csrc/paged_decode.cu)
        part = torch.empty(B * NH * splits * (D + 2), dtype=torch.float32,
                           device=q.device)
        fn = _build.function(library(D), "dstt_paged_decode", _ARGS)
        rc = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
                block_tables.data_ptr(), lens.data_ptr(), part.data_ptr(),
                out.data_ptr(), B, NH, NKV, D, nb, bs, MB, layer_off, window,
                slopes, _DTYPES[q.dtype], stream)
    _build.check(rc, f"paged decode ({variant})")
    return out, variant


def paged_decode_attention(q, arena_k, arena_v, block_tables, lens,
                           layer_idx=None, variant: Optional[str] = None,
                           sliding_window=None, alibi_slopes=None):
    """Paged decode attention (see module docstring); shapes as in
    `paged_decode_reference`.  With `layer_idx`, arena_k/v keep their
    full [L, nb, bs, NKV, D] shape and the kernel reads layer `layer_idx`
    in place — no layer slice is copied.  `variant` (the card only) names
    a kernel other than the rule's where it can take the call ("mma" for
    a bf16 call the rule sends to "tma"), and raises where it cannot.
    `sliding_window` (a host int) and `alibi_slopes` ([NH] f32 on the
    card) select the kernels' window and bias builds."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, arena_k, arena_v, block_tables,
                                      lens, layer_idx, sliding_window,
                                      alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    out, used = launch(q, arena_k, arena_v, block_tables, lens, layer_idx,
                       variant, sliding_window, alibi_slopes)
    count(paged_decode_attention, used)
    return out


paged_decode_attention.launches = 0
# launches per kernel (VARIANTS); a caller resets it with `launches`
paged_decode_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
