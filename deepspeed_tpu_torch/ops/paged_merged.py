"""Paged attention over the MERGED KV-arena layout [L, nb, bs, NKV*D].

Counterpart of `deepspeed_tpu/ops/paged_merged.py`.  The merged layout
exists because a TPU lane-pads a minor dim narrower than 128: at D = 64 a
separate [..., NKV, D] minor would double the arena in HBM, so the
reference packs (kv heads, head dim) into one minor dim and writes two
kernels that never split a lane dim: decode packs the queries
block-diagonally (`_pack_q`) and contracts the whole packed row, prefill
walks 128-lane stripes of it.

A GPU pads nothing: a [..., NKV*D] row is byte for byte the [..., NKV, D]
row of the 5-D arena.  So each wrapper here views the 4-D arena as 5-D (a
view, no copy) and launches the hand-written 5-D kernel on it
(`csrc/paged_decode.cu`, `csrc/paged_prefill.cu`; the variant the 5-D
rule names, `decode_variant` / `prefill_variant`, whose TMA maps see the
same bytes, so the output equals the 5-D kernel's bit for bit); the
packed queries, the zero stripes and the stripe grid have no
counterpart, because no lane needs splitting.  Each wrapper counts its
own launches, in all and by variant (the 5-D wrappers' counters do not
move), so a run shows that the merged path ran, and keeps a plain
version: the 5-D plain version on the same view.
"""
from __future__ import annotations

from typing import Optional

from . import paged_attention, paged_prefill
from .paged_prefill import HEAD_DIMS, VARIANTS, count

__all__ = ["merged_decode_attention", "merged_prefill_attention",
           "merged_decode_reference", "merged_prefill_reference",
           "merged_kernels_supported", "as_5d"]


def merged_kernels_supported(NH: int, NKV: int, D: int,
                             op: str = "decode") -> bool:
    """What the kernels take: head dim 32, 64, 80, 96 or 128 and whole GQA groups
    of any size.  The reference's 128-lane stripe conditions have no
    counterpart here."""
    if op not in ("decode", "prefill"):
        raise ValueError(f"op must be 'decode' or 'prefill', got {op!r}")
    return D in HEAD_DIMS and NKV >= 1 and NH % NKV == 0


def as_5d(arena, D: int):
    """[..., NKV*D] -> [..., NKV, D]: a view of the same storage."""
    M = arena.shape[-1]
    if M % D:
        raise ValueError(f"merged minor dim {M} is not a multiple of the "
                         f"head dim {D}")
    return arena.view(*arena.shape[:-1], M // D, D)


def merged_decode_reference(q, arena_k, arena_v, block_tables, lens,
                            layer_idx=None, sliding_window=None,
                            alibi_slopes=None):
    """Plain PyTorch version: `paged_decode_reference` on the 5-D view.
    q: [B, NH, D]; arena_k/v: [nb, bs, NKV*D] (or [L, ...] with
    `layer_idx`).  Returns [B, NH, D] in q.dtype."""
    D = q.shape[-1]
    return paged_attention.paged_decode_reference(
        q, as_5d(arena_k, D), as_5d(arena_v, D), block_tables, lens,
        layer_idx, sliding_window, alibi_slopes)


def merged_decode_attention(q, arena_k, arena_v, block_tables, lens,
                            layer_idx=None, variant: Optional[str] = None,
                            sliding_window=None, alibi_slopes=None):
    """Paged decode over a merged arena (the reference's signature,
    without its `interpret` switch); shapes as in
    `merged_decode_reference`; `variant`, `sliding_window` and
    `alibi_slopes` as in `paged_decode_attention`."""
    if q.device.type == "cpu":
        return merged_decode_reference(q, arena_k, arena_v, block_tables,
                                       lens, layer_idx, sliding_window,
                                       alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"no merged decode kernel for device {q.device}")
    D = q.shape[-1]
    out, used = paged_attention.launch(q, as_5d(arena_k, D),
                                       as_5d(arena_v, D), block_tables,
                                       lens, layer_idx, variant,
                                       sliding_window, alibi_slopes)
    count(merged_decode_attention, used)
    return out


def merged_prefill_reference(q, arena_k, arena_v, block_table, pos0,
                             n_valid, sliding_window: Optional[int] = None,
                             layer_idx=None, alibi_slopes=None):
    """Plain PyTorch version: `paged_prefill_reference` on the 5-D view.
    q: [C, NH, D]; arena_k/v: [nb, bs, NKV*D] (or [L, ...] with
    `layer_idx`).  Returns [C, NH, D] in q.dtype."""
    D = q.shape[-1]
    return paged_prefill.paged_prefill_reference(
        q, as_5d(arena_k, D), as_5d(arena_v, D), block_table, pos0,
        n_valid, sliding_window, layer_idx, alibi_slopes)


def merged_prefill_attention(q, arena_k, arena_v, block_table, pos0, n_valid,
                             sliding_window: Optional[int] = None,
                             layer_idx=None, variant: Optional[str] = None,
                             alibi_slopes=None):
    """Blocked-flash prefill over a merged arena (the reference's
    signature, without its `interpret` switch); shapes as in
    `merged_prefill_reference`; `variant` and `alibi_slopes` as in
    `paged_prefill_attention`."""
    if q.device.type == "cpu":
        return merged_prefill_reference(q, arena_k, arena_v, block_table,
                                        pos0, n_valid, sliding_window,
                                        layer_idx, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"no merged prefill kernel for device {q.device}")
    D = q.shape[-1]
    out, used = paged_prefill.launch(q, as_5d(arena_k, D),
                                     as_5d(arena_v, D), block_table, pos0,
                                     n_valid, sliding_window, layer_idx,
                                     variant, alibi_slopes)
    count(merged_prefill_attention, used)
    return out


merged_decode_attention.launches = 0
merged_prefill_attention.launches = 0
# launches per kernel (VARIANTS of the 5-D wrappers)
merged_decode_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
merged_prefill_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
