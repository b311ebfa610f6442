"""Blocked-flash prefill over the paged KV arena.

Counterpart of `deepspeed_tpu/ops/paged_prefill.py`.  The kernels are in
`csrc/paged_prefill.cu` (hand-written CUDA for sm_90a, bound with
ctypes); `paged_prefill_reference` is the plain PyTorch version of the
same function.  `paged_prefill_attention` runs the plain version for
tensors on the CPU and a kernel for tensors on a CUDA device:
`prefill_variant` names which ("tma": the TMA + wgmma kernel, for bf16 at
head dims 32, 64, 80, 96, 128 and a block size TMA can tile; "mma": the mma.sync
kernel, for other bf16 block sizes; "f32"), and `prefill_plan` how the
TMA kernel splits each query tile's key range over CTAs, from host ints
alone.  The wrappers count their launches in all and by variant.

C chunk queries sit at absolute positions [pos0, pos0+C); block j of the
table holds key positions [j*bs, (j+1)*bs); causal = key_pos <= q_pos,
and a sliding window additionally masks key_pos <= q_pos - window.
`alibi_slopes` [NH] f32 adds -slope[h] (q_pos - key_pos) to each score
qk/sqrt(D) (the slopes carry a model's 1/sqrt(D) where it adds the bias
before the scale, as Falcon-RW does); the kernels add it in f32 before
the running max, so the architectures differ in the slopes only.  Rows
c >= n_valid are padding: the caller drops them, and neither version
promises zeros there.  Every C >= 1 is served (the TPU kernel's VMEM
tile plan has no counterpart on the card).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build, _scratch

__all__ = ["paged_prefill_attention", "paged_prefill_reference",
           "prefill_variant", "prefill_plan", "tile_keys",
           "tma_block_size", "VARIANTS"]

NEG_INF = -1e30
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _I, _I, _I,
         _P, _I, _P)
_TMA_ARGS = (_P,) * 7 + (_I,) * 13 + (_P, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 96, 128)
VARIANTS = ("tma", "mma", "f32")
TILE = 64          # query rows of a TMA CTA, and keys of a tile
MAX_SPLITS = 16
CTAS_PER_SM = 2    # the TMA kernel's CTAs resident on one SM


def paged_prefill_reference(q, arena_k, arena_v, block_table, pos0,
                            n_valid, sliding_window: Optional[int] = None,
                            layer_idx=None, alibi_slopes=None):
    """Plain PyTorch version (dense gather, f32 softmax and products).

    q: [C, NH, D]; arena_k/v: [nb, bs, NKV, D], or the full
    [L, nb, bs, NKV, D] arena with `layer_idx`; block_table: [MB];
    pos0/n_valid: ints; `alibi_slopes`: [NH] f32 or None.  Returns
    [C, NH, D] in q.dtype."""
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
    if alibi_slopes is not None:
        dist = (q_pos - key_pos).clamp_min(0).float()
        s = s - alibi_slopes.to(q.device).float()[:, None, None] * dist
    mask = key_pos <= q_pos
    if sliding_window is not None:
        mask &= key_pos > q_pos - sliding_window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("ncm,mnd->cnd", p, vv)
    return out.to(q.dtype)


def tma_block_size(bs: int) -> bool:
    """Whether TMA can build 64-key tiles of pages of `bs` keys: one box a
    page at 8, 16, 32 (a box starts on the swizzle's 8-row repeat), part
    of one page at multiples of 64 (csrc/paged_tile.cuh)."""
    return bs in (8, 16, 32) or (bs >= TILE and bs % TILE == 0)


def prefill_variant(dtype, D: int, bs: int) -> str:
    """The kernel a call of `dtype`, head dim `D` and block size `bs` takes
    on the card: "f32" for float32; for bf16 "tma" where `tma_block_size`
    holds, else "mma".  Raises on what no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the paged prefill kernels take "
                        f"bf16 or f32")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS})")
    if dtype == torch.float32:
        return "f32"
    return "tma" if tma_block_size(bs) else "mma"


def tile_keys(qt: int, n_valid: int, pos0: int,
              window: Optional[int] = None,
              max_keys: Optional[int] = None) -> Tuple[int, int]:
    """[k_begin, k_end) of query tile `qt` (rows 64 qt .. 64 qt + 63): the
    window's start for its first query, and one past its last valid
    query, within the table's `max_keys` keys."""
    c0 = qt * TILE
    k_end = pos0 + min(c0 + TILE, n_valid)
    if max_keys is not None:
        k_end = min(k_end, max_keys)
    k_begin = max(0, pos0 + c0 - window + 1) if window else 0
    return k_begin, max(0, k_end)


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """The TMA kernel's grid: `splits` CTAs per (query tile, head);
    `ranges[qt][s]` is the key-tile range [j0, j1) (64 keys a tile) that
    split s of query tile qt walks, the kernel's own arithmetic."""
    q_tiles: int
    splits: int
    ranges: Tuple[Tuple[Tuple[int, int], ...], ...]

    def ctas(self, NH: int) -> int:
        return self.q_tiles * NH * self.splits


@functools.lru_cache(maxsize=1024)
def prefill_plan(C: int, n_valid: int, pos0: int,
                 window: Optional[int], NH: int, NKV: int, sms: int,
                 max_keys: Optional[int] = None) -> PrefillPlan:
    """How the TMA kernel splits each query tile's key range: as many
    splits as keep the (query tile, head, split) CTAs within one wave of
    CTAS_PER_SM on each of `sms` SMs (a second, partial wave would wait
    on the first), at most half the longest tile's key tiles (each split
    keeps two or more tiles to pipeline) and MAX_SPLITS.
    pos0 and n_valid are host ints, so the plan reads nothing from the
    device.  The G = NH / NKV heads of a kv head sit side by side in the
    grid whatever the plan."""
    if C < 1 or NH < 1 or NKV < 1 or NH % NKV:
        raise ValueError(f"C={C}, NH={NH}, NKV={NKV}")
    q_tiles = -(-C // TILE)
    spans = []
    for qt in range(q_tiles):
        k_begin, k_end = tile_keys(qt, n_valid, pos0, window, max_keys)
        t_lo = k_begin // TILE
        t_hi = -(-k_end // TILE) if k_end > k_begin else t_lo
        spans.append((t_lo, t_hi - t_lo))
    longest = max(n for _, n in spans)
    wave = CTAS_PER_SM * sms // (q_tiles * NH)
    splits = max(1, min(wave, longest // 2, MAX_SPLITS))
    ranges = tuple(
        tuple((t_lo + s * n // splits, t_lo + (s + 1) * n // splits)
              for s in range(splits)) for t_lo, n in spans)
    return PrefillPlan(q_tiles, splits, ranges)


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
    if arena_k.shape[-1] != D or D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS}, "
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


def named_variant(want: str, variant: Optional[str], what: str) -> str:
    """The kernel a call takes: the rule's `want`, or `variant` where it
    can take the call (the mma.sync kernels take every bf16 call the rule
    sends to "tma"); raises on a variant that cannot."""
    if variant is None:
        return want
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant != want and (variant, want) != ("mma", "tma"):
        raise ValueError(f"variant {variant!r} cannot take {what} (the "
                         f"rule names {want!r})")
    return variant


def launch(q, arena_k, arena_v, block_table, pos0, n_valid,
           sliding_window: Optional[int] = None, layer_idx=None,
           variant: Optional[str] = None, alibi_slopes=None):
    """Check the inputs and launch a kernel on `q`'s CUDA device (the one
    `prefill_variant` names, or `variant` where it can take the call),
    without counting the launch (the wrappers over it count theirs).
    Returns (out, the variant launched)."""
    from .paged_attention import check_extras
    _check(q, arena_k, arena_v, block_table, layer_idx, sliding_window)
    check_extras(q, sliding_window, alibi_slopes)
    slopes = None if alibi_slopes is None else alibi_slopes.data_ptr()
    C, NH, D = q.shape
    nb, bs, NKV = arena_k.shape[-4], arena_k.shape[-3], arena_k.shape[-2]
    MB = block_table.shape[0]
    variant = named_variant(prefill_variant(q.dtype, D, bs), variant,
                            f"{q.dtype} at head dim {D}, block size {bs}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "tma":
        L = arena_k.shape[0] if layer_idx is not None else 1
        plan = prefill_plan(C, int(n_valid), int(pos0),
                            None if sliding_window is None
                            else int(sliding_window), NH, NKV,
                            _scratch.sm_count(q.device), MB * bs)
        ws = tickets = None
        if plan.splits > 1:
            units = plan.q_tiles * NH
            ws = _scratch.buffer("prefill_ws", q.device, stream,
                                 units * plan.splits * 128 * (D // 2 + 4),
                                 torch.float32)
            tickets = _scratch.buffer("prefill_tickets", q.device, stream,
                                      units, torch.int32)
        fn = _build.function("paged_prefill", "dstt_paged_prefill_tma",
                             _TMA_ARGS)
        rc = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
                block_table.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), C, NH, NKV,
                D, L, nb, bs, MB, int(layer_idx or 0), int(pos0),
                int(n_valid), int(sliding_window or 0), plan.splits, slopes,
                stream)
    else:
        layer_off = (0 if layer_idx is None
                     else int(layer_idx) * nb * bs * NKV * D)
        fn = _build.function("paged_prefill", "dstt_paged_prefill", _ARGS)
        rc = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
                block_table.data_ptr(), out.data_ptr(), C, NH, NKV, D, nb,
                bs, MB, layer_off, int(pos0), int(n_valid),
                int(sliding_window or 0), slopes, _DTYPES[q.dtype], stream)
    _build.check(rc, f"paged prefill ({variant})")
    return out, variant


def count(wrapper, variant: str) -> None:
    """One launch of `variant` on `wrapper`'s counters."""
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


def paged_prefill_attention(q, arena_k, arena_v, block_table, pos0,
                            n_valid, sliding_window: Optional[int] = None,
                            layer_idx=None, variant: Optional[str] = None,
                            alibi_slopes=None):
    """Blocked-flash prefill (see module docstring); shapes as in
    `paged_prefill_reference`.  With `layer_idx`, arena_k/v keep their
    full [L, nb, bs, NKV, D] shape and the kernel reads the layer in
    place.  `variant` (the card only) names a kernel other than the
    rule's where it can take the call ("mma" for a bf16 call the rule
    sends to "tma"), and raises where it cannot.  `alibi_slopes` ([NH]
    f32 on the card) selects the kernels' bias build."""
    if q.device.type == "cpu":
        return paged_prefill_reference(q, arena_k, arena_v, block_table,
                                       pos0, n_valid, sliding_window,
                                       layer_idx, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"no paged prefill kernel for device {q.device}")
    out, used = launch(q, arena_k, arena_v, block_table, pos0, n_valid,
                       sliding_window, layer_idx, variant, alibi_slopes)
    count(paged_prefill_attention, used)
    return out


paged_prefill_attention.launches = 0
# launches per kernel (VARIANTS); a caller resets it with `launches`
paged_prefill_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
