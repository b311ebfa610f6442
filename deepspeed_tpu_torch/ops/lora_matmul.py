"""Gather-LoRA epilogue of multi-tenant ragged serving.

Counterpart of `deepspeed_tpu/ops/lora_matmul.py`.  One base model serves
many LoRA adapters from one continuous batch: row s of the batch carries
an adapter slot id[s], and

    y[s] = scaling * (x[s] @ A[id[s]]) @ B[id[s]]      (id[s] >= 0)
    y[s] = 0.0                                         (id[s] < 0)

as f32 [S, N].  A base row's delta is exactly 0.0 — a masked select or an
explicit zero store, never `0 * x`, which would carry a NaN through — so
rows without an adapter serve exactly what the base model serves.

The kernel is `csrc/lora_delta.cu` (hand-written CUDA for sm_90a, bound
with ctypes); `lora_delta_reference` is the plain PyTorch version, the
reference's jnp escape: a per-row gather of the factors, two f32 einsums,
then the mask.  `lora_delta` runs the plain version for tensors on the
CPU and the kernel for tensors on a CUDA device.

Two kernels compute it, named by `variant` (`lora_delta
.launches_by_variant` counts each):
- "fused" (every call by default): one launch whose persistent CTAs take
  work items from one counter, first each adapter tile's K spans
  (partial h), then each tile's N spans (`work_items` lists them in the
  kernel's order), fed by 1-D bulk copies; an expand item waits for its
  tile's partials and sums them in span order;
- "two_pass": the first port's shrink and expand launches, kept so that
  the two can be timed side by side.
Both keep their scratch (partials, counters) in `_scratch`'s cached
buffers, so no call allocates but its output.

The ids are host data (the engine plans each serving call on the host).
The kernel groups the rows by slot; a `LoraRows` builds that grouping
once and copies it to the card in one transfer, so a serving call makes
one for all its layers and passes it as `adapter_ids`.  A captured decode
program binds its own device buffers instead (`LoraRows.bind`), which
the host refills before each replay.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build, _scratch

__all__ = ["lora_delta", "lora_delta_reference", "lora_delta_supported",
           "pad_lora_rank", "work_items", "LoraRows", "MAX_RANK",
           "VARIANTS"]

# the kernels' largest rank
MAX_RANK = 128
# rows a tile (one slot's rows, at most this many), the fused kernel's
# span (K rows of a shrink item, N columns of an expand item) and the
# two-pass kernel's K rows a shrink CTA (its partials' slabs): the
# kernels refuse a call whose view of these differs from their own
TILE_ROWS = 16
SPAN = 256
TWO_PASS_K_SPAN = 512
# resident CTAs an SM the fused kernel asks for (its launch bound)
FUSED_CTAS_PER_SM = 2
VARIANTS = ("fused", "two_pass")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUSED_ARGS = (_P,) * 7 + (_I,) * 9 + (_F, _I, _I, _P)
_TWO_PASS_ARGS = (_P,) * 6 + (_I,) * 7 + (_F, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pad_lora_rank(r: int) -> int:
    """The rank the kernel contracts over: r itself.  The TPU kernel pads
    the rank up to its 128-lane matrix tile; the card has no such tile
    (the kernel masks the ragged edges of r, K and N), so nothing is
    padded.  Kept for readers of the reference."""
    if r < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {r}")
    return r


def lora_delta_supported(S: int, K: int, N: int, num_slots: int) -> bool:
    """Shapes the kernel serves: any S, K, N >= 1 and one or more slots
    (the TPU kernel's 128-lane and VMEM limits have no counterpart; the
    rank must be 1..MAX_RANK, which the wrapper checks)."""
    return S >= 1 and K >= 1 and N >= 1 and num_slots >= 1


def work_items(n_tiles: int, n_base: int, K: int, N: int):
    """The fused kernel's work items in the order its counter hands them
    out: ("shrink", tile, K span) of every adapter tile (tiles n_base ..
    n_tiles - 1, the base tiles first in the plan), tile-major, then
    ("expand", tile, N span) of every tile; spans of SPAN rows or
    columns."""
    ks, ns = -(-K // SPAN), -(-N // SPAN)
    return ([("shrink", t, k) for t in range(n_base, n_tiles)
             for k in range(ks)]
            + [("expand", t, n) for t in range(n_tiles) for n in range(ns)])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LoraRows:
    """One serving call's adapter rows: the host ids [S] and, built on
    first use for the kernel, the rows grouped by slot in one int32 buffer
    on the card: `perm` [S] (sorted position -> row; rows sorted by slot,
    stably) then `tiles` [T, 3] (slot, first sorted position, rows), at
    most TILE_ROWS rows a tile; slot -1 tiles hold the base rows and come
    first.  A serving call builds one and passes it to every layer's
    `lora_delta`, so the grouping and its copy happen once a call."""

    @classmethod
    def of(cls, adapter_ids) -> "LoraRows":
        """`adapter_ids` itself if it is a LoraRows, else one built from
        those host ids."""
        return adapter_ids if isinstance(adapter_ids, cls) else cls(
            adapter_ids)

    def __init__(self, adapter_ids):
        ids = _host(adapter_ids).astype(np.int32).ravel()
        self.ids = ids
        self.S = ids.size
        self.max_id = int(ids.max()) if ids.size else -1
        self._ids_t = None
        self._plan = None

    def ids_on(self, device) -> torch.Tensor:
        """The ids as an int64 tensor on `device` (the plain version's
        gather index; copied once)."""
        device = torch.device(device)
        if self._ids_t is None or self._ids_t.device != device:
            self._ids_t = torch.from_numpy(self.ids.astype(np.int64)).to(
                device)
        return self._ids_t

    def tiles(self):
        """(perm [S], tiles [T, 3] int32, base tiles): the grouping by
        slot, base rows (slot -1) sorting first."""
        key = np.where(self.ids < 0, -1, self.ids)
        perm = np.argsort(key, kind="stable").astype(np.int32)
        sid = key[perm]
        starts = np.flatnonzero(np.r_[True, sid[1:] != sid[:-1]])
        ends = np.r_[starts[1:], self.S]
        tiles = np.asarray(
            [(int(sid[s]), p, min(TILE_ROWS, e - p))
             for s, e in zip(starts, ends) for p in range(s, e, TILE_ROWS)],
            np.int32).reshape(-1, 3)
        return perm, tiles, int((tiles[:, 0] < 0).sum())

    def plan_host(self):
        """(plan buffer [S + 3 T + T (4 + TILE_ROWS)] int32 numpy, tiles
        T, base tiles): `perm`, `tiles`, then the fused kernel's tile
        records [T, 4 + TILE_ROWS] (slot, first sorted position, rows, 0,
        the rows' perm entries), which its producer warp reads in one
        go."""
        perm, tiles, n_base = self.tiles()
        recs = np.zeros((len(tiles), 4 + TILE_ROWS), np.int32)
        recs[:, :3] = tiles
        for t, (_, p0, rows) in enumerate(tiles.tolist()):
            recs[t, 4:4 + rows] = perm[p0:p0 + rows]
        return (np.concatenate([perm, tiles.ravel(), recs.ravel()]),
                len(tiles), n_base)

    def kernel_plan(self, device):
        """(plan buffer on `device`, number of tiles, base tiles), built
        and copied once (`plan_host`)."""
        device = torch.device(device)
        if self._plan is None or self._plan[0].device != device:
            buf, n_tiles, n_base = self.plan_host()
            self._plan = (torch.from_numpy(buf).to(device), n_tiles, n_base)
        return self._plan

    def bind(self, plan: torch.Tensor, ids: torch.Tensor) -> "LoraRows":
        """Take `plan` (int32, laid out as `plan_host`) and `ids` (int64),
        device buffers that already hold this call's rows, as its device
        copies: a captured decode program refills them from the host
        before each replay, and nothing is copied inside the capture."""
        n_tiles, n_base = self.plan_host()[1:]
        self._plan = (plan, n_tiles, n_base)
        self._ids_t = ids
        return self



def lora_delta_reference(x, lora_a, lora_b, adapter_ids, scaling=1.0):
    """Plain PyTorch version (the reference's jnp escape): ids clamped for
    the gather, the mask — not the clamp — decides who contributes.
    x: [S, K]; lora_a: [slots, K, r]; lora_b: [slots, r, N]; adapter_ids:
    [S] host ids or a `LoraRows`.  Returns f32 [S, N]."""
    ids = LoraRows.of(adapter_ids).ids_on(x.device)
    safe = ids.clamp(0, lora_a.shape[0] - 1)
    a = lora_a[safe].float()                               # [S, K, r]
    h = torch.einsum("sk,skr->sr", x.float(), a)
    b = lora_b[safe].float()                               # [S, r, N]
    out = torch.einsum("sr,srn->sn", h, b)
    out = torch.where(ids[:, None] >= 0, out,
                      torch.zeros((), device=x.device))
    return out * scaling if scaling != 1.0 else out


def _check(x, lora_a, lora_b, rows):
    dev = x.device
    for name, t in (("lora_a", lora_a), ("lora_b", lora_b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} (kernel takes bf16 or f32)")
    if lora_a.dtype != torch.float32 or lora_b.dtype != torch.float32:
        raise TypeError("LoRA factors must be f32 (the adapter pool's slot "
                        "stacks)")
    r = lora_a.shape[2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} (kernel takes 1..{MAX_RANK})")
    if rows.S != x.shape[0]:
        raise ValueError(f"{rows.S} adapter ids for {x.shape[0]} rows")
    if rows.max_id >= lora_a.shape[0]:
        raise ValueError(f"adapter slot {rows.max_id} out of range "
                         f"({lora_a.shape[0]} slots)")
    for name, t in (("x", x), ("lora_a", lora_a), ("lora_b", lora_b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lora_delta(x, lora_a, lora_b, adapter_ids, *, scaling: float = 1.0,
               variant: Optional[str] = None):
    """Per-row low-rank delta, f32 [S, N] (see module docstring).

    x: [S, K] batch rows; lora_a: [num_slots, K, r]; lora_b: [num_slots,
    r, N]; adapter_ids: [S] slot per row (< 0 = base row, delta exactly
    0.0) as host data, or a `LoraRows` of them; `variant` one of VARIANTS
    (default "fused")."""
    S, K = x.shape
    A, Ka, r = lora_a.shape
    Ab, rb, N = lora_b.shape
    if Ka != K or Ab != A or rb != r:
        raise ValueError(
            f"LoRA factor shapes disagree: x [{S},{K}], lora_a "
            f"[{A},{Ka},{r}], lora_b [{Ab},{rb},{N}] (need a "
            f"[slots,K,r] / [slots,r,N] stack over one slot axis)")
    if x.device.type == "cpu":
        return lora_delta_reference(x, lora_a, lora_b, adapter_ids, scaling)
    if x.device.type != "cuda":
        raise ValueError(f"no LoRA kernel for device {x.device}")
    variant = "fused" if variant is None else variant
    if variant not in VARIANTS:
        raise ValueError(f"LoRA variant {variant!r} (one of {VARIANTS})")
    rows = LoraRows.of(adapter_ids)
    _check(x, lora_a, lora_b, rows)
    out = torch.empty(S, N, dtype=torch.float32, device=x.device)
    if S == 0:
        return out
    plan, n_tiles, n_base = rows.kernel_plan(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if variant == "fused":
        # each adapter tile's partial h [TILE_ROWS, r] per K span, and the
        # counters (work, one a tile), found zero and left zero
        hp = _scratch.buffer("lora_hp", x.device, stream, max(
            (n_tiles - n_base) * -(-K // SPAN) * TILE_ROWS * r, 1),
            torch.float32)
        ctr = _scratch.buffer("lora_ctr", x.device, stream,
                              1 + n_tiles, torch.int32)
        fn = _build.function("lora_delta", "dstt_lora_delta", _FUSED_ARGS)
        rc = fn(x.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
                plan.data_ptr(), hp.data_ptr(), ctr.data_ptr(),
                out.data_ptr(), S, K, N, r, n_tiles, n_base, TILE_ROWS, SPAN,
                ctr.numel(), float(scaling), _DTYPES[x.dtype],
                FUSED_CTAS_PER_SM * _scratch.sm_count(x.device), stream)
    else:
        # the shrink pass's partial sums, one [S, r] slab per K span
        hp = _scratch.buffer("lora_hp_two_pass", x.device, stream,
                             -(-K // TWO_PASS_K_SPAN) * S * r, torch.float32)
        fn = _build.function("lora_delta", "dstt_lora_delta_two_pass",
                             _TWO_PASS_ARGS)
        rc = fn(x.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
                plan.data_ptr(), hp.data_ptr(), out.data_ptr(), S, K, N, r,
                n_tiles, TILE_ROWS, TWO_PASS_K_SPAN, float(scaling),
                _DTYPES[x.dtype], stream)
    _build.check(rc, f"LoRA delta ({variant})")
    lora_delta.launches += 1
    lora_delta.launches_by_variant[variant] += 1
    return out


lora_delta.launches = 0
# launches per kernel (VARIANTS), reset with `launches`
lora_delta.launches_by_variant = dict.fromkeys(VARIANTS, 0)
