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

The ids are host data (the engine plans each serving call on the host).
The kernel groups the rows by slot; a `LoraRows` builds that grouping
once and copies it to the card in one transfer, so a serving call makes
one for all its layers and passes it as `adapter_ids`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["lora_delta", "lora_delta_reference", "lora_delta_supported",
           "pad_lora_rank", "LoraRows", "MAX_RANK"]

# the kernel's largest rank (four columns of r per lane of a warp)
MAX_RANK = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P)
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


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LoraRows:
    """One serving call's adapter rows: the host ids [S] and, built on
    first use for the kernel, the rows grouped by slot in one int32 buffer
    on the card: `perm` [S] (sorted position -> row; rows sorted by slot,
    stably) then `tiles` [T, 3] (slot, first sorted position, rows), at
    most the kernel's tile height of rows a tile; slot -1 tiles hold the
    base rows.  A serving call builds one and passes it to every layer's
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

    def kernel_plan(self, device):
        """(plan buffer on `device`, number of tiles), built once."""
        device = torch.device(device)
        if self._plan is None or self._plan[0].device != device:
            tr = _build.function("lora_delta", "dstt_lora_delta_tile_rows",
                                 ())()
            key = np.where(self.ids < 0, -1, self.ids)
            perm = np.argsort(key, kind="stable").astype(np.int32)
            sid = key[perm]
            starts = np.flatnonzero(np.r_[True, sid[1:] != sid[:-1]])
            ends = np.r_[starts[1:], self.S]
            tiles = [(int(sid[s]), p, min(tr, e - p))
                     for s, e in zip(starts, ends) for p in range(s, e, tr)]
            buf = np.concatenate([perm, np.asarray(tiles, np.int32).ravel()])
            self._plan = (torch.from_numpy(buf).to(device), len(tiles))
        return self._plan


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


def lora_delta(x, lora_a, lora_b, adapter_ids, *, scaling: float = 1.0):
    """Per-row low-rank delta, f32 [S, N] (see module docstring).

    x: [S, K] batch rows; lora_a: [num_slots, K, r]; lora_b: [num_slots,
    r, N]; adapter_ids: [S] slot per row (< 0 = base row, delta exactly
    0.0) as host data, or a `LoraRows` of them."""
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
    rows = LoraRows.of(adapter_ids)
    _check(x, lora_a, lora_b, rows)
    out = torch.empty(S, N, dtype=torch.float32, device=x.device)
    if S == 0:
        return out
    plan, n_tiles = rows.kernel_plan(x.device)
    k_span = _build.function("lora_delta", "dstt_lora_delta_k_span", ())()
    # the shrink pass's partial sums, one [S, r] slab per K span
    hp = torch.empty(-(-K // k_span) * S * r, dtype=torch.float32,
                     device=x.device)
    fn = _build.function("lora_delta", "dstt_lora_delta", _ARGS)
    rc = fn(x.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
            plan.data_ptr(), hp.data_ptr(), out.data_ptr(), S, K, N, r,
            n_tiles, float(scaling), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "LoRA delta")
    lora_delta.launches += 1
    return out


lora_delta.launches = 0
