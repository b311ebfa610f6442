"""Paged adapter pool: block-granular device residency for LoRA adapter
weights with a host spill tier.

Counterpart of `deepspeed_tpu/serving/tenancy/adapter_pool.py`, with the
same slots, residency policy, counters, epoch and int8 spill codes.  The
slot stacks are f32 torch tensors on the engine's device (`engine.device`,
the CPU for an engine without one); installing an adapter writes its slot
in place where the reference rebinds a new array, then re-attaches the
stacks to the engine as the reference does.

The reference's KV host-tier discipline applied to weights instead of KV:
adapter factors live in fixed slot stacks the engine's gather-LoRA
epilogue reads (`attach_lora`), residency is accounted in blocks of
`block_elems` elements, cold adapters DEMOTE to a host page store
(optionally int8-quantized at the per-(layer, block) scale grain —
ZeRO++'s spill/wire quantization, arxiv 2306.10209) and PROMOTE back on
demand, and a conservation audit runs beside the engine's KV
`audit_blocks`.  The admission contract mirrors KV blocks: the caller
`reserve()`s an adapter at admission — promoting it first if it
spilled — so an admitted request can NEVER fault on a missing adapter
mid-decode; pinned (reserved) adapters are not demotion victims.

Economics, not magic: when the HBM pool and host tier are both full,
the coldest unpinned adapter is dropped outright (loud counter, and a
later request for it fails at admission with `AdapterUnavailable`) —
the policy-visible degradation the tenancy config sizes against.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["AdapterError", "AdapterUnavailable", "AdapterPool"]


class AdapterError(RuntimeError):
    """Adapter registration / pool bookkeeping failure."""


class AdapterUnavailable(AdapterError):
    """The adapter is not (and cannot be made) resident: never
    registered, dropped under pressure, or every slot is pinned."""


def _quant_int8_pages(pages: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization of an adapter's host pages
    [L, P, block_elems], one vectorized pass, scale per (layer, block) —
    the reference's KV-tier spill grain.  Returns (codes int8, scales
    fp32 [L, P, 1]); numpy on the host, so the codes are the reference's
    bit for bit."""
    x = np.asarray(pages, np.float32)
    scale = np.abs(x).max(axis=2, keepdims=True) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return codes, scale


class AdapterPool:
    """Slot-stacked LoRA factors + block-granular residency accounting.

    `engine` must implement the multi-LoRA contract (`attach_lora` /
    `set_adapter` — probed loudly at construction, the ServeLoop
    capability discipline).  All adapters share one (L, K, r, H)
    geometry, locked by the first `register` (the slot stacks are two
    fixed arrays [L, slots, K, r] / [L, slots, r, H]; heterogeneous
    ranks would need per-rank pools).  `pool_blocks` bounds HBM
    residency; `host_blocks` bounds the spill tier; blocks are
    `block_elems` elements."""

    def __init__(self, engine, pool_blocks: int, block_elems: int = 4096,
                 host_blocks: int = 0, quant: str = "none"):
        if pool_blocks < 1:
            raise ValueError(
                f"adapter pool needs pool_blocks >= 1, got {pool_blocks} "
                f"(tenancy with no adapters needs no pool at all)")
        if block_elems < 1:
            raise ValueError(
                f"block_elems must be >= 1, got {block_elems}")
        if host_blocks < 0:
            raise ValueError(
                f"host_blocks must be >= 0, got {host_blocks}")
        if quant not in ("none", "int8"):
            raise ValueError(
                f"spill quant must be 'none' or 'int8', got {quant!r}")
        for method in ("attach_lora", "set_adapter"):
            if not hasattr(engine, method):
                raise ValueError(
                    f"adapter pool needs an engine with the multi-LoRA "
                    f"contract ({method}); {type(engine).__name__} has "
                    f"none — serving adapters on it would silently "
                    f"decode the base model")
        self.engine = engine
        self.device = torch.device(getattr(engine, "device", "cpu"))
        self.pool_blocks = pool_blocks
        self.block_elems = block_elems
        self.host_blocks = host_blocks
        self.quant = quant
        # geometry locked by the first register
        self._shape: Optional[Tuple[int, int, int, int]] = None
        self.blocks_per_adapter = 0
        self.slots = 0
        self._slot_a = None                    # f32 [L, slots, K, r]
        self._slot_b = None                    # f32 [L, slots, r, H]
        self._free_slots: list = []
        self._resident: Dict[str, int] = {}    # adapter -> slot
        self._pins: Dict[str, int] = {}        # adapter -> reservation count
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._host: Dict[str, dict] = {}       # adapter -> spilled pages
        self.host_used_blocks = 0
        # residency epoch: bumps on every resident-set change; the fleet
        # router's snapshot protocol (serving/fleet) gates republish on it
        self.epoch = 0
        # counters (telemetry gauges; monotonic)
        self.registered = 0
        self.demotes = 0
        self.promotes = 0
        self.dropped = 0

    # -- geometry ---------------------------------------------------------
    def _lock_shape(self, a: np.ndarray, b: np.ndarray) -> None:
        L, K, r = a.shape
        Lb, rb, H = b.shape
        if Lb != L or rb != r:
            raise AdapterError(
                f"factor shapes disagree: a {a.shape} needs b "
                f"[{L}, {r}, H], got {b.shape}")
        if self._shape is None:
            elems = L * (K * r + r * H)
            per_layer = K * r + r * H
            pages = -(-per_layer // self.block_elems)
            self._shape = (L, K, r, H)
            self._page_elems = pages * self.block_elems
            self.blocks_per_adapter = L * pages
            self.slots = self.pool_blocks // self.blocks_per_adapter
            if self.slots < 1:
                raise AdapterError(
                    f"adapter pool too small: one adapter needs "
                    f"{self.blocks_per_adapter} blocks ({elems} elements "
                    f"at {self.block_elems}/block), pool holds "
                    f"{self.pool_blocks}")
            self._slot_a = torch.zeros((L, self.slots, K, r),
                                       dtype=torch.float32,
                                       device=self.device)
            self._slot_b = torch.zeros((L, self.slots, r, H),
                                       dtype=torch.float32,
                                       device=self.device)
            self._free_slots = list(range(self.slots))
        elif self._shape != (L, K, r, H):
            raise AdapterError(
                f"adapter geometry {(L, K, r, H)} does not match the "
                f"pool's locked {self._shape} (one slot stack per "
                f"geometry; use a second pool for other ranks)")

    # -- host paging ------------------------------------------------------
    def _to_pages(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        L = a.shape[0]
        flat = np.concatenate(
            [a.reshape(L, -1), b.reshape(L, -1)], axis=1)
        pad = self._page_elems - flat.shape[1]
        if pad:
            flat = np.pad(flat, ((0, 0), (0, pad)))
        return flat.reshape(L, -1, self.block_elems)

    def _from_pages(self, pages: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
        L, K, r, H = self._shape
        flat = pages.reshape(L, -1)[:, :K * r + r * H]
        return (flat[:, :K * r].reshape(L, K, r),
                flat[:, K * r:].reshape(L, r, H))

    # -- residency --------------------------------------------------------
    @property
    def resident(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    @property
    def spilled(self) -> Tuple[str, ...]:
        return tuple(self._host)

    @property
    def hbm_used_blocks(self) -> int:
        return len(self._resident) * self.blocks_per_adapter

    def is_registered(self, adapter_id: str) -> bool:
        return adapter_id in self._resident or adapter_id in self._host

    def slot_of(self, adapter_id: str) -> int:
        if adapter_id not in self._resident:
            raise AdapterUnavailable(
                f"adapter {adapter_id!r} is not HBM-resident "
                f"(reserve() promotes before binding)")
        return self._resident[adapter_id]

    def register(self, adapter_id: str, a, b, scaling: float = 1.0) -> None:
        """Install a new adapter, HBM-resident.  a: [L, K, r] down
        factors; b: [L, r, H] up factors; `scaling` (LoRA alpha/r) is
        folded into b here so the serving epilogue needs no per-adapter
        scale operand."""
        if self.is_registered(adapter_id):
            raise AdapterError(
                f"adapter {adapter_id!r} already registered (drop() it "
                f"first to replace — silent overwrite would change a "
                f"live tenant's math)")
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32) * np.float32(scaling)
        self._lock_shape(a, b)
        slot = self._take_slot(adapter_id)
        self._install(adapter_id, slot, a, b)
        self.registered += 1

    def _take_slot(self, needer: str) -> int:
        if self._free_slots:
            return self._free_slots.pop()
        victim = next((aid for aid in self._lru
                       if self._pins.get(aid, 0) == 0), None)
        if victim is None:
            raise AdapterUnavailable(
                f"no adapter slot for {needer!r}: all {self.slots} "
                f"resident adapters are pinned by admitted requests — "
                f"admission sizes itself against this (the request "
                f"waits, nothing faults mid-decode)")
        self._demote(victim)
        return self._free_slots.pop()

    def _install(self, adapter_id: str, slot: int, a: np.ndarray,
                 b: np.ndarray) -> None:
        # written in place (the reference rebinds the stacks to new
        # arrays); a slot is only rewritten while no admitted row is bound
        # to it, so no serving call reads the bytes that change
        self._slot_a[:, slot] = torch.from_numpy(
            np.ascontiguousarray(a)).to(self.device)
        self._slot_b[:, slot] = torch.from_numpy(
            np.ascontiguousarray(b)).to(self.device)
        self._resident[adapter_id] = slot
        self._lru[adapter_id] = None
        self.epoch += 1
        self.engine.attach_lora({"a": self._slot_a, "b": self._slot_b})

    def _demote(self, adapter_id: str) -> None:
        """Move a resident adapter's weights HBM -> host pages (one
        batched fetch), or drop it outright when the host tier cannot
        hold it.  Never called on a pinned adapter."""
        slot = self._resident.pop(adapter_id)
        self._lru.pop(adapter_id, None)
        # one fetch per factor, outside the engine's d2h ledger (as in
        # the reference)
        a = self._slot_a[:, slot].cpu().numpy()
        bmat = self._slot_b[:, slot].cpu().numpy()
        self._free_slots.append(slot)
        self.epoch += 1
        pages = self._to_pages(a, bmat)
        n_blocks = pages.shape[0] * pages.shape[1]
        if self.host_used_blocks + n_blocks > self.host_blocks:
            self.dropped += 1
            return
        if self.quant == "int8":
            codes, scales = _quant_int8_pages(pages)
            self._host[adapter_id] = {"codes": codes, "scales": scales,
                                      "n": n_blocks}
        else:
            self._host[adapter_id] = {"pages": pages, "n": n_blocks}
        self.host_used_blocks += n_blocks
        self.demotes += 1

    def _promote(self, adapter_id: str) -> None:
        entry = self._host[adapter_id]
        if "codes" in entry:
            pages = (entry["codes"].astype(np.float32) * entry["scales"])
        else:
            pages = entry["pages"]
        a, b = self._from_pages(pages)
        slot = self._take_slot(adapter_id)
        # pop AFTER _take_slot: a failed eviction (everything pinned)
        # must leave the spilled copy in place, not strand the adapter
        del self._host[adapter_id]
        self.host_used_blocks -= entry["n"]
        self._install(adapter_id, slot, a, b)
        self.promotes += 1

    def drop(self, adapter_id: str) -> None:
        """Forget an adapter entirely (tenant offboarding).  Refuses
        while reservations pin it."""
        if self._pins.get(adapter_id, 0) > 0:
            raise AdapterError(
                f"adapter {adapter_id!r} is pinned by "
                f"{self._pins[adapter_id]} admitted request(s); drain "
                f"them before dropping it")
        if adapter_id in self._resident:
            slot = self._resident.pop(adapter_id)
            self._lru.pop(adapter_id, None)
            self._free_slots.append(slot)
            self.epoch += 1
        elif adapter_id in self._host:
            self.host_used_blocks -= self._host.pop(adapter_id)["n"]
        else:
            raise AdapterUnavailable(
                f"adapter {adapter_id!r} is not registered")

    # -- admission contract ----------------------------------------------
    def can_reserve(self, adapter_id: str) -> bool:
        """Affordability pre-check for the serve loop's `fits`: True
        when `reserve` would succeed NOW (resident, or spilled with an
        evictable slot).  Unknown adapters are not a capacity question —
        `reserve` raises AdapterUnavailable for those (the request
        fails loudly instead of queueing forever)."""
        if adapter_id in self._resident:
            return True
        if adapter_id not in self._host:
            return False
        return (bool(self._free_slots)
                or any(self._pins.get(aid, 0) == 0 for aid in self._lru))

    def reserve(self, adapter_id: str) -> int:
        """Pin the adapter HBM-resident for one admitted request,
        promoting it from the host tier first if needed.  Returns the
        slot (the engine `set_adapter` binding).  Raises
        AdapterUnavailable when it cannot be made resident."""
        if adapter_id in self._host:
            self._promote(adapter_id)
        if adapter_id not in self._resident:
            raise AdapterUnavailable(
                f"adapter {adapter_id!r} is not registered on this "
                f"replica (or was dropped under pool pressure) — "
                f"register it before submitting requests for it")
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1
        self._lru.move_to_end(adapter_id)
        return self._resident[adapter_id]

    def release(self, adapter_id: str) -> None:
        """Drop one reservation (request finished / rolled back)."""
        n = self._pins.get(adapter_id, 0)
        if n <= 0:
            raise AdapterError(
                f"release of unreserved adapter {adapter_id!r} — a "
                f"double release would unpin a live request's weights")
        if n == 1:
            del self._pins[adapter_id]
        else:
            self._pins[adapter_id] = n - 1

    # -- fleet snapshot protocol (serving/fleet) --------------------------
    def digest(self) -> Tuple[int, int]:
        """Cheap change stamp, the PrefixCache.digest() shape: equal
        digests => identical snapshot content."""
        return (self.epoch, len(self._resident))

    def snapshot(self) -> dict:
        """Epoch-gated residency view for adapter-aware routing:
        requests should land where their adapter is already resident
        (spilled = promotable, scored below resident)."""
        return {"epoch": self.epoch,
                "resident": tuple(sorted(self._resident)),
                "spilled": tuple(sorted(self._host))}

    # -- audit / telemetry ------------------------------------------------
    def audit(self) -> Dict[str, int]:
        """Conservation: slots and host blocks must account exactly;
        pins only on resident adapters.  Raises RuntimeError on drift
        (a pool bookkeeping bug); returns the summary when clean —
        the serve loop runs this beside `engine.audit_blocks()`."""
        used = len(self._resident)
        if used + len(self._free_slots) != self.slots:
            raise RuntimeError(
                f"adapter pool slot conservation violated: "
                f"{used} resident + {len(self._free_slots)} free != "
                f"{self.slots} slots")
        if len(set(self._resident.values())) != used:
            raise RuntimeError("adapter pool slot aliasing: two "
                               "adapters share a slot")
        host = sum(e["n"] for e in self._host.values())
        if host != self.host_used_blocks:
            raise RuntimeError(
                f"adapter host tier conservation violated: gauge says "
                f"{self.host_used_blocks} blocks, entries hold {host}")
        if self.host_used_blocks > self.host_blocks:
            raise RuntimeError(
                f"adapter host tier over budget: "
                f"{self.host_used_blocks} > {self.host_blocks}")
        for aid, n in self._pins.items():
            if n > 0 and aid not in self._resident:
                raise RuntimeError(
                    f"adapter {aid!r} holds {n} reservation(s) but is "
                    f"not resident — the never-fault admission "
                    f"contract is broken")
        return {"adapter_slots": self.slots,
                "adapter_resident": used,
                "adapter_hbm_blocks": self.hbm_used_blocks,
                "adapter_host_blocks": self.host_used_blocks}

    def stats(self) -> Dict[str, int]:
        """Telemetry view (ServingTelemetry.record_step adapter_pool=)."""
        return {
            "adapter_pool_blocks": self.pool_blocks,
            "adapter_hbm_blocks": self.hbm_used_blocks,
            "adapter_host_max_blocks": self.host_blocks,
            "adapter_host_blocks": self.host_used_blocks,
            "adapter_resident": len(self._resident),
            "adapter_spilled": len(self._host),
            "adapter_demotes": self.demotes,
            "adapter_promotes": self.promotes,
            "adapter_dropped": self.dropped,
        }
