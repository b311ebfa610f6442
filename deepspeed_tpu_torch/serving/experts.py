"""Expert-paged decode: slotted device residency for MoE expert weights.

Counterpart of `deepspeed_tpu/serving/experts.py`, with the same slots,
residency policy, counters, census handling, audit and int8 spill codes.
Each layer's expert FFN tensors live in fixed slot stacks `moe_*_slots`
[L, S, ...] holding only S <= E resident experts, beside a per-layer
`moe_slot_map` [L, E] int32 (expert -> slot, -1 when demoted) and
`moe_resident_mask` [L, E] bool, all spliced into `params["layers"]`, so
every serving program's `_moe_inference` groups its tokens by slot and
runs the grouped GEMM over the slot stacks.

Where the reference rebinds new arrays on every change, the port writes
in place (`copy_` into the same storage): a captured decode group reads
the stacks, the map and the mask by address, so a promote or a demote
between two replays is what the next replay reads, with no recapture.

Residency mechanics (the reference's):

- The canonical copy of every expert lives on the host from
  construction, taken once, in pinned memory when the engine is on the
  card (`spill="int8"`: int8 codes with a scale per (layer, expert), a
  lossy copy, opt-in).  Demotion is bookkeeping only: free the slot,
  clear the map and the mask.  Pool pressure degrades to rerouting (the
  router masks non-resident experts, counted in the census), never to a
  faulted request.
- A promote writes one expert into a free (or least recently used) slot
  of its layer: one host-to-device copy per weight tensor.
- `reserve(layer, expert)` pins an expert for a dispatch lifetime
  (promoting it first); pinned experts are never demotion victims;
  `release` drops the pin.
- The decode programs accumulate the router census in the arena
  ("moe_census" [L, E+1]); `ingest_census` folds one drained census
  into the per-layer LRU ranking and the counters, and `rebalance()`
  promotes the hottest demoted experts over the coldest residents.
- `audit()` checks slot conservation and that the device map and mask
  agree with the host bookkeeping.

With S == E every expert sits in its home slot (the map is the
identity, the mask all true) and the paged math is bit for bit the
unpaged model's.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["ExpertError", "ExpertUnavailable", "ExpertPool"]


class ExpertError(RuntimeError):
    """Expert pool bookkeeping / capability failure."""


class ExpertUnavailable(ExpertError):
    """The expert cannot be made resident (every slot pinned)."""


def _quant_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8, scale per leading-dim row (the reference's spill
    grain).  Returns (codes, scales); numpy on the host, so the codes are
    the reference's bit for bit."""
    flat = x.reshape(x.shape[0], -1)
    scale = np.abs(flat).max(axis=1, keepdims=True) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    codes = np.clip(np.rint(flat / scale), -127, 127).astype(np.int8)
    return codes.reshape(x.shape), scale


def _dequant_int8(codes: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """f32 values of int8 codes with their per-row scales."""
    flat = codes.reshape(codes.shape[0], -1).astype(np.float32) * scale
    return flat.reshape(codes.shape)


class ExpertPool:
    """Slot-stacked expert FFN weights with LRU demotion to the host.

    Built by `engine.enable_expert_paging(slots_per_layer, spill=...)`:
    the engine's probe (`supports_moe`) and the params splice live
    there; the pool owns the residency policy and the device slot
    tensors.  It keeps the engine's layer dict, not the engine: the
    engine holds its pool, and a reference back would make a cycle that
    keeps tens of GB on the card until Python's cycle collector runs."""

    _WKEYS = ("moe_w_up", "moe_w_down", "moe_w_gate_proj")

    def __init__(self, engine, slots_per_layer: int, spill: str = "none"):
        if spill not in ("none", "int8"):
            raise ValueError(
                f"expert spill must be 'none' or 'int8', got {spill!r}")
        cfg = engine.cfg
        E, L = cfg.moe_experts, cfg.num_layers
        if E <= 1:
            raise ExpertError(
                "expert paging needs an MoE model (moe_experts > 1)")
        if not (cfg.moe_top_k <= slots_per_layer <= E):
            raise ValueError(
                f"slots_per_layer must be in [top_k={cfg.moe_top_k}, "
                f"E={E}], got {slots_per_layer} (fewer slots than top_k "
                f"would force reroutes on EVERY token)")
        self.top_k = cfg.moe_top_k
        self.num_experts = E
        self.num_layers = L
        self.slots = slots_per_layer
        self.spill = spill

        layers = engine.params["layers"]
        self._layers = layers
        if "moe_w_up" not in layers or "moe_w_down" not in layers:
            raise ExpertError(
                "params['layers'] carries no moe_w_up/moe_w_down stacks "
                "(already paged, or not an MoE parameterization)")
        dev = layers["moe_w_up"].device
        self._dtype = layers["moe_w_up"].dtype
        pin = dev.type == "cuda"
        # canonical host copies [L, E, ...], taken once (demotion is
        # bookkeeping); the initial slots 0..S-1 hold experts 0..S-1
        self._host: Dict[str, dict] = {}
        self._w_slots: Dict[str, torch.Tensor] = {}
        for key in self._WKEYS:
            if key not in layers:
                continue
            w = layers[key]
            if spill == "int8":
                codes, scales = _quant_int8(
                    w.float().cpu().numpy().reshape(L * E, -1))
                self._host[key] = {"codes": codes.reshape(w.shape),
                                   "scales": scales.reshape(L, E, 1)}
                init = _dequant_int8(codes, scales).reshape(w.shape)
                self._w_slots[key] = torch.from_numpy(
                    init[:, :self.slots]).to(device=dev, dtype=self._dtype)
            else:
                host = torch.empty(w.shape, dtype=w.dtype, pin_memory=pin)
                host.copy_(w)
                self._host[key] = {"pages": host}
                self._w_slots[key] = w[:, :self.slots].clone()
            del w

        self._resident: List[Dict[int, int]] = [
            {e: e for e in range(self.slots)} for _ in range(L)]
        self._free: List[List[int]] = [[] for _ in range(L)]
        self._pins: List[Dict[int, int]] = [{} for _ in range(L)]
        self._lru: List["OrderedDict[int, None]"] = [
            OrderedDict((e, None) for e in range(self.slots))
            for _ in range(L)]
        self._slot_map = np.full((L, E), -1, np.int32)
        self._slot_map[:, :self.slots] = np.arange(self.slots, dtype=np.int32)
        self._mask = np.zeros((L, E), bool)
        self._mask[:, :self.slots] = True
        # the device map and mask, written in place by every publish
        self._dev_map = torch.from_numpy(self._slot_map.copy()).to(dev)
        self._dev_mask = torch.from_numpy(self._mask.copy()).to(dev)

        # counters (monotonic; the serving/expert/* gauges)
        self.demotes = 0
        self.promotes = 0
        self.routed = 0
        self.rerouted = 0
        self._last_census = np.zeros((L, E), np.int64)
        self.epoch = 0
        pages = {f"{k}_slots": v for k, v in self._w_slots.items()}
        pages["moe_slot_map"] = self._dev_map
        pages["moe_resident_mask"] = self._dev_mask
        engine._install_expert_pages(pages)

    # -- host tier --------------------------------------------------------
    def _expert_host(self, key: str, layer: int, expert: int
                     ) -> torch.Tensor:
        """One expert's canonical tensor on the host: the pinned page, or
        its int8 codes dequantized in f32 and cast to the slots' dtype."""
        entry = self._host[key]
        if "pages" in entry:
            return entry["pages"][layer, expert]
        w = _dequant_int8(entry["codes"][layer, expert][None],
                          entry["scales"][layer, expert][None])[0]
        return torch.from_numpy(w).to(self._dtype)

    # -- device publish ---------------------------------------------------
    def _publish(self) -> None:
        """Write the current map and mask into the installed device
        tensors, in place (the slot stacks were written by `_promote`)."""
        self._dev_map.copy_(torch.from_numpy(self._slot_map))
        self._dev_mask.copy_(torch.from_numpy(self._mask))

    # -- residency --------------------------------------------------------
    def is_resident(self, layer: int, expert: int) -> bool:
        return expert in self._resident[layer]

    def resident_count(self) -> int:
        return sum(len(r) for r in self._resident)

    def spilled_count(self) -> int:
        return (self.num_layers * self.num_experts) - self.resident_count()

    def pinned_count(self) -> int:
        return sum(len(p) for p in self._pins)

    def _take_slot(self, layer: int, needer: int) -> int:
        if self._free[layer]:
            return self._free[layer].pop()
        victim = next((e for e in self._lru[layer]
                       if self._pins[layer].get(e, 0) == 0), None)
        if victim is None:
            raise ExpertUnavailable(
                f"no slot for expert {needer} in layer {layer}: all "
                f"{self.slots} resident experts are pinned by in-flight "
                f"dispatches — release them (or size slots_per_layer up)")
        self._evict(layer, victim)
        return self._free[layer].pop()

    def _evict(self, layer: int, expert: int) -> None:
        """Demote bookkeeping: free the slot, mask the router.  The
        canonical copy already lives on the host, so nothing moves."""
        slot = self._resident[layer].pop(expert)
        self._lru[layer].pop(expert, None)
        self._free[layer].append(slot)
        self._slot_map[layer, expert] = -1
        self._mask[layer, expert] = False
        self.demotes += 1
        self.epoch += 1

    def demote(self, layer: int, expert: int) -> None:
        """Explicitly demote one expert.  Refuses pinned experts — a
        dispatch is routing into that slot."""
        if self._pins[layer].get(expert, 0) > 0:
            raise ExpertError(
                f"expert ({layer}, {expert}) is pinned by "
                f"{self._pins[layer][expert]} dispatch(es); demoting it "
                f"mid-dispatch would reroute tokens already admitted")
        if expert not in self._resident[layer]:
            raise ExpertError(
                f"expert ({layer}, {expert}) is not resident")
        if len(self._resident[layer]) <= self.top_k:
            raise ExpertError(
                f"layer {layer} would drop below top_k="
                f"{self.top_k} resident experts — the "
                f"router could not place every assignment")
        self._evict(layer, expert)
        self._publish()

    def _promote(self, layer: int, expert: int) -> None:
        slot = self._take_slot(layer, expert)
        for key, stack in self._w_slots.items():
            # one host-to-device copy into the slot, in place
            stack[layer, slot].copy_(self._expert_host(key, layer, expert),
                                     non_blocking=True)
        self._resident[layer][expert] = slot
        self._lru[layer][expert] = None
        self._slot_map[layer, expert] = slot
        self._mask[layer, expert] = True
        self.promotes += 1
        self.epoch += 1

    def promote(self, layer: int, expert: int) -> None:
        """Make one expert resident (no pin)."""
        if expert >= self.num_experts or expert < 0:
            raise ExpertError(f"no such expert {expert}")
        if expert in self._resident[layer]:
            self._lru[layer].move_to_end(expert)
            return
        self._promote(layer, expert)
        self._publish()

    # -- dispatch contract ------------------------------------------------
    def reserve(self, layer: int, expert: int) -> int:
        """Pin an expert resident for one dispatch lifetime, promoting it
        first if demoted.  Returns the slot."""
        if expert >= self.num_experts or expert < 0:
            raise ExpertError(f"no such expert {expert}")
        published = False
        if expert not in self._resident[layer]:
            self._promote(layer, expert)
            self._publish()
            published = True
        self._pins[layer][expert] = self._pins[layer].get(expert, 0) + 1
        self._lru[layer].move_to_end(expert)
        if not published:
            self._lru[layer][expert] = None
        return self._resident[layer][expert]

    def release(self, layer: int, expert: int) -> None:
        n = self._pins[layer].get(expert, 0)
        if n <= 0:
            raise ExpertError(
                f"release of unreserved expert ({layer}, {expert}) — a "
                f"double release would unpin a live dispatch's weights")
        if n == 1:
            del self._pins[layer][expert]
        else:
            self._pins[layer][expert] = n - 1

    # -- census / policy --------------------------------------------------
    def ingest_census(self, census: np.ndarray) -> None:
        """Fold one drained [L, E+1] router census (engine
        `drain_moe_census`) into the LRU ranking and the counters: column
        e counts layer-l assignments the router wanted on expert e, the
        last column those rerouted because their expert was demoted."""
        census = np.asarray(census)
        if census.shape != (self.num_layers, self.num_experts + 1):
            raise ExpertError(
                f"census shape {census.shape} != "
                f"({self.num_layers}, {self.num_experts + 1})")
        per_expert = census[:, :self.num_experts].astype(np.int64)
        self.routed += int(per_expert.sum())
        self.rerouted += int(census[:, self.num_experts].sum())
        self._last_census = per_expert
        for layer in range(self.num_layers):
            # hottest-last LRU: touch residents in ascending demand order
            row = per_expert[layer]
            for e in np.argsort(row, kind="stable"):
                e = int(e)
                if row[e] > 0 and e in self._resident[layer]:
                    self._lru[layer].move_to_end(e)

    def rebalance(self, max_promotes: int = 0) -> int:
        """Promote the hottest demoted experts (by the last census),
        evicting the coldest unpinned residents when no slot is free.
        Returns the number of promotions performed."""
        done = 0
        capped = False
        for layer in range(self.num_layers):
            if capped:
                break
            row = self._last_census[layer]
            hot = [int(e) for e in np.argsort(-row, kind="stable")
                   if row[e] > 0 and e not in self._resident[layer]]
            for e in hot:
                if max_promotes and done >= max_promotes:
                    capped = True
                    break
                coldest = next(iter(self._lru[layer]), None)
                if (not self._free[layer] and coldest is not None
                        and row[coldest] >= row[e]):
                    break  # residents are already at least this hot
                try:
                    self._promote(layer, e)
                except ExpertUnavailable:
                    break
                done += 1
        if done:
            self._publish()
        return done

    def load_imbalance(self) -> float:
        """max/mean of per-expert demand from the last census (1.0 =
        perfectly balanced; 0.0 before any census)."""
        totals = self._last_census.sum(axis=0).astype(np.float64)
        if totals.sum() <= 0:
            return 0.0
        return float(totals.max() / max(totals.mean(), 1e-9))

    def drop_rate(self) -> float:
        """Fraction of router assignments rerouted off their wanted
        expert (the dispatch drop-rate gauge)."""
        return self.rerouted / self.routed if self.routed else 0.0

    # -- audit / telemetry ------------------------------------------------
    def audit(self) -> Dict[str, int]:
        """Conservation and host/device agreement.  Raises RuntimeError
        on drift; returns the summary when clean."""
        for layer in range(self.num_layers):
            res = self._resident[layer]
            if len(res) + len(self._free[layer]) != self.slots:
                raise RuntimeError(
                    f"expert slot conservation violated in layer {layer}: "
                    f"{len(res)} resident + {len(self._free[layer])} free "
                    f"!= {self.slots} slots")
            if len(set(res.values())) != len(res):
                raise RuntimeError(
                    f"expert slot aliasing in layer {layer}: two experts "
                    f"share a slot")
            for e, n in self._pins[layer].items():
                if n > 0 and e not in res:
                    raise RuntimeError(
                        f"expert ({layer}, {e}) holds {n} pin(s) but is "
                        f"not resident — the reserve contract is broken")
        lp = self._layers
        # the audit's two fetches of the [L, E] map and mask (tiny, off
        # the hot path)
        dev_map = lp["moe_slot_map"].cpu().numpy()
        dev_mask = lp["moe_resident_mask"].cpu().numpy()
        if not np.array_equal(dev_map, self._slot_map) \
                or not np.array_equal(dev_mask, self._mask):
            raise RuntimeError(
                "expert pool device/host divergence: the published "
                "slot_map/resident_mask do not match the bookkeeping")
        return {"expert_slots": self.num_layers * self.slots,
                "expert_resident": self.resident_count(),
                "expert_spilled": self.spilled_count(),
                "expert_pinned": self.pinned_count()}

    def stats(self) -> Dict[str, float]:
        """Telemetry view (the reference's ServingTelemetry fields)."""
        return {
            "expert_slots": self.num_layers * self.slots,
            "expert_resident": self.resident_count(),
            "expert_spilled": self.spilled_count(),
            "expert_pinned": self.pinned_count(),
            "expert_demotes": self.demotes,
            "expert_promotes": self.promotes,
            "expert_routed": self.routed,
            "expert_rerouted": self.rerouted,
            "expert_drop_rate": self.drop_rate(),
            "expert_load_imbalance": self.load_imbalance(),
        }

    def digest(self) -> Tuple[int, int]:
        """Cheap change stamp (the PrefixCache.digest shape)."""
        return (self.epoch, self.resident_count())
