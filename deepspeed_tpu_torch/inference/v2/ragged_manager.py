"""Ragged batch state management (host-side, no tensors).

Counterpart of `deepspeed_tpu/inference/v2/ragged_manager.py`, carried
over whole: `SequenceDescriptor` tracks a live sequence's KV block lease
and token progress, `DSStateManager` owns the allocator and hands the
engine its per-step batch descriptors.  The engine schedules on top of
this state with FastGen's "Dynamic SplitFuse": long prompts split into
fixed-size chunks so every step does a bounded amount of work, and token
generation continues every step.  The `prefix` hooks serve a shared-KV
prefix cache; the port's engine refuses to enable one yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .blocked_allocator import BlockedAllocator

__all__ = ["SequenceDescriptor", "DSStateManager"]


@dataclass
class SequenceDescriptor:
    """Reference: sequence_descriptor.py — per-sequence tracked state."""
    uid: int
    prompt: np.ndarray                       # full prompt token ids
    seen_tokens: int = 0                     # tokens already in the KV cache
    blocks: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # prompt tokens covered by a shared KV prefix at create time
    # (serving/prefix_cache.py): positions [0, prefix_covered) live in
    # read-only shared blocks and are never re-prefilled or re-written;
    # prefill starts at this offset.  0 = no shared prefix (all of
    # today's behavior).
    prefix_covered: int = 0

    @property
    def in_prefill(self) -> bool:
        return self.seen_tokens < len(self.prompt)

    @property
    def cur_len(self) -> int:
        return self.seen_tokens


class DSStateManager:
    """Owns the allocator + live sequences; builds step descriptors."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, max_seqs: int):
        self.allocator = BlockedAllocator(num_blocks)
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_seqs = max_seqs
        self.seqs: Dict[int, SequenceDescriptor] = {}

    # -- lifecycle -------------------------------------------------------
    def create(self, uid: int, prompt_tokens,
               prefix=None) -> SequenceDescriptor:
        """Track a new sequence.  `prefix` is an optional matched KV
        prefix `(block_ids, covered_tokens)` from the radix prefix cache
        (serving/prefix_cache.py): the sequence attaches those shared
        read-only blocks, starts prefill at position `covered_tokens`,
        and only the uncovered suffix is ever computed.  The caller must
        already hold a reference on each shared block (PrefixCache.
        acquire does); flush releases it with everything else."""
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already tracked")
        if len(self.seqs) >= self.max_seqs:
            raise RuntimeError(
                f"too many concurrent sequences (max_seqs={self.max_seqs})")
        d = SequenceDescriptor(uid=uid,
                               prompt=np.asarray(prompt_tokens, np.int32))
        if prefix is not None:
            blocks, covered = prefix
            if covered % self.block_size:
                raise ValueError(
                    f"prefix covered={covered} is not block-aligned "
                    f"(block_size {self.block_size}): only whole blocks "
                    f"can be shared read-only")
            if len(blocks) * self.block_size != covered:
                raise ValueError(
                    f"prefix has {len(blocks)} blocks for covered="
                    f"{covered} tokens (block_size {self.block_size})")
            if covered >= len(d.prompt):
                raise ValueError(
                    f"prefix covers {covered} of a {len(d.prompt)}-token "
                    f"prompt: at least the last prompt token must prefill "
                    f"so the sequence produces first-token logits")
            d.blocks = list(blocks)
            d.seen_tokens = covered
            d.prefix_covered = covered
        self.seqs[uid] = d
        return d

    def flush(self, uid: int) -> None:
        """Release the sequence's lease on its blocks (reference: state
        manager flush).  With per-block refcounts this is decref-to-zero:
        private blocks return to the free list, shared prefix blocks
        stay allocated for their remaining owners (the cache, other
        matching sequences)."""
        d = self.seqs.pop(uid)
        if d.blocks:
            self.allocator.free(d.blocks)

    def ensure_capacity(self, d: SequenceDescriptor, upto_tokens: int) -> None:
        """Lease blocks so positions [0, upto_tokens) fit."""
        need = -(-upto_tokens // self.block_size)  # ceil
        if need > self.max_blocks_per_seq:
            raise RuntimeError(
                f"sequence {d.uid} needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq}")
        if need > len(d.blocks):
            d.blocks.extend(self.allocator.allocate(need - len(d.blocks)))

    # -- block conservation audit ----------------------------------------
    def audit(self, cache_blocks=()) -> Dict[str, int]:
        """Verify block conservation: free + live + shared-refcounted
        blocks == num_blocks, and every allocated block's refcount equals
        the owners that can be named — one per live sequence holding it
        plus one if the prefix cache holds it (`cache_blocks`).  Raises
        RuntimeError naming the discrepancy (a leak or a refcount bug);
        returns a summary dict when clean."""
        alloc = self.allocator
        expected = [0] * alloc.num_blocks
        for b in cache_blocks:
            if not 0 <= b < alloc.num_blocks:
                raise RuntimeError(f"prefix cache holds bad block id {b}")
            if expected[b]:
                raise RuntimeError(
                    f"prefix cache holds block {b} more than once")
            expected[b] += 1
        live = set()
        for d in self.seqs.values():
            for b in d.blocks:
                expected[b] += 1
                live.add(b)
        refs = alloc.refcounts()
        bad = [(b, refs[b], expected[b]) for b in range(alloc.num_blocks)
               if refs[b] != expected[b]]
        if bad:
            leaked = [b for b, got, want in bad if got > want]
            raise RuntimeError(
                f"block conservation violated: {len(bad)} blocks with "
                f"refcount != named owners (block, refcount, expected): "
                f"{bad[:8]}{'...' if len(bad) > 8 else ''}; "
                f"{len(leaked)} leaked (refcount above every nameable "
                f"owner)")
        allocated = sum(1 for r in refs if r > 0)
        if alloc.free_blocks + allocated != alloc.num_blocks:
            raise RuntimeError(
                f"free list ({alloc.free_blocks}) + allocated "
                f"({allocated}) != num_blocks ({alloc.num_blocks})")
        cached = set(cache_blocks)
        return {
            "free": alloc.free_blocks,
            "live": len(live - cached),
            "shared": len(live & cached),
            "cached": len(cached),
            "total": alloc.num_blocks,
        }

    # -- step descriptor construction ------------------------------------
    def block_table(self, d: SequenceDescriptor) -> np.ndarray:
        t = np.zeros((self.max_blocks_per_seq,), np.int32)
        t[:len(d.blocks)] = d.blocks
        return t

    def decode_batch(self) -> List[SequenceDescriptor]:
        return [d for d in self.seqs.values()
                if not d.in_prefill and not d.done]
