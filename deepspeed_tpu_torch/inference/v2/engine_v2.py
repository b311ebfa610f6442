"""FastGen-style continuous-batching inference engine in PyTorch.

Counterpart of `deepspeed_tpu/inference/v2/engine_v2.py`: ragged batches of
live sequences advance under Dynamic SplitFuse — each `put`/`step` does a
bounded amount of prefill work (long prompts split into fixed chunks)
while every decode-ready sequence generates a token.  The scheduling
decisions are the reference's, line for line: the step budget, the
fairness reservation for prompts only the chunked path can take, one
power-of-two length bucket per full-prompt batch, the padded-slot cap,
power-of-two chunk-slot counts.  Keeping the padded shapes the same keeps
the two engines' block tables and host fetches comparable.

The model runs on `device` ("cuda" by default; there is no silent CPU
fallback).  The attention of each serving call goes through the port's
CUDA kernels (flash forward, paged prefill, paged decode — or their merged
arena wrappers — and the gather-LoRA epilogue) for tensors on the card and
through their plain PyTorch versions on the CPU; `plain_kernels=True`
selects the plain versions on the card too, for end-to-end comparisons,
the way the training engine's option does: it sets the model config's
`attn_impl` to "jnp".

Multi-LoRA serving follows the reference's contract: an adapter pool
(`serving.tenancy.AdapterPool`) attaches the stacked factors
(`attach_lora`), each sequence is bound to a pool slot before its first
prefill token (`set_adapter`), and base rows and adapter rows share every
serving call.  KV block IO (`read_kv_block(s)` / `write_kv_block(s)`)
moves whole arena blocks to and from the host.

Decode groups follow the reference too: `decode_burst_step` (with seeded
sampling streams, `seeds=` / `seed_positions=`) and `decode_multi_step`
(k steps with per-row termination on the device and one packed fetch a
group).  At tensor parallelism 1 on a CUDA device each burst and each
group is one replay of a captured CUDA graph (`graphs.DecodeGraphs`), the
counterpart of the reference's one compiled dispatch; a capture that
fails raises, nothing falls back to eager.  On the CPU the engine runs
the eager functions.

Tensor parallelism (`tensor_parallel_size > 1` with
`tp_collectives="fused"`) runs one engine per rank of an initialized
process group (`comm.init_distributed`, one process per device): each
rank keeps its shard of the weights and its kv heads of the arena, and
`put`, `step`, `decode_burst_step` and `generate_batch` go through the
fused-ring programs of `tp_ragged.py`.  Every rank must get the same
calls; each then holds the same full logits and samples the same tokens.

Mixture-of-experts models (mixtral, qwen2_moe) serve on every path at
tensor parallelism 1 (the fused ring refuses them, as the reference's
does): their expert layers run exact top-k routing through the
hand-written grouped GEMM.  `enable_expert_paging` pages the expert
weights through a `serving.experts.ExpertPool` (slot stacks on the card,
canonical copies on the host, rerouting under pressure) and adds the
router census to the arena, which the decode steps accumulate and
`drain_moe_census` fetches.

Draft-and-verify (`decode_burst_step(drafts=, draft_span=)`) verifies
each row's pending token and draft in one span forward through the paged
prefill kernels, eagerly, at every tp; fp8 serving weights
(`models.transformer.quantize_serving_weights`) keep their 1-byte codes
and f32 scales on the engine and serve every tp-1 path.

Not carried yet, each refused by name: the reference's GSPMD tensor
parallelism (`tp_collectives="xla"` at tp > 1), LoRA adapters and KV
block IO on a tensor-parallel engine, prefix cache and grammar
automata (`fsm=`).  As in the reference, the fused
tensor-parallel programs carry neither seeded streams, multi-step groups
nor fp8 weights, and drafts refuse seeds and adapter rows.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...models.convert import fp8_leaf, shard_params_tp
from ...models.transformer import TransformerConfig, init_params
from .ragged_manager import DSStateManager
from .ragged_ops import (decode_multi_step, decode_step, decode_tokens,
                         init_arena, prefill_chunks, prefill_full,
                         prefill_full_supported, sample_tokens_compiled,
                         verify_tokens)

__all__ = ["RaggedInferenceEngineConfig", "InferenceEngineV2",
           "LayoutNotCarried"]


@dataclass
class RaggedInferenceEngineConfig:
    """State manager and allocator sizing knobs (the reference's fields
    and defaults)."""
    num_blocks: int = 256
    block_size: int = 64
    max_blocks_per_seq: int = 32
    # decode-batch width
    max_seqs: int = 32
    prefill_chunk_size: int = 256
    # Dynamic SplitFuse budget: max new prefill tokens scheduled per put()
    max_prefill_tokens_per_step: int = 512
    # tokens sampled per decode-burst call (generate paths)
    decode_burst: int = 8
    # "auto" keeps the 5-D arena on a GPU; True stores the reference's
    # merged [L, nb, bs, NKV*D] layout (the same bytes)
    arena_merged: object = "auto"
    # > 1 runs one engine per rank of an initialized process group;
    # only tp_collectives="fused" (the ring programs) is carried
    tensor_parallel_size: int = 1
    tp_collectives: str = "xla"
    # fresh full prompts within budget run one dense causal flash
    # forward (prefill_full); False forces chunked everywhere
    full_prompt_prefill: bool = True


class LayoutNotCarried(NotImplementedError, ValueError):
    """A block feature the fused tensor-parallel programs do not carry:
    not carried by the port (NotImplementedError), and the reference's
    ValueError for the same configuration."""


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available: the port "
            f"serves on the card by default; pass device='cpu' to run the "
            f"plain PyTorch versions of the kernels on the CPU")
    return dev


def _to_param(x, device, dtype):
    """A parameter leaf on `device`: floats in the compute dtype; an fp8
    serving-weight dict keeps its 1-byte codes and f32 scales (a blanket
    cast would un-quantize the codes), as in the reference."""
    if isinstance(x, dict):
        return fp8_leaf(x, device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, np.float32))
    return t.to(device=device, dtype=dtype) if t.is_floating_point() \
        else t.to(device=device)


def _leaves(params):
    """The leaves of a parameter tree in a fixed (sorted key) order."""
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            yield from (v[kk] for kk in sorted(v))
        else:
            yield v


def _leaf_sum(x) -> float:
    """f64 sum of one leaf (numpy or torch), in chunks on its device."""
    if not isinstance(x, torch.Tensor):
        return float(np.sum(np.asarray(x, np.float64)))
    flat = x.reshape(-1)
    return float(sum(c.sum(dtype=torch.float64)
                     for c in flat.split(1 << 24)))


class _RaggedPrograms:
    """The `ragged_ops` serving programs with the model config bound (the
    reference binds its statics with partials); each is looked up in this
    module when called.  With `graphs` (a CUDA device), the decode bursts
    and groups are its captured programs' replays."""

    def __init__(self, cfg, graphs=None):
        self.cfg = cfg
        self.graphs = graphs

    def prefill_chunks(self, *args, **kw):
        return prefill_chunks(self.cfg, *args, **kw)

    def decode_step(self, *args, **kw):
        return decode_step(self.cfg, *args, **kw)

    def decode_tokens(self, *args, **kw):
        if self.graphs is not None:
            return self.graphs.decode_tokens(*args, **kw)
        return decode_tokens(self.cfg, *args, **kw)

    def verify_tokens(self, *args, **kw):
        # eager on every device: the rows' positions feed the prefill
        # kernel's host plan, and the captured decode groups are left as
        # they are (they read the arena by address)
        return verify_tokens(self.cfg, *args, **kw)

    def decode_multi_step(self, *args, **kw):
        if self.graphs is not None:
            return self.graphs.decode_multi_step(*args, **kw)
        return decode_multi_step(self.cfg, *args, **kw)


class InferenceEngineV2:
    """put()/flush() continuous-batching engine over a paged KV arena."""

    def __init__(self, model, params=None,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 device="cuda", plain_kernels: bool = False):
        self.cfg: TransformerConfig = (model.cfg if hasattr(model, "cfg")
                                       else model)
        if plain_kernels:
            # an explicit, never-default switch to the kernels' plain
            # versions, for comparing the two on the card
            self.cfg = replace(self.cfg, attn_impl="jnp")
        self.config = config or RaggedInferenceEngineConfig()
        self._check_tp()
        self.tp = self.config.tensor_parallel_size
        self.device = _resolve_device(device)
        self.topology = None
        if self.tp > 1:
            # the layout refusals need no process group: shapes only
            self._refuse_layout(params if params is not None else
                                init_params(self.cfg, None, "meta"))
            from ...parallel.mesh import make_tp_mesh
            self.topology = make_tp_mesh(self.tp)
            if self.device.type != self.topology.device.type:
                raise ValueError(
                    f"device={device!r} but this rank's process group runs "
                    f"on {self.topology.device}")
            # the rank's own card (cuda:<local_rank>), or the CPU
            self.device = self.topology.device
        if params is None:
            # every rank draws the same full set and keeps its shard
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(self.cfg, gen, self.device, self.cfg.dtype)
        self._tpp = None
        if self.tp > 1:
            params = self._shard(params)
        self.params = {
            k: ({kk: _to_param(vv, self.device, self.cfg.dtype)
                 for kk, vv in v.items()} if k == "layers"
                else _to_param(v, self.device, self.cfg.dtype))
            for k, v in params.items()}

        self.state = DSStateManager(
            self.config.num_blocks, self.config.block_size,
            self.config.max_blocks_per_seq, self.config.max_seqs)
        # per-sequence token ceiling: arena lease AND model context
        self.max_tokens_per_seq = min(
            self.config.max_blocks_per_seq * self.config.block_size,
            self.cfg.max_seq_len)
        # the arena is updated in place by every serving call (the
        # reference donates it to each compiled program instead); under
        # tp each rank holds its NKV/tp kv heads
        self.arena = init_arena(self.cfg, self.config.num_blocks,
                                self.config.block_size, self.device,
                                merged=self.config.arena_merged,
                                kv_heads=self.cfg.kv_heads // self.tp)
        # one program namespace for every serving call site: the fused TP
        # programs, or the ragged_ops programs with cfg bound
        if self.tp > 1:
            from .tp_ragged import TPServingPrograms
            self._tpp = TPServingPrograms(self.cfg, self.topology,
                                          self.params)
            self._programs = self._tpp
        else:
            graphs = None
            if self.device.type == "cuda":
                from .graphs import DecodeGraphs
                graphs = DecodeGraphs(self.cfg, self.device)
            self._programs = _RaggedPrograms(self.cfg, graphs)
        # prefill_full is off under tp (no fused-ring wiring), as in the
        # reference
        self._use_prefill_full = (self.config.full_prompt_prefill
                                  and self.tp == 1
                                  and prefill_full_supported(self.cfg))
        self._last_logits: Dict[int, np.ndarray] = {}
        self._rng = torch.Generator(device=self.device).manual_seed(0)
        # host-sync ledger: every explicit device->host fetch bumps it
        self.profile: Dict[str, int] = {"d2h_fetches": 0}
        # multi-LoRA serving: the stacked factors the adapter pool
        # attaches, and each sequence's pool slot.  Batches with no
        # adapter row run exactly the single-tenant computation.
        self._lora = None
        self._adapter_slots: Dict[int, int] = {}
        # expert-paged MoE serving (serving/experts.ExpertPool), off until
        # enable_expert_paging()
        self._expert_pool = None

    # -- tensor parallelism ----------------------------------------------
    def _check_tp(self) -> None:
        """The reference's tensor-parallel configuration checks (tp 1
        builds no process group and no TP programs)."""
        tp = self.config.tensor_parallel_size
        mode = self.config.tp_collectives
        if mode not in ("xla", "fused"):
            raise ValueError(f"tp_collectives must be 'xla' or 'fused', got "
                             f"{mode!r}")
        if mode == "fused" and tp <= 1:
            raise ValueError(
                "tp_collectives='fused' requires tensor_parallel_size > 1 "
                "(there is no collective to fuse at tp=1; the default "
                "'xla' keeps tp=1 byte-identical)")
        if tp > 1 and mode == "xla":
            raise NotImplementedError(
                "tp_collectives='xla' at tensor_parallel_size > 1 (the "
                "reference's GSPMD path) is not carried by the PyTorch port "
                "yet; tp_collectives='fused' serves tensor parallelism")

    def _refuse_layout(self, params) -> None:
        """Refuse what the fused programs do not serve, with the
        reference's reasons (`params` may hold shapes only).  A block
        feature those programs do not carry (post-norm and parallel
        residual blocks, ALiBi, windows, embedding projections) raises
        `LayoutNotCarried`, a NotImplementedError that is also the
        reference's ValueError."""
        from .tp_ragged import tp_fused_unsupported_reason, tp_unported
        meta_arena = init_arena(self.cfg, self.config.num_blocks,
                                self.config.block_size, "meta",
                                merged=self.config.arena_merged)
        reason = tp_fused_unsupported_reason(self.cfg, self.config, params,
                                             meta_arena)
        if reason is not None:
            err = (LayoutNotCarried if tp_unported(self.cfg, params)
                   else ValueError)
            raise err(
                f"tp_collectives='fused' cannot serve this configuration: "
                f"{reason} — the reference's tp_collectives='xla' (GSPMD) "
                f"path serves it, and is not carried by the PyTorch port "
                f"yet")

    def _shard(self, params):
        """This rank's shard of the full `params`, after proving that
        every rank holds the same full set: each leaf's f64 sum, max- and
        min-reduced over the ranks, must equal this rank's."""
        from ...comm import comm
        sums = torch.tensor([_leaf_sum(x) for x in _leaves(params)],
                            dtype=torch.float64, device=self.device)
        both = comm.all_reduce(torch.cat([sums, -sums]),
                               self.topology.tp_group, op="max")
        n = sums.numel()
        if not (torch.equal(both[:n], sums) and torch.equal(-both[n:], sums)):
            raise RuntimeError(
                "the tensor-parallel ranks hold different parameters (their "
                "per-leaf checksums disagree): give every rank the same "
                "params, or the same seed")
        return shard_params_tp(params, self.tp, self.topology.tp_rank)

    def _refuse_under_tp(self, what: str) -> None:
        if self.tp > 1:
            raise NotImplementedError(
                f"{what} on a tensor-parallel engine is not carried by the "
                f"PyTorch port yet")

    # -- features the port does not carry yet ----------------------------
    def enable_prefix_cache(self, *args, **kwargs):
        raise NotImplementedError(
            "prefix KV cache is not carried by the PyTorch port yet")

    supports_per_row_sampling = True
    supports_lora = True
    # decode_burst_step(drafts=) runs the verify span, at every tp
    supports_draft_verify = True
    supports_structured = False

    # expert-paged MoE decode (serving/experts.ExpertPool): the slot
    # stacks and maps ride params["layers"] through every layer, which
    # the fused-TP programs do not thread (and their weights are
    # per-rank shards)
    @property
    def supports_moe(self) -> bool:
        return self.cfg.moe_experts > 1 and self._tpp is None

    def enable_expert_paging(self, slots_per_layer: int,
                             spill: str = "none"):
        """Page this MoE model's expert FFN weights: only
        `slots_per_layer` experts per layer stay resident on the device in
        slot stacks, the rest live on the host (optionally int8 via
        `spill`) and promote back on demand; demoted experts' tokens
        reroute to the best resident expert (masked router) instead of
        faulting.  The full [L, E, ...] stacks leave the device
        (`_install_expert_pages`), so the memory saving is real.  Adds
        the router-census rider to the arena, so it refuses while
        sequences are live.  Returns the ExpertPool.

        slots_per_layer == E keeps every expert in its home slot: bit for
        bit the unpaged model (spill='none')."""
        if not self.supports_moe:
            raise RuntimeError(
                f"expert paging needs an MoE model served without "
                f"fused-TP collectives (moe_experts="
                f"{self.cfg.moe_experts}, fused_tp={self._tpp is not None})"
            )
        if self.tp > 1:
            raise RuntimeError(
                "expert paging under tensor parallelism is not wired: "
                "the slot stacks would need per-rank resharding on every "
                "promote (serve MoE with tp=1, or keep experts unpaged)")
        if self._expert_pool is not None:
            raise RuntimeError(
                "expert paging already enabled (one pool owns the slot "
                "tensors; reconstruct the engine to resize it)")
        if self.state.seqs:
            raise RuntimeError(
                "enable_expert_paging with live sequences: drain or "
                "flush them first (the arena is rebuilt with the census "
                "rider)")
        from ...serving.experts import ExpertPool
        self._expert_pool = ExpertPool(self, slots_per_layer, spill=spill)
        self.arena = init_arena(self.cfg, self.config.num_blocks,
                                self.config.block_size, self.device,
                                merged=self.config.arena_merged,
                                moe_census=True)
        return self._expert_pool

    def _install_expert_pages(self, pages: Dict[str, torch.Tensor]) -> None:
        """ExpertPool's install hook: splice the slot stacks, the slot map
        and the resident mask into params['layers'] and drop the full
        [L, E, ...] expert stacks from the device (paged serving must not
        hold both copies).  Called once; the pool writes the installed
        tensors in place afterwards."""
        layers = self.params["layers"]
        for key in ("moe_w_up", "moe_w_down", "moe_w_gate_proj"):
            layers.pop(key, None)
        layers.update(pages)

    def drain_moe_census(self) -> np.ndarray:
        """Fetch and reset the router census the decode programs
        accumulate (arena 'moe_census' [L, E+1]; see
        `models.transformer._moe_inference`): one explicit fetch per
        drain, counted like every other, then a zero fill in place (a
        captured decode group adds to the same storage)."""
        census = self.arena.get("moe_census")
        if census is None:
            raise RuntimeError(
                "no census rider in the arena — enable_expert_paging "
                "first")
        # a copy: on the CPU the fetched array shares the tensor's memory
        out = self._fetch(census).copy()
        census.zero_()
        return out

    # counter-based (seed, position) sampling streams and k-step groups
    # with on-device termination: properties, as in the reference, since
    # the fused tensor-parallel programs carry neither
    @property
    def supports_seeded_sampling(self) -> bool:
        return self._tpp is None

    @property
    def supports_multi_step(self) -> bool:
        return self._tpp is None

    def audit_blocks(self) -> Dict[str, int]:
        """Block-conservation audit (DSStateManager.audit); raises on a
        leak."""
        return self.state.audit()

    # -- multi-LoRA adapter serving (serving/tenancy) ---------------------
    def attach_lora(self, lora) -> None:
        """Attach (None = detach) the stacked multi-LoRA factors of the
        serving calls' gather-LoRA epilogue: {"a": [L, slots, NH*D, r],
        "b": [L, slots, r, H]} f32 tensors on the engine's device, over
        the attention output projection (ops/lora_matmul).  The adapter
        pool owns the slot tensors and re-attaches after every slot
        change; the engine holds the current view."""
        self._refuse_under_tp("attach_lora (multi-LoRA serving)")
        if lora is not None:
            a, b = lora["a"], lora["b"]
            if (a.ndim != 4 or b.ndim != 4 or a.shape[0] != b.shape[0]
                    or a.shape[1] != b.shape[1] or a.shape[3] != b.shape[2]):
                raise ValueError(
                    f"attach_lora needs a [L,slots,K,r] / [L,slots,r,H] "
                    f"stack, got a {tuple(a.shape)}, b {tuple(b.shape)}")
            if a.shape[0] != self.cfg.num_layers:
                raise ValueError(
                    f"attach_lora stack covers {a.shape[0]} layers, "
                    f"model has {self.cfg.num_layers}")
        self._lora = lora

    def set_adapter(self, uid: int, slot: int) -> None:
        """Bind sequence `uid`'s batch rows to LoRA pool slot `slot`
        (< 0 = base model).  The binding must land before the sequence's
        first prefill token and holds until flush."""
        if self._lora is None and slot >= 0:
            raise RuntimeError(
                f"set_adapter({uid}, {slot}) with no LoRA stack "
                f"attached — attach_lora first (the adapter pool owns "
                f"this ordering)")
        if slot >= 0 and uid in self.state.seqs \
                and self.state.seqs[uid].seen_tokens > 0:
            raise RuntimeError(
                f"set_adapter({uid}, {slot}) after the sequence began "
                f"prefill — the binding must cover every token")
        if slot < 0:
            self._adapter_slots.pop(uid, None)
        else:
            self._adapter_slots[uid] = int(slot)

    def _batch_adapter_ids(self, descs, n: int):
        """[n] int32 pool slots of a staged batch (row i = descs[i], -1 =
        base row), or None when no row carries an adapter: such batches
        run exactly the single-tenant computation."""
        if self._lora is None or not self._adapter_slots:
            return None
        aids = np.full(n, -1, np.int32)
        for i, d in enumerate(descs):
            aids[i] = self._adapter_slots.get(d.uid, -1)
        return aids if (aids >= 0).any() else None

    def _lora_kw(self, descs, n: int) -> Dict:
        aids = self._batch_adapter_ids(descs, n)
        return {} if aids is None else dict(adapter_ids=aids,
                                            lora=self._lora)

    # -- arena block IO ----------------------------------------------------
    def _check_blocks(self, blocks) -> List[int]:
        self._refuse_under_tp("KV block IO")
        blocks = [int(b) for b in blocks]
        for b in blocks:
            if not 0 <= b < self.config.num_blocks:
                raise ValueError(f"bad block id {b}")
        return blocks

    def _pages_in(self, name: str, pages, want) -> torch.Tensor:
        """Migrated pages (numpy arrays or tensors) checked against the
        arena's layout and staged on the device in the arena's dtype."""
        got = tuple(pages.shape)
        if got != want:
            # a wrong-shaped page would broadcast into the arena slot
            raise ValueError(
                f"migrated {name.upper()} pages of shape {got} do not fit "
                f"this arena (expected {want}): replicas must share the "
                f"model and arena layout")
        t = pages if isinstance(pages, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(pages))
        return t.to(device=self.device, dtype=self.arena["k"].dtype)

    def read_kv_block(self, block: int) -> tuple:
        """Host copies (CPU tensors) of one arena block's K/V pages,
        [num_layers, block_size, ...minor] each: two explicit fetches."""
        (block,) = self._check_blocks([block])
        k = self.arena["k"][:, block].cpu()
        v = self.arena["v"][:, block].cpu()
        self.profile["d2h_fetches"] += 2
        return k, v

    def write_kv_block(self, block: int, k, v) -> None:
        """Adopt one migrated block's K/V pages into the arena.  The
        caller must own the block (a fresh allocator lease): writing a
        block a live sequence reads would corrupt its KV."""
        (block,) = self._check_blocks([block])
        shape = self.arena["k"].shape         # [L, blocks, bs, ...minor]
        want = (shape[0], self.config.block_size) + tuple(shape[3:])
        k, v = self._pages_in("k", k, want), self._pages_in("v", v, want)
        self.arena["k"][:, block] = k
        self.arena["v"][:, block] = v

    def read_kv_blocks(self, blocks) -> tuple:
        """Batched `read_kv_block`: host copies of a span's pages,
        [num_layers, n_blocks, block_size, ...minor] each, one gather and
        one fetch per page tensor."""
        idx = torch.as_tensor(self._check_blocks(blocks), dtype=torch.long,
                              device=self.device)
        k = self.arena["k"][:, idx].cpu()
        v = self.arena["v"][:, idx].cpu()
        self.profile["d2h_fetches"] += 2
        return k, v

    def write_kv_blocks(self, blocks, k, v) -> None:
        """Batched `write_kv_block`: one scatter per page tensor.  The
        span's block ids must be distinct (a duplicated scatter index
        would keep only one page)."""
        blocks = self._check_blocks(blocks)
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate block ids in span {blocks}")
        shape = self.arena["k"].shape
        want = (shape[0], len(blocks),
                self.config.block_size) + tuple(shape[3:])
        k, v = self._pages_in("k", k, want), self._pages_in("v", v, want)
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        self.arena["k"][:, idx] = k
        self.arena["v"][:, idx] = v

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """The engine's one way to read device data on the host."""
        self.profile["d2h_fetches"] += 1
        return t.cpu().numpy()

    # -- scheduling ------------------------------------------------------
    def put(self, uids: Sequence[int], tokens_list: Sequence[np.ndarray],
            decode: bool = True, prefixes=None) -> Dict[int, np.ndarray]:
        """Admit new sequences (or append continuation tokens to existing
        ones) and advance the ragged batch one step.  Returns {uid:
        last-token logits} for every sequence that produced fresh logits
        this call.  `decode=False` runs only the prefill phase."""
        if prefixes is not None:
            raise NotImplementedError(
                "prefix leases: the prefix KV cache is not carried by the "
                "PyTorch port yet")
        # validate every uid before mutating any sequence
        for uid, toks in zip(uids, tokens_list):
            new_tokens = len(np.asarray(toks).ravel())
            cur = (self.state.seqs[uid].seen_tokens
                   if uid in self.state.seqs else 0)
            if cur + new_tokens > self.max_tokens_per_seq:
                raise RuntimeError(
                    f"sequence {uid} would reach {cur + new_tokens} tokens, "
                    f"over the {self.max_tokens_per_seq} limit "
                    f"(min of KV lease capacity and model max_seq_len "
                    f"{self.cfg.max_seq_len})")
            if uid in self.state.seqs and self.state.seqs[uid].in_prefill:
                raise RuntimeError(
                    f"sequence {uid} is still prefilling "
                    f"({self.state.seqs[uid].seen_tokens}/"
                    f"{len(self.state.seqs[uid].prompt)} prompt tokens); "
                    f"drive step() until query({uid}) returns logits "
                    f"before feeding continuation tokens")
        for uid, toks in zip(uids, tokens_list):
            if uid in self.state.seqs:
                self.state.seqs[uid].generated.extend(
                    int(t) for t in np.asarray(toks).ravel())
            else:
                self.state.create(uid, np.asarray(toks, np.int32))
        return self.step(decode=decode)

    def step(self, decode: bool = True) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        C = self.config.prefill_chunk_size
        # a zero/negative budget must still make 1 token of progress
        budget = max(self.config.max_prefill_tokens_per_step, 1)

        # 0) fresh-full-prompt fast path (see the reference's step for the
        #    reasoning behind each guard): suspended while any sequence is
        #    mid-prefill; one chunk of budget reserved when a fresh prompt
        #    can only take the chunked path; one power-of-two length
        #    bucket per batch; padded slots capped at
        #    max(2x the budget's bucket, max_seqs * 128).
        if self._use_prefill_full and not any(
                d.seen_tokens > d.prefix_covered and d.in_prefill
                and not d.done
                for d in self.state.seqs.values()):
            pad_cap = 128
            while pad_cap < 2 * budget:
                pad_cap *= 2
            pad_cap = max(pad_cap, self.config.max_seqs * 128)
            full_budget = budget
            if any(d.seen_tokens == d.prefix_covered and not d.done
                   and d.in_prefill
                   and (len(d.prompt) > budget or d.prefix_covered > 0)
                   for d in self.state.seqs.values()):
                full_budget = max(budget - C, 0)
            fresh: List = []
            S = 128
            for d in self.state.seqs.values():
                if not (d.seen_tokens == 0 and not d.done
                        and 0 < len(d.prompt) <= full_budget - sum(
                            len(f.prompt) for f in fresh)
                        and len(fresh) < self.config.max_seqs
                        # adapter rows need the chunked path's gather-
                        # LoRA epilogue (prefill_full has none)
                        and self._adapter_slots.get(d.uid, -1) < 0):
                    continue
                bucket = 128
                while bucket < len(d.prompt):
                    bucket *= 2
                if fresh and bucket != S:
                    continue          # one length bucket per batch
                ns_next = 1
                while ns_next < len(fresh) + 1:
                    ns_next *= 2
                if ns_next * bucket > pad_cap:
                    continue          # padded-slot budget guard
                S = bucket
                fresh.append(d)
            if fresh:
                NS = 1
                while NS < len(fresh):
                    NS *= 2
                ftokens = np.zeros((NS, S), np.int32)
                flens = np.zeros(NS, np.int32)
                ftables = np.zeros((NS, self.config.max_blocks_per_seq),
                                   np.int32)
                factive = np.zeros(NS, bool)
                for i, d in enumerate(fresh):
                    n = len(d.prompt)
                    self.state.ensure_capacity(d, n)
                    ftokens[i, :n] = d.prompt
                    flens[i] = n
                    ftables[i] = self.state.block_table(d)
                    factive[i] = True
                logits, self.arena = prefill_full(
                    self.cfg, self.params, self.arena, ftokens, flens,
                    ftables, factive)
                logits = self._fetch(logits)
                for i, d in enumerate(fresh):
                    d.seen_tokens = len(d.prompt)
                    out[d.uid] = logits[i]
                budget -= sum(len(d.prompt) for d in fresh)
                budget = max(budget, 0)
        # slot bound: every full chunk consumes C budget and each sequence
        # contributes at most one partial (tail) chunk
        cap = budget // C + self.config.max_seqs
        cap_alloc = 1
        while cap_alloc < cap:
            cap_alloc *= 2
        # 1) prefill: plan the step's chunks (FIFO over pending prompts,
        #    possibly several chunks of one long prompt, budget-bounded),
        #    then advance them all in one call; the chunk-slot count pads
        #    to a power of two.
        planned: List[tuple] = []          # (d, start, n)
        pseen = {d.uid: d.seen_tokens for d in self.state.seqs.values()}
        tokens = np.zeros((cap_alloc, C), np.int32)
        pos0s = np.zeros(cap_alloc, np.int32)
        nvalids = np.zeros(cap_alloc, np.int32)
        tlens = np.zeros(cap_alloc, np.int32)
        tables = np.zeros((cap_alloc, self.config.max_blocks_per_seq),
                          np.int32)
        active = np.zeros(cap_alloc, bool)
        while budget > 0 and len(planned) < cap:
            d = next((s for s in self.state.seqs.values()
                      if pseen[s.uid] < len(s.prompt) and not s.done), None)
            if d is None:
                break
            start = pseen[d.uid]
            n = min(C, len(d.prompt) - start, budget)
            self.state.ensure_capacity(d, start + n)
            i = len(planned)
            tokens[i, :n] = d.prompt[start:start + n]
            pos0s[i] = start
            nvalids[i] = n
            # the whole prompt's length, so longrope chooses the band of
            # HF's one-shot prompt forward for every chunk
            tlens[i] = len(d.prompt)
            tables[i] = self.state.block_table(d)
            active[i] = True
            planned.append((d, start, n))
            pseen[d.uid] = start + n
            budget -= n
        if planned:
            NC = 1
            while NC < len(planned):
                NC *= 2
            logits, self.arena = self._programs.prefill_chunks(
                self.params, self.arena, tokens[:NC], pos0s[:NC],
                nvalids[:NC], tables[:NC], active[:NC], tlens[:NC],
                **self._lora_kw([d for d, _, _ in planned], NC))
            logits = self._fetch(logits)
            for i, (d, start, n) in enumerate(planned):
                d.seen_tokens = start + n
                if not d.in_prefill:
                    out[d.uid] = logits[i]
        # 2) decode: one token for every sequence with a pending input token
        batch = [d for d in self.state.decode_batch() if d.generated
                 and d.seen_tokens < len(d.prompt) + len(d.generated)
                 ] if decode else []
        if batch:
            B = self.config.max_seqs
            tokens = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            tables = np.zeros((B, self.config.max_blocks_per_seq), np.int32)
            active = np.zeros(B, bool)
            for i, d in enumerate(batch):
                pending_idx = d.seen_tokens - len(d.prompt)
                tokens[i] = d.generated[pending_idx]
                lens[i] = d.seen_tokens
                self.state.ensure_capacity(d, d.seen_tokens + 1)
                tables[i] = self.state.block_table(d)
                active[i] = True
            logits, self.arena = self._programs.decode_step(
                self.params, self.arena, tokens, lens, tables, active,
                **self._lora_kw(batch, B))
            logits = self._fetch(logits)
            for i, d in enumerate(batch):
                d.seen_tokens += 1
                out[d.uid] = logits[i]
        self._last_logits.update(out)
        return out

    # -- burst decode: sampling on the device, one host read per K tokens
    def decode_burst_step(self, uids: Optional[Sequence[int]] = None,
                          n_steps: Optional[int] = None,
                          mode: str = "greedy", temperature=1.0,
                          top_k=0, rng: Optional[torch.Generator] = None,
                          max_tokens: Optional[Dict[int, int]] = None,
                          drafts: Optional[Dict[int, Sequence[int]]] = None,
                          draft_span: Optional[int] = None,
                          seeds: Optional[Dict[int, int]] = None,
                          seed_positions: Optional[Dict[int, int]] = None,
                          fsm=None, fsm_states: Optional[Dict[int, int]] = None,
                          fsm_eos: Optional[Dict[int, int]] = None
                          ) -> Dict[int, np.ndarray]:
        """Advance decode-ready sequences `n_steps` tokens in one call
        (ragged_ops.decode_tokens): sample -> append KV -> feed back, all
        on the device (one graph replay on the card at tp 1).  Each
        selected sequence must hold exactly one pending input token.
        Returns {uid: [n_steps] int32 sampled tokens}; the last one is
        left pending so bursts chain.
        mode="per_row" takes {uid: value} dicts for `temperature` and
        `top_k` (missing uids sample greedily).  `max_tokens` ({uid:
        absolute token cap}) tightens each row's KV-lease bound.
        `seeds` ({uid: 64-bit stream seed}) with `seed_positions` ({uid:
        index of the row's first token of this burst in its generated
        stream}) draw the flagged rows' token j from their counter-based
        Philox stream at position + j, independent of the engine's
        generator; they need a stochastic mode ("sample" rides the
        per-row program so that the flags get a row axis).

        `drafts` ({uid: proposed continuation tokens}) switches the call
        to draft-and-verify (`_verify_draft_step`, ragged_ops.
        verify_tokens): one span forward verifies each row's pending
        token plus its draft, with accept/reject on the device, instead
        of `n_steps` sequential steps.  The return becomes {uid:
        (emitted tokens [n] int32, n_drafted, n_accepted)}, n = accepted
        + 1 (the replacement or bonus token), the last left pending.
        `draft_span` (1 + the longest draft, bucketed by the caller with
        `serving.span_bucket`) fixes the span width and must be given.
        Greedy rows emit the sequential greedy chain; "sample" and
        "per_row" rows use rejection sampling.  `drafts` refuses `seeds`
        and LoRA adapter rows (the reference's refusals); `fsm=` is
        refused by name."""
        if seeds and drafts is not None:
            raise RuntimeError(
                "draft-and-verify cannot serve seeded sampling streams: "
                "rejection sampling consumes a DATA-dependent number of "
                "uniforms per emitted token, so the (seed, position) "
                "stream contract — one draw per generated index — "
                "cannot hold; serve seeded requests through plain "
                "bursts or multi-step groups")
        if fsm is not None or fsm_states is not None or fsm_eos is not None:
            raise NotImplementedError(
                "decode_burst_step(fsm=...): grammar automata (structured "
                "generation) are not carried by the PyTorch port yet")
        if drafts is not None:
            return self._verify_draft_step(
                uids, mode=mode, temperature=temperature, top_k=top_k,
                rng=rng, max_tokens=max_tokens, drafts=drafts,
                draft_span=draft_span)
        if seeds:
            self._check_seeds(seed_positions)
            if mode == "greedy":
                raise ValueError(
                    "seeds= with mode='greedy': greedy rows never consume "
                    "their sampling stream — drop the seeds or pick a "
                    "stochastic mode")
        n_steps = n_steps or self.config.decode_burst
        batch = self._decode_ready(uids)
        if not batch:
            return {}
        B = self.config.max_seqs
        tokens = np.zeros(B, np.int32)
        lens = np.zeros(B, np.int32)
        max_lens = np.ones(B, np.int32)
        tables = np.zeros((B, self.config.max_blocks_per_seq), np.int32)
        active = np.zeros(B, bool)
        for i, d in enumerate(batch):
            tokens[i] = self._pending(d, "burst")
            lens[i] = d.seen_tokens
            # cap the lease at the sequence's KV budget: overshot steps of
            # a tail burst re-write the last leased slot (tokens trimmed)
            capped = min(d.seen_tokens + n_steps, self.max_tokens_per_seq)
            if max_tokens is not None and d.uid in max_tokens:
                capped = min(capped, int(max_tokens[d.uid]))
            capped = max(capped, d.seen_tokens)
            max_lens[i] = capped
            self.state.ensure_capacity(d, capped)
            tables[i] = self.state.block_table(d)
            active[i] = True
        rng = rng or self._rng
        lkw = self._lora_kw(batch, B)
        if mode == "per_row" or (seeds and mode == "sample"):
            tv = np.zeros(B, np.float32)
            kv = np.zeros(B, np.int32)
            if mode == "per_row":
                temperature = dict(temperature or {})
                top_k = dict(top_k or {})
                for i, d in enumerate(batch):
                    tv[i] = float(temperature.get(d.uid, 0.0))
                    kv[i] = int(top_k.get(d.uid, 0))
            else:
                # a uniform stochastic burst with seeded rows rides the
                # per-row program: the seed flags need a row axis
                tv[:len(batch)] = float(temperature)
                kv[:len(batch)] = int(top_k)
            skw = (self._seed_operands(batch, B, seeds, seed_positions)
                   if seeds else {})
            toks, self.arena = self._programs.decode_tokens(
                self.params, self.arena, tokens, lens, tables, active, rng,
                tv, max_lens, kv, n_steps=n_steps, mode="per_row", top_k=0,
                **skw, **lkw)
        else:
            toks, self.arena = self._programs.decode_tokens(
                self.params, self.arena, tokens, lens, tables, active, rng,
                float(temperature), max_lens, n_steps=n_steps, mode=mode,
                top_k=int(top_k), **lkw)
        toks = self._fetch(toks)   # the once-per-burst read
        out: Dict[int, np.ndarray] = {}
        for i, d in enumerate(batch):
            real = max(0, int(max_lens[i]) - int(lens[i]))
            d.generated.extend(int(t) for t in toks[i][:real])
            d.seen_tokens = min(d.seen_tokens + n_steps, int(max_lens[i]))
            out[d.uid] = toks[i]
            # burst path produces tokens, not logits — drop stale logits
            self._last_logits.pop(d.uid, None)
        return out

    def _decode_ready(self, uids):
        """The decode-ready sequences (one pending input token or more),
        those of `uids` where given."""
        batch = [d for d in self.state.decode_batch() if d.generated
                 and d.seen_tokens < len(d.prompt) + len(d.generated)]
        if uids is not None:
            sel = set(uids)
            batch = [d for d in batch if d.uid in sel]
        return batch

    @staticmethod
    def _pending(d, what: str) -> int:
        """Sequence `d`'s one pending input token (a burst or group needs
        exactly one)."""
        pending = d.seen_tokens - len(d.prompt)
        if pending != len(d.generated) - 1:
            raise RuntimeError(
                f"sequence {d.uid} has {len(d.generated) - pending} "
                f"pending tokens; {what} decode needs exactly 1 (drive "
                f"step() to drain extras first)")
        return d.generated[pending]

    def _check_seeds(self, seed_positions) -> None:
        if not self.supports_seeded_sampling:
            raise RuntimeError(
                "seeded sampling streams are not served by the fused-TP "
                "program set (tp_ragged.TPServingPrograms has no seed "
                "operands), as in the reference")
        if seed_positions is None:
            raise ValueError(
                "seeds= needs seed_positions= (the stream index of each "
                "row's first drawn token)")

    def _seed_operands(self, batch, B: int, seeds, seed_positions) -> Dict:
        """The per-row counter-based stream operands: the 64-bit seed as
        two 32-bit words, the stream index of the row's first drawn
        token, and the participation flag (host data)."""
        seeds = dict(seeds or {})
        seed_positions = dict(seed_positions or {})
        sh = np.zeros(B, np.int64)
        sl = np.zeros(B, np.int64)
        sp = np.zeros(B, np.int64)
        hs = np.zeros(B, bool)
        for i, d in enumerate(batch):
            if d.uid in seeds:
                s = int(seeds[d.uid]) & 0xFFFFFFFFFFFFFFFF
                sh[i], sl[i] = s >> 32, s & 0xFFFFFFFF
                sp[i] = int(seed_positions[d.uid])
                hs[i] = True
        return dict(seed_hi=sh, seed_lo=sl, seed_pos=sp, has_seed=hs)

    def _verify_draft_step(self, uids: Optional[Sequence[int]], *,
                           mode: str, temperature, top_k,
                           rng: Optional[torch.Generator],
                           max_tokens: Optional[Dict[int, int]],
                           drafts: Dict[int, Sequence[int]],
                           draft_span: Optional[int]) -> Dict[int, tuple]:
        """The draft-and-verify dispatch (`decode_burst_step(drafts=)`):
        stage each row's [pending, draft...] span, run `verify_tokens`
        (eagerly: each row's position feeds the prefill kernel's host
        plan), read its tokens and counts in one fetch and adopt the
        accepted ones.  The lease is capped as the sequential burst's:
        span positions past it drop their writes and their tokens are
        trimmed here."""
        if draft_span is None or draft_span < 1:
            raise ValueError(
                "drafts= needs draft_span >= 1 (the bucketed compiled "
                "span width, 1 + max draft length)")
        if self._expert_pool is not None:
            raise RuntimeError(
                "speculative verify with expert paging enabled is "
                "refused: a rejected draft rolls KV back, but the census "
                "the verify span accumulated (and any reroutes a demoted "
                "expert caused inside the speculated span) cannot be "
                "rolled back with it — serve MoE speculation unpaged")
        batch = self._decode_ready(uids)
        # every row the span serves, drafted or not: the verify has no
        # gather-LoRA epilogue
        if any(self._adapter_slots.get(d.uid, -1) >= 0 for d in batch):
            raise RuntimeError(
                "draft-and-verify does not serve LoRA adapter rows: "
                "the verify program has no gather-LoRA epilogue, so "
                "accepting drafts against base-model logits would "
                "silently decode the wrong model — serve adapter "
                "requests through plain bursts (the serving layer "
                "refuses the speculative+tenancy combination at "
                "config validation)")
        if not batch:
            return {}
        B = self.config.max_seqs
        S = int(draft_span)
        tokens = np.zeros((B, S), np.int32)
        lens = np.zeros(B, np.int32)
        nval = np.ones(B, np.int32)
        max_lens = np.ones(B, np.int32)
        tables = np.zeros((B, self.config.max_blocks_per_seq), np.int32)
        active = np.zeros(B, bool)
        for i, d in enumerate(batch):
            tokens[i, 0] = self._pending(d, "draft verify")
            dr = np.asarray(drafts.get(d.uid, ()), np.int32).ravel()[:S - 1]
            tokens[i, 1:1 + len(dr)] = dr
            nval[i] = 1 + len(dr)
            lens[i] = d.seen_tokens
            capped = min(d.seen_tokens + S, self.max_tokens_per_seq)
            if max_tokens is not None and d.uid in max_tokens:
                capped = min(capped, int(max_tokens[d.uid]))
            capped = max(capped, d.seen_tokens)
            max_lens[i] = capped
            self.state.ensure_capacity(d, capped)
            tables[i] = self.state.block_table(d)
            active[i] = True
        rng = rng or self._rng
        if mode == "greedy":
            emitted, n_emitted, self.arena = self._programs.verify_tokens(
                self.params, self.arena, tokens, lens, nval, tables, active,
                rng, 0.0, max_lens, mode="greedy")
        else:
            # "per_row" dicts and uniform "sample" scalars share the
            # per-row verify
            temp_vec = np.zeros(B, np.float32)
            topk_vec = np.zeros(B, np.int32)
            if mode == "per_row":
                temperature = dict(temperature or {})
                top_k = dict(top_k or {})
                for i, d in enumerate(batch):
                    temp_vec[i] = float(temperature.get(d.uid, 0.0))
                    topk_vec[i] = int(top_k.get(d.uid, 0))
            elif mode == "sample":
                temp_vec[:len(batch)] = float(temperature)
                topk_vec[:len(batch)] = int(top_k)
            else:
                raise ValueError(
                    f"unknown sampling mode {mode!r} "
                    f"(greedy | sample | per_row)")
            emitted, n_emitted, self.arena = self._programs.verify_tokens(
                self.params, self.arena, tokens, lens, nval, tables, active,
                rng, temp_vec, max_lens, topk_vec, mode="per_row")
        # the once-per-dispatch read: tokens and counts in one fetch
        got = self._fetch(torch.cat([emitted, n_emitted[:, None]], dim=1))
        out: Dict[int, tuple] = {}
        for i, d in enumerate(batch):
            n = int(got[i, S])
            real = max(0, int(max_lens[i]) - int(lens[i]))
            take = min(n, real)
            toks = np.asarray(got[i, :take], np.int32)
            d.generated.extend(int(t) for t in toks)
            d.seen_tokens = min(d.seen_tokens + n, int(max_lens[i]))
            # the verify path produces tokens, not logits
            self._last_logits.pop(d.uid, None)
            out[d.uid] = (toks, int(nval[i]) - 1, max(take - 1, 0))
        return out

    def decode_multi_step(self, uids: Optional[Sequence[int]] = None,
                          k: int = 8, temperature=None, top_k=None,
                          rng: Optional[torch.Generator] = None,
                          max_tokens: Optional[Dict[int, int]] = None,
                          eos_ids: Optional[Dict[int, int]] = None,
                          seeds: Optional[Dict[int, int]] = None,
                          seed_positions: Optional[Dict[int, int]] = None,
                          fsm=None, fsm_states=None
                          ) -> Dict[int, np.ndarray]:
        """Advance decode-ready sequences up to `k` tokens in one group
        (ragged_ops.decode_multi_step; one graph replay on the card at tp
        1) with sampling AND termination on the device: a row stops the
        moment it samples its EOS token or exhausts its new-token budget —
        it pins its length and stops writing KV — and the host reads one
        packed [B, k+1] result per group.

        Sampling is per row: `temperature`/`top_k` are {uid: value} dicts
        (missing uids sample greedily); `seeds`/`seed_positions` as in
        `decode_burst_step`.  `max_tokens` ({uid: absolute token cap})
        bounds both the row's KV lease and its budget; `eos_ids` ({uid:
        token id}) arms per-row EOS termination (missing = never).  KV
        leases are taken for the full k up front; flushing a stopped
        request frees them.  `fsm=` is refused by name.

        Returns {uid: [n_e] int32}: the tokens the row emitted, EOS
        included, nothing past its stop; the last one stays pending so
        groups chain like bursts."""
        if fsm is not None or fsm_states is not None:
            raise NotImplementedError(
                "decode_multi_step(fsm=...): grammar-constrained step "
                "groups (structured generation) are not carried by the "
                "PyTorch port yet")
        if k < 1:
            raise ValueError(f"decode_multi_step needs k >= 1, got {k}")
        if not self.supports_multi_step:
            raise RuntimeError(
                "decode_multi_step is not served by the fused-TP program "
                "set (tp_ragged.TPServingPrograms has no multi-step "
                "program) — use tp_collectives='xla' for multi-step "
                "serving")
        if seeds:
            self._check_seeds(seed_positions)
        batch = self._decode_ready(uids)
        if not batch:
            return {}
        temperature = dict(temperature or {})
        top_k = dict(top_k or {})
        eos_ids = dict(eos_ids or {})
        max_tokens = dict(max_tokens or {})
        B = self.config.max_seqs
        tokens = np.zeros(B, np.int32)
        lens = np.zeros(B, np.int32)
        max_lens = np.ones(B, np.int32)
        budget = np.zeros(B, np.int32)
        eos_vec = np.full(B, -1, np.int32)
        temp_vec = np.zeros(B, np.float32)
        topk_vec = np.zeros(B, np.int32)
        tables = np.zeros((B, self.config.max_blocks_per_seq), np.int32)
        active = np.zeros(B, bool)
        for i, d in enumerate(batch):
            tokens[i] = self._pending(d, "multi-step")
            lens[i] = d.seen_tokens
            # full-k lease up front, bounded by the row's token cap; the
            # budget also stops the row on the device
            capped = min(d.seen_tokens + k, self.max_tokens_per_seq)
            capped = min(capped, int(max_tokens.get(d.uid, capped)))
            capped = max(capped, d.seen_tokens)
            max_lens[i] = capped
            budget[i] = capped - d.seen_tokens
            self.state.ensure_capacity(d, capped)
            tables[i] = self.state.block_table(d)
            active[i] = budget[i] > 0
            eos_vec[i] = int(eos_ids.get(d.uid, -1))
            temp_vec[i] = float(temperature.get(d.uid, 0.0))
            topk_vec[i] = int(top_k.get(d.uid, 0))
        skw = (self._seed_operands(batch, B, seeds, seed_positions)
               if seeds else {})
        packed, self.arena = self._programs.decode_multi_step(
            self.params, self.arena, tokens, lens, tables, active,
            rng or self._rng, temp_vec, max_lens, topk_vec, eos_vec, budget,
            k=k, **skw, **self._lora_kw(batch, B))
        packed = self._fetch(packed)   # the once-per-group read
        out: Dict[int, np.ndarray] = {}
        for i, d in enumerate(batch):
            n_e = int(packed[i, k])
            toks = np.asarray(packed[i, :n_e], np.int32)
            d.generated.extend(int(t) for t in toks)
            d.seen_tokens += n_e
            out[d.uid] = toks
            # multi-step produces tokens, not logits — drop stale logits
            self._last_logits.pop(d.uid, None)
        return out

    def sample_tokens_batch(self, logits_rows, mode: str = "greedy",
                            temperature=1.0, top_k=0) -> np.ndarray:
        """Sample one token per row of `logits_rows` [N, V] in one device
        call.  Scalar temperature/top_k with mode "greedy"/"sample", or
        per-row vectors (length N) with mode="per_row" (rows with
        temperature <= 0 take the argmax).  Returns [N] int32 on host."""
        stacked = torch.from_numpy(
            np.ascontiguousarray(np.asarray(logits_rows, np.float32))
        ).to(self.device)
        if mode == "per_row":
            temp = torch.as_tensor(np.asarray(temperature, np.float32),
                                   device=self.device)
            topk_vec = torch.as_tensor(np.asarray(top_k, np.int32),
                                       device=self.device)
            toks = sample_tokens_compiled(stacked, self._rng, temp,
                                          topk_vec, mode="per_row")
        else:
            toks = sample_tokens_compiled(stacked, self._rng,
                                          float(temperature), mode=mode,
                                          top_k=int(top_k))
        return self._fetch(toks)

    # -- lifecycle -------------------------------------------------------
    def flush(self, uid: int) -> None:
        self.state.flush(uid)
        self._last_logits.pop(uid, None)
        self._adapter_slots.pop(uid, None)

    def query(self, uid: int) -> Optional[np.ndarray]:
        return self._last_logits.get(uid)

    @property
    def free_blocks(self) -> int:
        return self.state.allocator.free_blocks

    @property
    def free_slots(self) -> int:
        """Ragged-batch slots not held by a live sequence."""
        return self.config.max_seqs - len(self.state.seqs)

    # -- convenience: generation driving prefill + burst decode ----------
    def generate(self, prompt_tokens, max_new_tokens: int = 16,
                 uid: int = 0, mode: str = "greedy",
                 temperature: float = 1.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Generate up to max_new_tokens (stops early at eos_token_id)."""
        out = self.generate_batch([np.asarray(prompt_tokens, np.int32)],
                                  max_new_tokens=max_new_tokens,
                                  mode=mode, temperature=temperature,
                                  top_k=top_k, eos_token_id=eos_token_id,
                                  first_uid=uid)
        return out[0]

    def generate_batch(self, prompts: Sequence[np.ndarray],
                       max_new_tokens: int = 16, mode: str = "greedy",
                       temperature: float = 1.0, top_k: int = 0,
                       eos_token_id: Optional[int] = None,
                       first_uid: int = 0) -> List[np.ndarray]:
        """Batched generation: admit prompts in waves of max_seqs, prefill
        through put()/step(), then burst-decode every live sequence in
        lockstep — one call per `decode_burst` tokens for the whole wave.
        Sequences that hit EOS drop out of later bursts."""
        results: List[np.ndarray] = [None] * len(prompts)
        W = self.config.max_seqs
        burst = max(1, self.config.decode_burst)
        for w0 in range(0, len(prompts), W):
            wave = list(range(w0, min(w0 + W, len(prompts))))
            uids = {i: first_uid + i for i in wave}
            self.put([uids[i] for i in wave],
                     [np.asarray(prompts[i], np.int32) for i in wave])
            while any(self.query(uids[i]) is None for i in wave):
                self.step()
            # sample every first token in one device call
            firsts = self.sample_tokens_batch(
                np.stack([self.query(uids[i]) for i in wave]),
                mode=mode, temperature=temperature, top_k=top_k)
            toks: Dict[int, List[int]] = {}
            live: List[int] = []
            for i, first in zip(wave, (int(t) for t in firsts)):
                toks[i] = [first]
                if not (eos_token_id is not None and first == eos_token_id
                        ) and max_new_tokens > 1:
                    # stage as the pending input of the first burst
                    self.state.seqs[uids[i]].generated.append(first)
                    live.append(i)
            while live:
                # always a full burst (the reference's compiled shape);
                # overshoot past max_new_tokens is trimmed on host
                got = self.decode_burst_step(
                    uids=[uids[i] for i in live], n_steps=burst, mode=mode,
                    temperature=temperature, top_k=top_k)
                nxt_live = []
                for i in live:
                    done = False
                    for t in got[uids[i]]:
                        toks[i].append(int(t))
                        if ((eos_token_id is not None
                             and int(t) == eos_token_id)
                                or len(toks[i]) >= max_new_tokens):
                            done = True
                            break
                    if not done:
                        nxt_live.append(i)
                live = nxt_live
            for i in wave:
                results[i] = np.asarray(toks[i], np.int32)
                self.flush(uids[i])
        return results
