"""Paged-KV transformer steps of the ragged engine: chunked prefill over the
paged arena, dense full-prompt prefill, and batched paged decode.

Counterpart of `deepspeed_tpu/inference/v2/ragged_ops.py`, with the same
function names, arguments and arena layouts ([L, num_blocks, block_size,
NKV, D] per tensor, or the merged [L, num_blocks, block_size, NKV*D]).
Where the reference differs by nature of JAX, the port does this instead:

- The reference's programs are pure and donate the arena; here the arena
  dict's tensors are updated IN PLACE (one `index_put_` per layer at
  [layer, block, offset]) and the same dict is returned, so call sites
  read alike.
- Scheduling metadata (token positions, block tables, active flags,
  lengths) is host data: the engine plans on the host, so the slot each
  row writes and which rows are padding are worked out here in numpy and
  copied to the device once per call.  The reference points padded rows
  at block `nb` and lets `.at[...].set(mode="drop")` discard them;
  `index_put_` has no drop mode, so padded rows are simply not selected.
- `jit`/`scan` become Python loops over layers and chunks.
- The dense-gather attention branches are gone: each kernel's plain
  PyTorch version serves tensors on the CPU, and `cfg.attn_impl="jnp"`
  selects it on the card for comparisons (never by default).
- The multi-LoRA epilogue's adapter ids are host data too: each serving
  call groups its rows by slot once (`ops.lora_matmul.LoraRows`) for all
  its layers.
- A decode group (`decode_tokens`' burst, `decode_multi_step`'s group)
  plans its steps on the device instead (`_GroupSlots`), over fixed [B]
  buffers: a row that stops mid-group is a stop the device decides, and
  no step may read the device from the host, so that the engine can
  replay the whole group as one captured CUDA graph (`graphs.py`, the
  counterpart of the reference's one compiled dispatch).
- The seeded sampling streams (Philox4x64-10, `philox_word`) run in
  int64 lanes holding 32-bit words, since torch's uint32 covers few ops.

- Sliding windows and ALiBi ride the paged kernels on the card (the
  reference serves them with a dense gather in XLA): the layers are a
  Python loop, so each layer's window is a plain int per launch
  (`layer_windows`), and the slopes are one [NH] f32 device tensor
  (`_slopes`), passed to every launch.  Head dims 80 and 96 (phi-2,
  Phi-3, GPT-NeoX) ride the same kernels, where the reference's Pallas
  kernels take D % 64 == 0 only and it gathers densely.
- Scaled RoPE (`cfg.rope_scaling`) rides every path, as in the
  reference: the chunked prefill passes each row's whole prompt length
  (`total_lens`) as longrope's `regime_len`, `prefill_full` the prompt
  lengths, decode none (each row's band then follows its position, so a
  row whose decode crosses the original context switches bands, as the
  reference's does).  The frequency tables are made once per device
  (`models.transformer.rope_tables`), and the band is chosen per row on
  the device.

- A draft-and-verify span (`verify_tokens`) is one prefill chunk per
  row through the chunked prefill's own layers (`_chunk_layers`), so
  each row's attention is one paged prefill launch a layer, as the
  reference's scan over rows; its rejection sampling draws from torch's
  generator (the distribution matches the reference, the stream does
  not).

- Expert layers (mixtral, qwen2_moe) run the exact top-k routing of
  `models.transformer._moe_inference` in every program, through the
  hand-written grouped GEMM (`ops.moe_grouped`); a layer that
  qwen2_moe's `moe_dense_layers` marks dense takes the dense MLP,
  chosen per layer on the host (the reference computes both and keeps
  one with a `where`: the same values).  The router census rides the
  arena ("moe_census", `init_arena(moe_census=True)`) and the decode
  steps add to it in place, so a captured decode group counts too.

Scope: the families the config takes — pre-norm, post-norm and
parallel-residual blocks, rope, learned or ALiBi positions, windows for
every layer or one a layer, expert layers — with plain or fp8 weights
(`_dense`).  No grammar masks.  Tensor parallelism runs the same layer
pieces (`_qkv`, `_mlp_delta`, `_KVSlots`, `_kernels`, `_span_plan`,
`_spec_accept`, `decode_loop`) through `tp_ragged.py`, for the pre-norm
sequential dense blocks without windows or ALiBi.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...models.transformer import (TransformerConfig, _block_out, _dense,
                                   _embed_in, _head_hidden, _layer_params,
                                   _mlp_block, _norm, _rope, alibi_slopes,
                                   layer_windows)
from ...ops.attention import causal_attention
from ...ops.lora_matmul import LoraRows, lora_delta, lora_delta_reference
from ...ops.paged_attention import (paged_decode_attention,
                                    paged_decode_reference)
from ...ops.paged_merged import (merged_decode_attention,
                                 merged_decode_reference,
                                 merged_prefill_attention,
                                 merged_prefill_reference)
from ...ops.paged_prefill import (paged_prefill_attention,
                                  paged_prefill_reference)

__all__ = ["init_arena", "prefill_chunks", "prefill_full",
           "prefill_full_supported", "decode_step", "decode_tokens",
           "decode_multi_step", "sample_tokens_compiled", "philox_word",
           "seeded_uniform24", "write_rows", "verify_tokens"]


def init_arena(cfg: TransformerConfig, num_blocks: int, block_size: int,
               device, merged="auto", kv_heads: int = None,
               moe_census: bool = False) -> Dict[str, torch.Tensor]:
    """Zeroed KV arena {"k", "v"} in cfg.dtype on `device`, each
    [L, num_blocks, block_size, NKV, D], or [L, num_blocks, block_size,
    NKV*D] with merged=True; `kv_heads` overrides NKV (a tensor-parallel
    rank holds its NKV/tp local heads).  The reference merges to dodge
    the TPU's 128-lane padding of a narrow head dim; a GPU pads nothing,
    so "auto" keeps the 5-D layout here, and merged=True stores the same
    bytes under the reference's merged shape (the serving functions
    branch on the arena's rank, as the reference's do).  moe_census=True
    adds the router-census rider "moe_census" [L, E+1] int32: each
    layer's routed-assignment counts per expert and, in the last column,
    the assignments rerouted off non-resident experts.  The decode steps
    add to it in place; prefill and verify spans leave it as it is."""
    if merged not in ("auto", False, True):
        raise ValueError(f"merged must be 'auto', False or True, got "
                         f"{merged!r}")
    nkv = cfg.kv_heads if kv_heads is None else kv_heads
    shape = (cfg.num_layers, num_blocks, block_size, nkv, cfg.head_dim)
    if merged is True:
        shape = shape[:3] + (nkv * cfg.head_dim,)
    arena = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if moe_census:
        if cfg.moe_experts <= 1:
            raise ValueError(
                "moe_census arena requested for a dense model "
                "(moe_experts <= 1 has no router to count)")
        arena["moe_census"] = torch.zeros(
            (cfg.num_layers, cfg.moe_experts + 1), dtype=torch.int32,
            device=device)
    return arena


# ----------------------------------------------------------------------
# host metadata -> device indices
# ----------------------------------------------------------------------
def _host(x) -> np.ndarray:
    """Scheduling metadata as a numpy array (it is host data by contract;
    CPU tensors from tests are accepted too)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dev(a: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                       dtype=dtype)


class _KVSlots:
    """Where this call's valid rows write K/V: row r of the flattened
    [N, NKV, D] projections goes to arena[li, blk[r], off[r]].  Padded
    rows (inactive sequences, chunk tails past n_valid) are left out, so
    they leave every arena slot unchanged."""

    def __init__(self, block_tables, positions, valid, bs: int, device):
        MB = block_tables.shape[-1]
        idx = np.clip(positions // bs, 0, MB - 1).reshape(
            block_tables.shape[0], -1)
        blk = np.take_along_axis(block_tables, idx, axis=1).ravel()
        rows = np.flatnonzero(valid.ravel())
        self.n = rows.size
        self.rows = _dev(rows, device)
        self.blk = _dev(blk[rows], device)
        self.off = _dev((positions % bs).ravel()[rows], device)

    def write(self, arena, li: int, k, v) -> None:
        """In-place scatter of this layer's new K/V rows [N, NKV, D] (the
        reference's functional `.at[li, blk, off].set(..., mode="drop")`);
        a merged arena takes each row as [NKV*D]."""
        if self.n == 0:
            return
        k, v = k.index_select(0, self.rows), v.index_select(0, self.rows)
        if arena["k"].dim() == 4:
            k, v = k.reshape(self.n, -1), v.reshape(self.n, -1)
        arena["k"][li, self.blk, self.off] = k
        arena["v"][li, self.blk, self.off] = v


def write_rows(active) -> np.ndarray:
    """[B] int64 rows whose slots a decode group writes, from the host
    `active` flags: the active rows, then the first of them repeated (a
    repeated index writes the same value, so the scatter stays
    deterministic).  Padded rows are left out: their all-zero block
    tables point at block 0, which may be a live row's slot.  With no
    active row, all 0: no row is live, and each write puts its slot's
    own value back."""
    flags = _host(active).astype(bool).ravel()
    act = np.flatnonzero(flags)
    rows = np.full(flags.size, act[0] if act.size else 0, np.int64)
    rows[:act.size] = act
    return rows


class _GroupSlots:
    """Where a decode group's rows write K/V, planned on the device over
    fixed [B] buffers (`_KVSlots` plans one call on the host).  Each
    step, the `write_rows` rows (device int64 [B]) write to
    arena[li, tables[b, pos // bs], pos % bs]; a row that is not live
    this step (it stopped) writes back the value its slot already holds,
    so the arena stays byte-identical there."""

    def __init__(self, tables, rows, bs: int):
        self.rows = rows
        self.tables = tables.index_select(0, rows).long()       # [B, MB]
        self.bs = bs

    def at(self, positions, live) -> "_GroupSlots":
        """This step's slots for `positions` [B] int64 and `live` [B]
        bool, device tensors."""
        pos = positions.index_select(0, self.rows)
        idx = (pos // self.bs).clamp(0, self.tables.shape[1] - 1)
        self.blk = self.tables.gather(1, idx[:, None])[:, 0]
        self.off = pos % self.bs
        self.keep = live.index_select(0, self.rows)
        return self

    def write(self, arena, li: int, k, v) -> None:
        for name, new in (("k", k), ("v", v)):
            a = arena[name]
            new = new.index_select(0, self.rows)
            if a.dim() == 4:
                new = new.reshape(new.shape[0], -1)
            old = a[li, self.blk, self.off]
            keep = self.keep.view(-1, *([1] * (new.dim() - 1)))
            a[li, self.blk, self.off] = torch.where(keep, new, old)


def _operand(x, device, dtype) -> torch.Tensor:
    """A group operand on `device`: host data copied once; a tensor as
    it is (a captured program's buffers already have the device and
    dtype, so nothing is copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return _dev(_host(x), device, dtype)


def _layer(params, li: int) -> Dict[str, torch.Tensor]:
    """Layer `li`'s weights as views into the stacked [L, ...] leaves (an
    fp8 dict's codes and scales each)."""
    return _layer_params(params["layers"], li)


def _kernels(cfg: TransformerConfig, arena):
    """(decode, prefill) attention for this arena's layout: the kernels,
    or their plain versions under cfg.attn_impl="jnp"."""
    plain = cfg.attn_impl == "jnp"
    if arena["k"].dim() == 4:
        return ((merged_decode_reference if plain
                 else merged_decode_attention),
                (merged_prefill_reference if plain
                 else merged_prefill_attention))
    return ((paged_decode_reference if plain else paged_decode_attention),
            (paged_prefill_reference if plain else paged_prefill_attention))


# the ALiBi slopes on each device, by (heads, head dim, scaled)
_SLOPES: Dict[tuple, torch.Tensor] = {}


def _slopes(cfg: TransformerConfig, device):
    """The model's ALiBi slopes (`alibi_slopes`) as one [NH] f32 tensor on
    `device`, made once and kept (a captured decode group reads it by
    address, so it is made before any capture); None without ALiBi."""
    if cfg.pos_emb != "alibi":
        return None
    key = (cfg.num_heads, cfg.head_dim, cfg.alibi_scaled,
           torch.device(device))
    if key not in _SLOPES:
        _SLOPES[key] = torch.from_numpy(alibi_slopes(cfg)).to(device)
    return _SLOPES[key]


def _attn_out(cfg: TransformerConfig, lp, li: int, attn, lora, rows):
    """The attention output projection of the flat rows `attn` [N, NH*D],
    plus the gather-LoRA epilogue when `lora` is given (the reference's
    order: dense, then `+ lora_delta(...).astype(dt)`)."""
    out = _dense(attn, lp["wo"], lp.get("bo"))
    if lora is not None:
        delta = (lora_delta_reference if cfg.attn_impl == "jnp"
                 else lora_delta)
        out = out + delta(attn, lora["a"][li], lora["b"][li],
                          rows).to(cfg.dtype)
    return out


# ----------------------------------------------------------------------
# layer math (the dense and MLP pieces are the model module's)
# ----------------------------------------------------------------------
def _mlp_delta(cfg: TransformerConfig, x, lp, col=_dense, row=_dense):
    """pre-norm -> dense MLP of `x`, without the residual add (`col` /
    `row`: the projections, as in `_mlp_block`): the tensor-parallel
    programs' MLP, which refuse expert layers (the single-device
    programs run `_block_out`, whose `_ffn` routes them)."""
    h = _norm(x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"), cfg.norm,
              cfg.norm_eps)
    return _mlp_block(cfg, lp, h, col, row)


def _qkv(cfg: TransformerConfig, lp, x, lead, positions, proj=_dense,
         regime_len=None):
    """Pre-norm (none for a post-norm block) and q/k/v projections of the
    flat rows `x` [N, H] (`proj(h, w, b)`, `_dense` or a tensor-parallel
    stage whose output rows and heads are this rank's), reshaped to
    `lead + (heads, D)`, with RoPE (scaled by `cfg.rope_scaling`) at
    `positions` (shaped `lead`; a 1-D lead is rotated as a length-1
    sequence); `regime_len` [lead[0]]: longrope's band length per row
    (None: max(positions) + 1)."""
    D = cfg.head_dim
    h = x if cfg.post_norm else _norm(x, lp["attn_norm_scale"],
                                      lp.get("attn_norm_bias"), cfg.norm,
                                      cfg.norm_eps)
    q = proj(h, lp["wq"], lp.get("bq")).reshape(*lead, -1, D)
    k = proj(h, lp["wk"], lp.get("bk")).reshape(*lead, -1, D)
    v = proj(h, lp["wv"], lp.get("bv")).reshape(*lead, -1, D)
    if cfg.pos_emb == "rope":
        rope = dict(theta=cfg.rope_theta, pct=cfg.rope_pct,
                    scaling=cfg.rope_scaling, regime_len=regime_len)
        if len(lead) == 1:
            q = _rope(q[:, None], positions[:, None], **rope)[:, 0]
            k = _rope(k[:, None], positions[:, None], **rope)[:, 0]
        else:
            q = _rope(q, positions, **rope)
            k = _rope(k, positions, **rope)
    return q, k, v


def _embed(cfg: TransformerConfig, params, tokens, positions):
    x = _embed_in(cfg, params, tokens, cfg.dtype)
    if cfg.pos_emb == "learned":
        # explicit clamp: prefill_full's padded bucket can exceed
        # max_seq_len (the engine rejects real tokens past it)
        pos = positions.clamp(0, cfg.max_seq_len - 1)
        x = x + params["pos_embed"][pos].to(cfg.dtype)
    if cfg.embed_norm:
        x = _norm(x, params["embed_norm_scale"], params["embed_norm_bias"],
                  "layernorm", cfg.norm_eps)
    return x


def _lm_logits(cfg: TransformerConfig, params, x):
    """f32 logits of the hidden rows `x` [N, H] (the reference's einsum
    with an f32 result: the product is taken in f32, not rounded to the
    compute dtype)."""
    if cfg.final_norm:
        x = _norm(x, params["final_norm_scale"],
                  params.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
    x = _head_hidden(params, x, x.dtype)
    head = params.get("lm_head")
    if head is None:
        head = params["tok_embed"].t()
    logits = x.float() @ head.float()
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    return logits


# ----------------------------------------------------------------------
# serving programs
# ----------------------------------------------------------------------
def _chunk_layers(cfg: TransformerConfig, params, arena, tokens, positions,
                  valid, pos0s, n_valids, tables, live, regime=None,
                  lora=None, rows=None):
    """The layers over NC chunks of C rows each, through the paged
    prefill kernels: the body `prefill_chunks` and `_span_core` share.
    Host data: tokens [NC, C]; positions [NC, C] (embedding and RoPE);
    valid [NC, C] (the rows that write K/V); pos0s, n_valids [NC] (each
    chunk's kernel call: query c at pos0 + c, rows past n_valid padding);
    tables [NC, MB]; live: the chunks the kernel runs.  regime [NC]
    (device) as `_qkv`'s `regime_len`; `lora` with `rows` the gather-LoRA
    epilogue.  Within each layer every chunk's keys are written first,
    then the chunks attend in order, so consecutive chunks of one
    sequence stay exact; projections and MLP batch over all NC*C rows.
    Returns the hidden rows x [NC*C, H] (the arena updated in place)."""
    dev = arena["k"].device
    NC, C = tokens.shape
    bs = arena["k"].shape[2]
    NH, D = cfg.num_heads, cfg.head_dim
    pos_t = _dev(positions, dev)
    x = _embed(cfg, params, _dev(tokens.ravel(), dev), pos_t.reshape(-1))
    slots = _KVSlots(tables, positions, valid, bs, dev)
    tables_t = _dev(tables, dev, torch.int32)
    attend = _kernels(cfg, arena)[1]
    slopes = _slopes(cfg, dev)
    for li, window in enumerate(layer_windows(cfg)):
        lp = _layer(params, li)
        q, k, v = _qkv(cfg, lp, x, (NC, C), pos_t, regime_len=regime)
        slots.write(arena, li, k.reshape(NC * C, *k.shape[2:]),
                    v.reshape(NC * C, *v.shape[2:]))
        attn = torch.zeros_like(q)
        for i in live:
            attn[i] = attend(q[i], arena["k"], arena["v"], tables_t[i],
                             int(pos0s[i]), int(n_valids[i]),
                             sliding_window=window, layer_idx=li,
                             alibi_slopes=slopes)
        x = _block_out(cfg, lp, x, _attn_out(
            cfg, lp, li, attn.reshape(NC * C, NH * D), lora, rows), li)
    return x


def prefill_chunks(cfg: TransformerConfig, params, arena, tokens, pos0s,
                   n_valids, block_tables, active, total_lens=None,
                   adapter_ids=None, lora=None):
    """Advance up to NC prompt chunks in one call (the ragged composition
    of Dynamic SplitFuse).  tokens: [NC, C] (padded); pos0s/n_valids:
    [NC]; block_tables: [NC, MB]; active: [NC]; total_lens: [NC] the
    whole prompt length of each chunk's sequence (longrope's band, as
    HF's one-shot forward of the prompt chooses it; None: each chunk's
    max position + 1) — all host data.  The layers are `_chunk_layers`;
    the logits batch over the chunks' last rows.
    adapter_ids: [NC] LoRA pool slot per chunk (< 0 = base model, host
    data) with `lora` = {"a": [L, slots, NH*D, r], "b": [L, slots, r, H]}:
    the attention output gains the gather-LoRA epilogue; lora=None runs
    exactly the single-tenant computation.
    Returns (logits [NC, V] f32 at each chunk's last valid token, arena
    updated in place).  Rows of inactive chunks are not computed by the
    attention (their logits are meaningless, as in the reference)."""
    dev = arena["k"].device
    tokens = _host(tokens)
    active = _host(active).astype(bool)
    pos0s = np.where(active, _host(pos0s), 0).astype(np.int64)
    n_valids = np.where(active, _host(n_valids), 0).astype(np.int64)
    tables = _host(block_tables).astype(np.int32)
    NC, C = tokens.shape
    H = cfg.hidden_size

    positions = pos0s[:, None] + np.arange(C)[None]               # [NC, C]
    valid = (np.arange(C)[None] < n_valids[:, None]) & active[:, None]
    regime = (None if total_lens is None
              else _dev(_host(total_lens).astype(np.int64), dev))
    live = [i for i in range(NC) if active[i] and n_valids[i] > 0]
    # each chunk's rows carry its slot (the reference's repeat by C)
    rows = (None if lora is None else
            LoraRows(np.repeat(_host(adapter_ids).astype(np.int32), C)))
    x = _chunk_layers(cfg, params, arena, tokens, positions, valid, pos0s,
                      n_valids, tables, live, regime, lora, rows)

    last = np.clip(n_valids - 1, 0, C - 1)
    xl = x.reshape(NC, C, H)[_dev(np.arange(NC), dev), _dev(last, dev)]
    return _lm_logits(cfg, params, xl), arena


def prefill_full_supported(cfg: TransformerConfig) -> bool:
    """Gate for the fresh-full-prompt fast path (the reference's gate):
    the dense causal flash path takes rope or learned positions in the
    pre-norm sequential block; ALiBi, windows (for every layer or one a
    layer), post-norm and parallel-residual blocks keep the chunked path,
    whose paged kernels carry their masks and bias.  It does not look at
    the head dim, so scheduling is the same on every device: on the card
    a head dim the flash kernel does not take (it takes 32, 64, 80, 96
    and 128) raises in the kernel's wrapper rather than moving the prompt
    to another path."""
    return (cfg.pos_emb in ("rope", "learned")
            and cfg.sliding_window is None
            and cfg.sliding_window_layers is None and not cfg.post_norm
            and not cfg.parallel_residual)


def prefill_full(cfg: TransformerConfig, params, arena, tokens, lens,
                 block_tables, active):
    """Prefill FRESH full prompts with dense causal flash attention.
    tokens: [NS, S] (zero-padded); lens: [NS]; block_tables: [NS, MB];
    active: [NS] — host data.  Each layer writes the valid rows' K/V into
    the paged arena for the decode phase; padded tail positions are never
    attended by valid queries (causality) and never written.  Returns
    (logits [NS, V] f32 at each prompt's last token, arena)."""
    dev = arena["k"].device
    tokens = _host(tokens)
    active = _host(active).astype(bool)
    lens = np.where(active, _host(lens), 0).astype(np.int64)
    tables = _host(block_tables).astype(np.int32)
    NS, S = tokens.shape
    bs = arena["k"].shape[2]
    NH, D, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size

    positions = np.broadcast_to(np.arange(S)[None], (NS, S))
    valid = positions < lens[:, None]
    pos_t = _dev(positions, dev)
    regime = _dev(lens, dev)    # longrope's band: the prompt's length
    x = _embed(cfg, params, _dev(tokens.ravel(), dev), pos_t.reshape(-1))
    slots = _KVSlots(tables, positions, valid, bs, dev)

    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        q, k, v = _qkv(cfg, lp, x, (NS, S), pos_t, regime_len=regime)
        slots.write(arena, li, k.reshape(NS * S, *k.shape[2:]),
                    v.reshape(NS * S, *v.shape[2:]))
        attn = causal_attention(q, k, v, plain=cfg.attn_impl == "jnp")
        x = _block_out(cfg, lp, x, _dense(attn.reshape(NS * S, NH * D),
                                          lp["wo"], lp.get("bo")), li)

    last = np.clip(lens - 1, 0, S - 1)
    xl = x.reshape(NS, S, H)[_dev(np.arange(NS), dev), _dev(last, dev)]
    return _lm_logits(cfg, params, xl), arena


def _decode_layers(cfg: TransformerConfig, params, arena, tokens, pos_t,
                   tables_t, lens_t, slots, rows, lora):
    """The layers of one decode step for B rows, on the device: tokens
    and positions `pos_t` [B], block tables `tables_t` [B, MB] int32, the
    kernel's `lens_t` [B] int32 (< 0: a row that is not live), `slots`
    (a `_KVSlots` or `_GroupSlots`: where the rows write K/V), `rows` (a
    `LoraRows`) with `lora`.  An arena with the "moe_census" rider takes
    every row's router counts of every expert layer, added in place (all
    B rows, as the reference's decode core counts them).  Returns (logits
    [B, V] f32, arena)."""
    B = pos_t.shape[0]
    NH, D = cfg.num_heads, cfg.head_dim
    x = _embed(cfg, params, tokens.long(), pos_t)                  # [B, H]
    attend = _kernels(cfg, arena)[0]
    slopes = _slopes(cfg, x.device)
    census = arena.get("moe_census")
    for li, window in enumerate(layer_windows(cfg)):
        lp = _layer(params, li)
        q, k, v = _qkv(cfg, lp, x, (B,), pos_t)
        slots.write(arena, li, k, v)
        attn = attend(q, arena["k"], arena["v"], tables_t, lens_t,
                      layer_idx=li, sliding_window=window,
                      alibi_slopes=slopes)
        x = _block_out(cfg, lp, x, _attn_out(
            cfg, lp, li, attn.reshape(B, NH * D), lora, rows), li, census)
    return _lm_logits(cfg, params, x), arena


def _decode_core(cfg: TransformerConfig, params, arena, tokens, seq_lens,
                 block_tables, active, adapter_ids=None, lora=None):
    """One token for each of B rows.  tokens: [B] (a device tensor — the
    previous step's samples — or host data); seq_lens (each row's new
    token position), block_tables [B, MB], active [B]: host data;
    adapter_ids [B] (host data or a `LoraRows`) with `lora`: the
    gather-LoRA epilogue, as in `prefill_chunks`."""
    dev = arena["k"].device
    if not isinstance(tokens, torch.Tensor):
        tokens = _dev(_host(tokens), dev)
    active = _host(active).astype(bool)
    positions = _host(seq_lens).astype(np.int64)
    tables = _host(block_tables).astype(np.int32)
    bs = arena["k"].shape[2]
    slots = _KVSlots(tables, positions[:, None], active, bs, dev)
    # the kernel's inactive-row marker: lens < 0 gives zeros
    lens_t = _dev(np.where(active, positions, -1), dev, torch.int32)
    rows = None if lora is None else LoraRows.of(adapter_ids)
    return _decode_layers(cfg, params, arena, tokens.to(dev),
                          _dev(positions, dev), _dev(tables, dev, torch.int32),
                          lens_t, slots, rows, lora)


def decode_step(cfg: TransformerConfig, params, arena, tokens, seq_lens,
                block_tables, active, adapter_ids=None, lora=None):
    """One generated token for up to B sequences: (logits [B, V] f32,
    arena).  Shapes as in `_decode_core`; inactive rows are inert."""
    return _decode_core(cfg, params, arena, tokens, seq_lens, block_tables,
                        active, adapter_ids=adapter_ids, lora=lora)


# ----------------------------------------------------------------------
# sampling
# ----------------------------------------------------------------------
def _draw(probs, generator):
    """One draw per row of `probs` [B, V] from `generator`: torch's own
    one-sample `multinomial` algorithm (argmax of p / q with q ~ Exp(1)),
    so the same generator state gives the same tokens, without the
    validity check it makes on the host — a read of the device that a
    captured decode step may not make."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


def _sample_tokens(logits, generator, mode: str, temperature, top_k):
    """Sampling on the logits' device.  mode: "greedy" | "sample" |
    "per_row" (temperature and top_k are then [B] tensors; rows with
    temperature <= 0 take the argmax).  Stochastic rows draw from
    `generator` — torch's stream, not jax.random's, so only the
    distribution matches the reference."""
    if mode == "greedy":
        return logits.argmax(dim=-1).to(torch.int32)
    if mode == "per_row":
        return _sample_per_row(logits, generator, temperature, top_k)
    if mode != "sample":
        raise ValueError(
            f"unknown sampling mode {mode!r} (greedy | sample | per_row)")
    from ..sampling import scale_topk
    probs = torch.softmax(scale_topk(logits, temperature, top_k), dim=-1)
    return _draw(probs, generator).to(torch.int32)


# -- counter-based sampling streams (Philox4x64-10 in int64 lanes) --------
# A seeded request's token `position` is drawn from numpy's Philox bit
# generator keyed by (seed, position) — the reference's
# serving/streaming.seeded_uniform.  To sample on the device without a
# host round trip, the block cipher runs here on torch tensors: every
# 64-bit word is a (hi, lo) pair of 32-bit words held in int64 lanes, and
# the 64x64 multiplies go through 16-bit limbs, so every product stays
# below 2**32 (the reference's uint32 arithmetic; torch's uint32 covers
# few ops).  numpy's Generator bumps the counter before its first draw,
# so the word behind seeded_uniform(seed, position) is output word 0 of
# the block at counter (1, 0, 0, 0).
_M32, _M16 = 0xFFFFFFFF, 0xFFFF
_PHILOX_M0 = (0xD2E7470E, 0xE14C6C93)   # round multipliers (hi, lo)
_PHILOX_M1 = (0xCA5A8263, 0x95121157)
_PHILOX_W0 = (0x9E3779B9, 0x7F4A7C15)   # key-schedule Weyl constants
_PHILOX_W1 = (0xBB67AE85, 0x84CAA73B)


def _umul32(x, y):
    """Unsigned 32x32 -> 64 multiply of int64 lanes holding 32-bit words,
    as (hi, lo) words, through 16-bit limbs."""
    xl, xh = x & _M16, x >> 16
    yl, yh = y & _M16, y >> 16
    ll, lh, hl, hh = xl * yl, xl * yh, xh * yl, xh * yh
    t = (ll >> 16) + (lh & _M16) + (hl & _M16)
    lo = (ll & _M16) | ((t & _M16) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (t >> 16)
    return hi, lo


def _add64(ah, al, bh, bl):
    """(ah, al) + (bh, bl) mod 2**64, in 32-bit words."""
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _mul64(ah, al, bh, bl):
    """64x64 -> 128 multiply: four 32-bit words, most significant first.
    The four 32x32 partial products are one `_umul32` over a stacked
    axis."""
    ah, al, bh, bl = torch.broadcast_tensors(ah, al, bh, bl)
    hi, lo = _umul32(torch.stack([al, al, ah, ah]),
                     torch.stack([bl, bh, bl, bh]))
    (p0h, p1h, p2h, p3h), (p0l, p1l, p2l, p3l) = hi, lo
    w1 = p0h + p1l + p2l
    w2 = p1h + p2h + p3l + (w1 >> 32)
    w3 = p3h + (w2 >> 32)
    return w3 & _M32, w2 & _M32, w1 & _M32, p0l


def philox_word(seed_hi, seed_lo, pos_hi, pos_lo):
    """Output word 0 of the Philox4x64-10 block at counter (1, 0, 0, 0)
    keyed by (seed, position), as a (hi, lo) pair of int64 tensors
    holding 32-bit words — the u64 numpy's Generator(Philox(key=[seed,
    position])).random() turns into a double.  Inputs: 32-bit words
    (tensors or ints, any shapes that broadcast).  Each round's two
    multiplies are one `_mul64` over a leading axis of 2."""
    words = [torch.as_tensor(w, dtype=torch.int64) for w in
             (seed_hi, seed_lo, pos_hi, pos_lo)]
    dev = next((w.device for w in (seed_hi, seed_lo, pos_hi, pos_lo)
                if isinstance(w, torch.Tensor)), torch.device("cpu"))
    k0h, k0l, k1h, k1l = (w.to(dev) & _M32
                          for w in torch.broadcast_tensors(*words))
    z = torch.zeros_like(k0h)
    c0h, c0l, c1h, c1l = z, z + 1, z, z       # counter bumped pre-draw
    c2h, c2l, c3h, c3l = z, z, z, z
    # the multipliers filled on the device (a captured step copies no
    # host data)
    mh = torch.stack([z + _PHILOX_M0[0], z + _PHILOX_M1[0]])
    ml = torch.stack([z + _PHILOX_M0[1], z + _PHILOX_M1[1]])
    for r in range(10):
        if r:
            k0h, k0l = _add64(k0h, k0l, *_PHILOX_W0)
            k1h, k1l = _add64(k1h, k1l, *_PHILOX_W1)
        # [0]: M0 * c0, [1]: M1 * c2
        p3, p2, p1, p0 = _mul64(mh, ml, torch.stack([c0h, c2h]),
                                torch.stack([c0l, c2l]))
        c0h, c0l, c2h, c2l = (p3[1] ^ c1h ^ k0h, p2[1] ^ c1l ^ k0l,
                              p3[0] ^ c3h ^ k1h, p2[0] ^ c3l ^ k1l)
        c1h, c1l, c3h, c3l = p1[1], p0[1], p1[0], p0[0]
    return c0h, c0l


def seeded_uniform24(seed_hi, seed_lo, position):
    """f32 uniform in [0, 1) from the TOP 24 bits of the (seed, position)
    Philox word: the host's 53-bit draw (serving/streaming.seeded_uniform
    in the reference) truncated, never rounded.  `position`: the token's
    index in the generated stream (taken mod 2**32, as the reference's
    uint32 cast); seed words: 32-bit words."""
    pos = torch.as_tensor(position, dtype=torch.int64)
    if isinstance(seed_hi, torch.Tensor):
        pos = pos.to(seed_hi.device)
    pos = pos & _M32
    hi, _ = philox_word(seed_hi, seed_lo, torch.zeros_like(pos), pos)
    return (hi >> 8).to(torch.float32) * (2.0 ** -24)


def _seeded_pick(scaled_logits, u):
    """Inverse-CDF draw (the reference's, after serving/streaming.
    seeded_sample): the number of CDF entries <= u * total, clipped to
    the last bin.  `scaled_logits` [B, V]: the temperature-scaled,
    top-k-masked logits (-inf holes have probability 0, a flat CDF);
    `u` [B] the rows' uniforms; f32 throughout."""
    p = torch.softmax(scaled_logits.float(), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    t = u * cdf[:, -1]
    idx = (cdf <= t[:, None]).sum(dim=-1)
    return idx.clamp(max=cdf.shape[-1] - 1).to(torch.int32)


def _sample_per_row(logits, generator, temperature, top_k_vec, seed_hi=None,
                    seed_lo=None, seed_pos=None, has_seed=None, mask=None,
                    *, uniform=None):
    """mode="per_row" sampling with optional counter-based streams: rows
    flagged by `has_seed` [B] bool draw token `seed_pos` of their (seed)
    Philox stream by inverse CDF (or take `uniform` [B], their uniforms
    drawn beforehand), unflagged stochastic rows draw from `generator`,
    and rows with temperature <= 0 take the argmax.  `temperature` [B],
    `top_k_vec` [B]: tensors on the logits' device.  Grammar masks are
    refused by name."""
    if mask is not None:
        raise NotImplementedError(
            "grammar-constrained sampling masks (structured generation) "
            "are not carried by the PyTorch port yet")
    from ..sampling import scale_topk_per_row
    t = temperature.float()
    scaled = scale_topk_per_row(logits, t, top_k_vec)
    drawn = _draw(torch.softmax(scaled, dim=-1), generator)
    if uniform is None and seed_hi is not None:
        uniform = seeded_uniform24(seed_hi, seed_lo, seed_pos)
    if uniform is not None:
        drawn = torch.where(has_seed, _seeded_pick(scaled, uniform).long(),
                            drawn)
    return torch.where(t <= 0.0, logits.argmax(dim=-1),
                       drawn).to(torch.int32)


def sample_tokens_compiled(logits, generator, temperature, top_k_vec=None,
                           seed_hi=None, seed_lo=None, seed_pos=None,
                           has_seed=None, *, mode: str = "greedy",
                           top_k: int = 0):
    """The engine's batched first-token sampler (the reference compiles
    this chain; eager PyTorch runs it as is).  mode="per_row" reads
    `top_k_vec` and the optional seed operands (32-bit seed words, [B]
    positions, [B] flags); scalar modes use `top_k` and refuse seeds."""
    if mode == "per_row":
        return _sample_per_row(logits, generator, temperature, top_k_vec,
                               seed_hi, seed_lo, seed_pos, has_seed)
    if seed_hi is not None:
        raise ValueError(
            "seeded sampling operands need mode='per_row' (the flag "
            "vector decides per row; scalar modes have no row axis)")
    return _sample_tokens(logits, generator, mode, temperature, top_k)


# ----------------------------------------------------------------------
# decode groups: k steps planned on the device
# ----------------------------------------------------------------------
def _group_inputs(arena, tokens, seq_lens, block_tables, active, rows):
    """A group's common operands on the arena's device: (tokens, lens
    int64, tables int32, active bool, `_GroupSlots`).  `rows`: the
    `write_rows` buffer, or None to derive it from the host `active`."""
    dev = arena["k"].device
    if rows is None:
        rows = write_rows(active)
    tables = _operand(block_tables, dev, torch.int32)
    slots = _GroupSlots(tables, _operand(rows, dev, torch.int64),
                        arena["k"].shape[2])
    return (_operand(tokens, dev, torch.int64),
            _operand(seq_lens, dev, torch.int64), tables,
            _operand(active, dev, torch.bool), slots)


def _group_step(cfg, params, arena, toks, lens, live, tables, slots, rows,
                lora):
    """One step of a decode group: the live rows write K/V and attend;
    (logits [B, V] f32, arena)."""
    lens_k = torch.where(live, lens, -1).to(torch.int32)
    return _decode_layers(cfg, params, arena, toks, lens, tables, lens_k,
                          slots.at(lens, live), rows, lora)


def _uniforms(seed_hi, seed_lo, seed_pos, n: int, device):
    """[B, n] f32: each row's uniforms for stream positions seed_pos + j
    (a row live at step j has emitted j tokens of the group, so this is
    the reference's seed_pos + emitted for every draw that is kept)."""
    pos = _operand(seed_pos, device, torch.int64)
    steps = torch.arange(n, device=device, dtype=torch.int64)
    return seeded_uniform24(_operand(seed_hi, device, torch.int64)[:, None],
                            _operand(seed_lo, device, torch.int64)[:, None],
                            pos[:, None] + steps[None])


def decode_tokens(cfg: TransformerConfig, params, arena, tokens, seq_lens,
                  block_tables, active, rng, temperature=1.0,
                  max_len=None, top_k_vec=None, adapter_ids=None, lora=None,
                  seed_hi=None, seed_lo=None, seed_pos=None, has_seed=None,
                  *, n_steps: int = 8, mode: str = "greedy", top_k: int = 0,
                  rows=None):
    """`n_steps` decode iterations with sampling on the device: sample ->
    append KV -> feed back, every step planned on the device, so no step
    reads the device from the host (the engine captures and replays the
    burst as one CUDA graph on the card).  Operands may be host data or
    device tensors.  `max_len` [B]: each row's KV-lease bound — positions
    clamp to max_len-1 so an overshooting tail burst re-writes the last
    leased slot (the host trims its tokens).  adapter_ids [B] with
    `lora`: the gather-LoRA epilogue on every step.  Seed operands
    (`seed_hi`/`seed_lo` [B] 32-bit words, `seed_pos` [B] the stream
    index of the burst's first token, `has_seed` [B] bool; mode="per_row"
    only) send the flagged rows through their Philox streams, token j at
    seed_pos + j.  `rows`: the `write_rows` buffer (derived from host
    `active` when None).  Returns (tokens [B, n_steps] int32 on the
    device, arena)."""
    seeded = seed_hi is not None
    if seeded and mode != "per_row":
        raise ValueError(
            "seeded burst decode needs mode='per_row' (per-row seed "
            "flags have no meaning for scalar sampling signatures)")
    dev = arena["k"].device
    toks, lens, tables, act, slots = _group_inputs(
        arena, tokens, seq_lens, block_tables, active, rows)
    cap = None if max_len is None else _operand(max_len, dev,
                                                torch.int64) - 1
    if mode == "per_row":
        temperature = _operand(temperature, dev, torch.float32)
        top_k = _operand(top_k_vec, dev, torch.int64)
    u = flags = None
    if seeded:
        u = _uniforms(seed_hi, seed_lo, seed_pos, n_steps, dev)
        flags = _operand(has_seed, dev, torch.bool)
    lrows = None if lora is None else LoraRows.of(adapter_ids)
    out = []
    for j in range(n_steps):
        logits, arena = _group_step(cfg, params, arena, toks, lens, act,
                                    tables, slots, lrows, lora)
        if seeded:
            toks = _sample_per_row(logits, rng, temperature, top_k,
                                   has_seed=flags, uniform=u[:, j])
        else:
            toks = _sample_tokens(logits, rng, mode, temperature, top_k)
        out.append(toks)
        lens = lens + 1
        if cap is not None:
            lens = torch.minimum(lens, cap)
    return torch.stack(out, dim=1), arena


def decode_multi_step(cfg: TransformerConfig, params, arena, tokens,
                      seq_lens, block_tables, active, rng, temperature,
                      max_len, top_k_vec, eos_ids, budget, seed_hi=None,
                      seed_lo=None, seed_pos=None, has_seed=None,
                      adapter_ids=None, lora=None, fsm_trans=None,
                      fsm_mask=None, fsm_accept=None, fsm_state=None,
                      has_fsm=None, *, k: int = 8, rows=None):
    """`k` decode steps with per-row sampling AND per-row termination on
    the device, one packed result for the host (the reference's
    host-free step group):

    - a row stops when it samples its `eos_ids` token (>= 0; -1 disables
      EOS) or has emitted its `budget` (<= k) tokens; a stopped row pins
      its length, writes no KV (`_GroupSlots` puts its slot's own value
      back) and emits -1 for its remaining steps;
    - sampling is per row (`temperature` [B], `top_k_vec` [B]; rows with
      temperature <= 0 take the argmax, bit-identical to greedy): rows
      flagged by `has_seed` draw token seed_pos + emitted of their Philox
      stream, the other stochastic rows draw from `rng`.  The seed
      operands may be None (no seeded row: no stream is computed);
    - `max_len` clamps positions as in `decode_tokens`.

    Operands may be host data or device tensors; `rows` as in
    `decode_tokens`.  The grammar operands (`fsm_*`) are refused by name.
    Returns (packed [B, k+1] int32 on the device: k tokens, -1 past a
    row's stop, then the number it emitted; arena)."""
    if any(x is not None for x in (fsm_trans, fsm_mask, fsm_accept,
                                   fsm_state, has_fsm)):
        raise NotImplementedError(
            "decode_multi_step(fsm=...): grammar-constrained step groups "
            "(structured generation) are not carried by the PyTorch port "
            "yet")
    if k < 1:
        raise ValueError(f"decode_multi_step needs k >= 1, got {k}")
    dev = arena["k"].device
    toks, lens, tables, act, slots = _group_inputs(
        arena, tokens, seq_lens, block_tables, active, rows)
    temperature = _operand(temperature, dev, torch.float32)
    top_k = _operand(top_k_vec, dev, torch.int64)
    eos = _operand(eos_ids, dev, torch.int64)
    budget = _operand(budget, dev, torch.int64)
    cap = _operand(max_len, dev, torch.int64) - 1
    u = flags = None
    if seed_hi is not None:
        u = _uniforms(seed_hi, seed_lo, seed_pos, k, dev)
        flags = _operand(has_seed, dev, torch.bool)
    lrows = None if lora is None else LoraRows.of(adapter_ids)
    alive = torch.ones_like(act)
    e = torch.zeros_like(lens)
    emitted = []
    for j in range(k):
        live = act & alive
        logits, arena = _group_step(cfg, params, arena, toks, lens, live,
                                    tables, slots, lrows, lora)
        nxt = _sample_per_row(logits, rng, temperature, top_k,
                              has_seed=flags,
                              uniform=None if u is None else u[:, j]).long()
        e_next = torch.where(live, e + 1, e)
        stop = ((eos >= 0) & (nxt == eos)) | (e_next >= budget)
        alive = alive & ~stop
        lens = torch.where(live, torch.minimum(lens + 1, cap), lens)
        toks = torch.where(live, nxt, toks)
        emitted.append(torch.where(live, nxt, -1))
        e = e_next
    packed = torch.cat([torch.stack(emitted, dim=1), e[:, None]], dim=1)
    return packed.to(torch.int32), arena


def decode_loop(core, arena, tokens, seq_lens, rng, temperature=1.0,
                max_len=None, top_k_vec=None, *, n_steps: int,
                mode: str = "greedy", top_k: int = 0):
    """`decode_tokens`' burst over any one-step core planned on the host:
    `core(arena, tokens, lens)` -> (logits [B, V] f32, arena).  The
    tensor-parallel programs' burst."""
    lens = _host(seq_lens).astype(np.int64)
    cap = None if max_len is None else _host(max_len).astype(np.int64) - 1
    toks = tokens
    out = []
    for _ in range(n_steps):
        logits, arena = core(arena, toks, lens)
        toks = _sample_tokens(logits, rng, mode, temperature,
                              top_k_vec if mode == "per_row" else top_k)
        out.append(toks)
        lens = lens + 1
        if cap is not None:
            lens = np.minimum(lens, cap)
    return torch.stack(out, dim=1), arena


# ----------------------------------------------------------------------
# draft-and-verify (speculative decoding)
# ----------------------------------------------------------------------
def _refuse_fsm(*fsm) -> None:
    if any(x is not None for x in fsm):
        raise NotImplementedError(
            "verify_tokens(fsm_mask=...): grammar-constrained verify spans "
            "(structured generation) are not carried by the PyTorch port "
            "yet")


def _spec_accept(logits, tokens, n_valids, generator, mode: str,
                 temperature, top_k_vec, fsm_mask=None, fsm_accept=None,
                 span_states=None, has_fsm=None, fsm_eos=None):
    """Accept/reject of a verified draft span, on the logits' device.

    logits: [B, S, V] f32, position i the model's distribution after
    tokens[b, :i+1]; tokens: [B, S], column 0 the pending input token,
    columns 1.. the draft; n_valids: [B] = 1 + draft length (host data
    or tensors).

    Greedy rows accept draft token i+1 iff it equals argmax(logits_i);
    the accepted count is the cumulative product of the matches.
    `mode="per_row"` rows with temperature > 0 use rejection sampling
    against the point-mass draft: accept d with probability p(d) (one
    uniform a position from `generator`); on a reject, the replacement is
    drawn from p with d masked out (the exact residual for a
    deterministic drafter), at full acceptance the bonus from p itself
    (`_draw`); rows with temperature <= 0 verify greedily.  The emitted
    stream is distributed as spec-off sampling, not the same stream.
    Returns (emitted [B, S] int32, n_emitted [B] int32): row b emits
    emitted[b, :n_emitted[b]], its accepted prefix and one replacement or
    bonus token, 1 to n_valids[b] tokens.  The grammar operands
    (`fsm_*`) are refused by name."""
    _refuse_fsm(fsm_mask, fsm_accept, span_states, has_fsm, fsm_eos)
    B, S, V = logits.shape
    dev = logits.device
    tokens = _operand(tokens, dev, torch.int64)
    n_valids = _operand(n_valids, dev, torch.int64)
    idx = torch.arange(S, device=dev)[None]                       # [1, S]
    in_draft = idx < (n_valids - 1)[:, None]                      # [B, S]
    # the draft token checked at position i is tokens[:, i+1] (the wrap
    # of column 0 lands only where in_draft is False)
    nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    greedy_tgt = logits.argmax(dim=-1)                            # [B, S]
    if mode == "greedy":
        m = (nxt == greedy_tgt) & in_draft
        n_acc = torch.cumprod(m.long(), dim=1).sum(dim=1)
        return greedy_tgt.to(torch.int32), (n_acc + 1).to(torch.int32)
    if mode != "per_row":
        raise ValueError(f"unknown verify mode {mode!r} (greedy | per_row)")
    from ..sampling import scale_topk_per_row
    t = _operand(temperature, dev, torch.float32)                 # [B]
    k = _operand(top_k_vec, dev, torch.int64)                     # [B]
    scaled = scale_topk_per_row(
        logits.reshape(B * S, V), t.repeat_interleave(S),
        k.repeat_interleave(S)).reshape(B, S, V)
    p_d = torch.log_softmax(scaled, dim=-1).gather(
        -1, nxt[..., None])[..., 0].exp()                         # [B, S]
    u = torch.rand((B, S), generator=generator, device=dev)
    greedy_rows = (t <= 0.0)[:, None]
    m = torch.where(greedy_rows, nxt == greedy_tgt, u < p_d) & in_draft
    n_acc = torch.cumprod(m.long(), dim=1).sum(dim=1)
    # the replacement at every position: at a reject (inside the draft)
    # the residual, the target with the rejected token masked out; at the
    # full-accept boundary (i == draft length) the bonus from the target.
    # Read only at the boundary each row reached.
    at_d = scaled.gather(-1, nxt[..., None])
    hole = torch.where(in_draft[..., None],
                       torch.full_like(at_d, float("-inf")), at_d)
    masked = scaled.scatter(-1, nxt[..., None], hole)
    samp = _draw(torch.softmax(masked, dim=-1).reshape(B * S, V),
                 generator).reshape(B, S)
    tail = torch.where(greedy_rows, greedy_tgt, samp)
    emitted = torch.where(idx < n_acc[:, None], nxt, tail)
    return emitted.to(torch.int32), (n_acc + 1).to(torch.int32)


def _span_plan(tokens, seq_lens, n_valids, active, max_len):
    """A verify span's host plan: (tokens, pos0s, n_valids, positions,
    valid, live).  Span position i of row b sits at seq_lens[b] + i; with
    `max_len` [B] (each row's KV-lease bound) the positions at or past it
    drop their K/V writes (a clamp would overwrite an in-lease slot
    before the attention reads it) and clamp to max_len - 1 for the
    embedding and RoPE; their logits are meaningless and the host trims
    their tokens.  The kernel still takes each live row at (pos0 =
    seq_lens, n_valid = n_valids), as the reference's."""
    tokens = _host(tokens)
    active = _host(active).astype(bool)
    pos0s = _host(seq_lens).astype(np.int64)
    n_valids = _host(n_valids).astype(np.int64)
    B, S = tokens.shape
    positions = pos0s[:, None] + np.arange(S)[None]                # [B, S]
    valid = (np.arange(S)[None] < n_valids[:, None]) & active[:, None]
    if max_len is not None:
        cap = _host(max_len).astype(np.int64)[:, None]
        valid &= positions < cap
        positions = np.minimum(positions, cap - 1)
    live = [i for i in range(B) if active[i] and n_valids[i] > 0]
    return tokens, pos0s, n_valids, positions, valid, live


def _span_core(cfg: TransformerConfig, params, arena, tokens, seq_lens,
               n_valids, block_tables, active, max_len=None):
    """Forward over a [B, S] token span per row (the verify step's body):
    each row's span is one prefill chunk (C = S, pos0 = seq_lens, n_valid
    = n_valids) through `_chunk_layers`, its keys written before the
    attention, so position i attends its own draft prefix.  Longrope's
    band is each row's max span position + 1 (no `regime_len`, as the
    reference's span).  Returns (logits [B, S, V] f32 at every span
    position, arena updated in place).  Host data in, as
    `prefill_chunks`."""
    tokens, pos0s, n_valids, positions, valid, live = _span_plan(
        tokens, seq_lens, n_valids, active, max_len)
    B, S = tokens.shape
    x = _chunk_layers(cfg, params, arena, tokens, positions, valid, pos0s,
                      n_valids, _host(block_tables).astype(np.int32), live)
    return _lm_logits(cfg, params, x).reshape(B, S, -1), arena


def verify_tokens(cfg: TransformerConfig, params, arena, tokens, seq_lens,
                  n_valids, block_tables, active, generator,
                  temperature=0.0, max_len=None, top_k_vec=None,
                  fsm_mask=None, fsm_accept=None, span_states=None,
                  has_fsm=None, fsm_eos=None, *, mode: str = "greedy"):
    """Draft-and-verify: advance up to B rows by a whole draft span in
    one call — the span forward (`_span_core`: [pending, draft...] of
    each row through the paged prefill kernels, its K/V written to the
    arena) and the accept/reject on the device (`_spec_accept`).  One
    span moves every weight once for up to S tokens of progress, where S
    sequential decode steps move them S times.

    tokens [B, S]: column 0 each row's pending token, columns 1.. its
    draft, zero-padded; n_valids [B] = 1 + draft length; seq_lens [B]
    the pending token's position; block_tables [B, MB]; active [B];
    max_len [B] the KV-lease bound (see `_span_plan`) — host data.
    `generator` is read by stochastic rows only; temperature / top_k_vec
    are [B] under mode="per_row" (rows with temperature <= 0 verify
    greedily).  Grammar operands are refused by name.
    Returns (emitted [B, S] int32, n_emitted [B] int32, arena), on the
    device."""
    _refuse_fsm(fsm_mask, fsm_accept, span_states, has_fsm, fsm_eos)
    logits, arena = _span_core(cfg, params, arena, tokens, seq_lens,
                               n_valids, block_tables, active, max_len)
    emitted, n_emitted = _spec_accept(logits, tokens, n_valids, generator,
                                      mode, temperature, top_k_vec)
    return emitted, n_emitted, arena
