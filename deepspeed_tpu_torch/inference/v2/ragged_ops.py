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

Scope: the pre-norm sequential dense families (the config refuses the
rest).  No seeded streams, grammar masks, drafts or multi-step groups.
Tensor parallelism runs the same layer pieces (`_qkv`, `_mlp_delta`,
`_KVSlots`, `_kernels`, `decode_loop`) through `tp_ragged.py`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...models.transformer import (TransformerConfig, _dense, _embed_in,
                                   _head_hidden, _mlp_block, _norm, _rope)
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
           "sample_tokens_compiled"]


def init_arena(cfg: TransformerConfig, num_blocks: int, block_size: int,
               device, merged="auto", kv_heads: int = None
               ) -> Dict[str, torch.Tensor]:
    """Zeroed KV arena {"k", "v"} in cfg.dtype on `device`, each
    [L, num_blocks, block_size, NKV, D], or [L, num_blocks, block_size,
    NKV*D] with merged=True; `kv_heads` overrides NKV (a tensor-parallel
    rank holds its NKV/tp local heads).  The reference merges to dodge
    the TPU's 128-lane padding of a narrow head dim; a GPU pads nothing,
    so "auto" keeps the 5-D layout here, and merged=True stores the same
    bytes under the reference's merged shape (the serving functions
    branch on the arena's rank, as the reference's do)."""
    if merged not in ("auto", False, True):
        raise ValueError(f"merged must be 'auto', False or True, got "
                         f"{merged!r}")
    nkv = cfg.kv_heads if kv_heads is None else kv_heads
    shape = (cfg.num_layers, num_blocks, block_size, nkv, cfg.head_dim)
    if merged is True:
        shape = shape[:3] + (nkv * cfg.head_dim,)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


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


def _layer(params, li: int) -> Dict[str, torch.Tensor]:
    """Layer `li`'s weights as views into the stacked [L, ...] leaves."""
    return {k: w[li] for k, w in params["layers"].items()}


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
    """pre-norm -> MLP of `x`, without the residual add (`col` / `row`:
    the projections, as in `_mlp_block`)."""
    h = _norm(x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"), cfg.norm,
              cfg.norm_eps)
    return _mlp_block(cfg, lp, h, col, row)


def _qkv(cfg: TransformerConfig, lp, x, lead, positions, proj=_dense):
    """Pre-norm and q/k/v projections of the flat rows `x` [N, H]
    (`proj(h, w, b)`, `_dense` or a tensor-parallel stage whose output
    rows and heads are this rank's), reshaped to `lead + (heads, D)`, with
    RoPE at `positions` (shaped `lead`; a 1-D lead is rotated as a
    length-1 sequence)."""
    D = cfg.head_dim
    h = _norm(x, lp["attn_norm_scale"], lp.get("attn_norm_bias"), cfg.norm,
              cfg.norm_eps)
    q = proj(h, lp["wq"], lp.get("bq")).reshape(*lead, -1, D)
    k = proj(h, lp["wk"], lp.get("bk")).reshape(*lead, -1, D)
    v = proj(h, lp["wv"], lp.get("bv")).reshape(*lead, -1, D)
    if cfg.pos_emb == "rope":
        if len(lead) == 1:
            q = _rope(q[:, None], positions[:, None], cfg.rope_theta,
                      cfg.rope_pct)[:, 0]
            k = _rope(k[:, None], positions[:, None], cfg.rope_theta,
                      cfg.rope_pct)[:, 0]
        else:
            q = _rope(q, positions, cfg.rope_theta, cfg.rope_pct)
            k = _rope(k, positions, cfg.rope_theta, cfg.rope_pct)
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
def prefill_chunks(cfg: TransformerConfig, params, arena, tokens, pos0s,
                   n_valids, block_tables, active, adapter_ids=None,
                   lora=None):
    """Advance up to NC prompt chunks in one call (the ragged composition
    of Dynamic SplitFuse).  tokens: [NC, C] (padded); pos0s/n_valids:
    [NC]; block_tables: [NC, MB]; active: [NC] — all host data.  Within
    each layer every chunk's keys are written first, then the chunks
    attend in scheduling order, so consecutive chunks of one prompt stay
    exact; projections, MLP and logits batch over all NC*C rows.
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
    bs = arena["k"].shape[2]
    NH, D, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size

    positions = pos0s[:, None] + np.arange(C)[None]               # [NC, C]
    valid = (np.arange(C)[None] < n_valids[:, None]) & active[:, None]
    pos_t = _dev(positions, dev)
    x = _embed(cfg, params, _dev(tokens.ravel(), dev), pos_t.reshape(-1))
    slots = _KVSlots(tables, positions, valid, bs, dev)
    tables_t = _dev(tables, dev, torch.int32)
    live = [i for i in range(NC) if active[i] and n_valids[i] > 0]
    attend = _kernels(cfg, arena)[1]
    # each chunk's rows carry its slot (the reference's repeat by C)
    rows = (None if lora is None else
            LoraRows(np.repeat(_host(adapter_ids).astype(np.int32), C)))

    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        q, k, v = _qkv(cfg, lp, x, (NC, C), pos_t)
        slots.write(arena, li, k.reshape(NC * C, *k.shape[2:]),
                    v.reshape(NC * C, *v.shape[2:]))
        attn = torch.zeros_like(q)
        for i in live:
            attn[i] = attend(q[i], arena["k"], arena["v"], tables_t[i],
                             int(pos0s[i]), int(n_valids[i]),
                             sliding_window=cfg.sliding_window,
                             layer_idx=li)
        x = x + _attn_out(cfg, lp, li, attn.reshape(NC * C, NH * D), lora,
                          rows)
        x = x + _mlp_delta(cfg, x, lp)

    last = np.clip(n_valids - 1, 0, C - 1)
    xl = x.reshape(NC, C, H)[_dev(np.arange(NC), dev), _dev(last, dev)]
    return _lm_logits(cfg, params, xl), arena


def prefill_full_supported(cfg: TransformerConfig) -> bool:
    """Gate for the fresh-full-prompt fast path (the reference's gate; the
    config already refuses alibi, windows, post_norm and parallel
    residuals).  It does not look at the head dim, so scheduling is the
    same on every device: on the card a head dim the flash kernel does
    not take (it takes 32, 64 and 128) raises in the kernel's wrapper
    rather than moving the prompt to another path."""
    return cfg.pos_emb in ("rope", "learned")


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
    x = _embed(cfg, params, _dev(tokens.ravel(), dev), pos_t.reshape(-1))
    slots = _KVSlots(tables, positions, valid, bs, dev)

    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        q, k, v = _qkv(cfg, lp, x, (NS, S), pos_t)
        slots.write(arena, li, k.reshape(NS * S, *k.shape[2:]),
                    v.reshape(NS * S, *v.shape[2:]))
        attn = causal_attention(q, k, v, plain=cfg.attn_impl == "jnp")
        x = x + _dense(attn.reshape(NS * S, NH * D), lp["wo"], lp.get("bo"))
        x = x + _mlp_delta(cfg, x, lp)

    last = np.clip(lens - 1, 0, S - 1)
    xl = x.reshape(NS, S, H)[_dev(np.arange(NS), dev), _dev(last, dev)]
    return _lm_logits(cfg, params, xl), arena


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
    B = positions.shape[0]
    bs = arena["k"].shape[2]
    NH, D = cfg.num_heads, cfg.head_dim

    pos_t = _dev(positions, dev)
    x = _embed(cfg, params, tokens.to(dev).long(), pos_t)          # [B, H]
    slots = _KVSlots(tables, positions[:, None], active, bs, dev)
    tables_t = _dev(tables, dev, torch.int32)
    # the kernel's inactive-row marker: lens < 0 gives zeros
    lens_t = _dev(np.where(active, positions, -1), dev, torch.int32)
    attend = _kernels(cfg, arena)[0]
    rows = None if lora is None else LoraRows.of(adapter_ids)

    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        q, k, v = _qkv(cfg, lp, x, (B,), pos_t)
        slots.write(arena, li, k, v)
        attn = attend(q, arena["k"], arena["v"], tables_t, lens_t,
                      layer_idx=li)
        x = x + _attn_out(cfg, lp, li, attn.reshape(B, NH * D), lora, rows)
        x = x + _mlp_delta(cfg, x, lp)
    return _lm_logits(cfg, params, x), arena


def decode_step(cfg: TransformerConfig, params, arena, tokens, seq_lens,
                block_tables, active, adapter_ids=None, lora=None):
    """One generated token for up to B sequences: (logits [B, V] f32,
    arena).  Shapes as in `_decode_core`; inactive rows are inert."""
    return _decode_core(cfg, params, arena, tokens, seq_lens, block_tables,
                        active, adapter_ids=adapter_ids, lora=lora)


def _sample_tokens(logits, generator, mode: str, temperature, top_k):
    """Sampling on the logits' device.  mode: "greedy" | "sample" |
    "per_row" (temperature and top_k are then [B] tensors; rows with
    temperature <= 0 take the argmax).  Stochastic rows draw from
    `generator` — torch's stream, not jax.random's, so only the
    distribution matches the reference."""
    if mode == "greedy":
        return logits.argmax(dim=-1).to(torch.int32)
    from ..sampling import scale_topk, scale_topk_per_row
    if mode == "per_row":
        t = temperature.to(logits.device).float()
        probs = torch.softmax(scale_topk_per_row(
            logits, t, top_k.to(logits.device)), dim=-1)
        sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.where(t <= 0.0, logits.argmax(dim=-1),
                           sampled).to(torch.int32)
    if mode != "sample":
        raise ValueError(
            f"unknown sampling mode {mode!r} (greedy | sample | per_row)")
    probs = torch.softmax(scale_topk(logits, temperature, top_k), dim=-1)
    return torch.multinomial(probs, 1,
                             generator=generator)[:, 0].to(torch.int32)


def sample_tokens_compiled(logits, generator, temperature, top_k_vec=None,
                           *, mode: str = "greedy", top_k: int = 0):
    """The engine's batched first-token sampler (the reference compiles
    this chain; eager PyTorch runs it as is).  mode="per_row" reads
    `top_k_vec`; scalar modes use `top_k`."""
    return _sample_tokens(logits, generator, mode, temperature,
                          top_k_vec if mode == "per_row" else top_k)


def decode_tokens(cfg: TransformerConfig, params, arena, tokens, seq_lens,
                  block_tables, active, rng, temperature=1.0,
                  max_len=None, top_k_vec=None, adapter_ids=None, lora=None,
                  *, n_steps: int = 8, mode: str = "greedy", top_k: int = 0):
    """`n_steps` decode iterations with sampling on the device: sample ->
    append KV -> feed back; the sampled tokens stay on the device between
    steps and the host reads them once, at the end.  `max_len` [B]: each
    row's KV-lease bound — positions clamp to max_len-1 so an overshooting
    tail burst re-writes the last leased slot (the host trims its tokens).
    Positions advance on the host, since they do not depend on the
    samples.  adapter_ids [B] with `lora`: the gather-LoRA epilogue on
    every step (the rows' grouping is built once for the burst).
    Returns (tokens [B, n_steps] int32 on the device, arena)."""
    if lora is not None:
        adapter_ids = LoraRows(adapter_ids)

    def core(arena, toks, lens):
        return _decode_core(cfg, params, arena, toks, lens, block_tables,
                            active, adapter_ids=adapter_ids, lora=lora)
    return decode_loop(core, arena, tokens, seq_lens, rng, temperature,
                       max_len, top_k_vec, n_steps=n_steps, mode=mode,
                       top_k=top_k)


def decode_loop(core, arena, tokens, seq_lens, rng, temperature=1.0,
                max_len=None, top_k_vec=None, *, n_steps: int,
                mode: str = "greedy", top_k: int = 0):
    """The burst of `decode_tokens` over any one-step core: `core(arena,
    tokens, lens)` -> (logits [B, V] f32, arena).  Shared with the
    tensor-parallel programs."""
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
