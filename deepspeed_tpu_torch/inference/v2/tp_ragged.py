"""Fused-collective tensor-parallel serving programs.

Counterpart of `deepspeed_tpu/inference/v2/tp_ragged.py`, the
``tp_collectives="fused"`` path.  Every rank of the tp group is one
process on one device holding its shard of the weights
(`models.shard_params_tp`) and its kv heads of the arena
([L, nb, bs, NKV/tp, D]); every rank runs the same serving call on the
same host metadata.  The residual stream stays ROW-SHARDED between blocks
(rank i holds rows [i*rows, (i+1)*rows) of the call's flat rows), and
every TP collective is a fused ring matmul from `ops/tp_matmul.py`:

- column-parallel stages (q/k/v, MLP up/gate, the decode lm head) take the
  row-sharded stream through the all-gather producer (`ag_matmul`);
- row-parallel stages (attention out, MLP down) return to it through the
  reduce-scatter consumer (`matmul_rs`, summed in f32, cast once).

Each hop's GEMM is `tile_matmul`, the hand-written kernel on the card.
Outside the blocks: one [rows, H] all-reduce at the vocab-sharded
embedding, one vocab all-gather of the logits, and at prefill one
all-gather of the stream before the (plain matmul) head of each chunk's
last row, as in the reference.  Attention runs per rank on its local
heads through the paged decode and prefill kernels (their plain versions
on the CPU, or under `attn_impl="jnp"`).

Where the reference runs the whole program inside one shard_map region,
here each rank is a process and a collective is a `torch.distributed`
call; the math and its rounding points are the reference's.

Layout invariants, refused loudly by `tp_fused_unsupported_reason` with
the reference's reasons: pre-norm sequential-residual archs only,
rope/learned positions, no sliding windows / MoE / embed projections /
fp8 weight dicts, the 5-D arena, and every dimension the stream or the
weights are sharded over divides by tp (max_seqs, prefill chunk, vocab,
ffn, and the attention heads).  A speculative verify span runs the
prefill's layers (`_chunk_rows`) over B*S rows, with the fused all-gather
head over all of them, and each rank accepts on the same full logits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...comm import comm
from ...models.transformer import _norm
from ...ops.tp_matmul import ag_matmul, matmul_rs, tile_matmul
from .ragged_ops import (_KVSlots, _dev, _host, _kernels, _layer,
                         _mlp_delta, _operand, _qkv, _refuse_fsm,
                         _span_plan, _spec_accept, decode_loop)

__all__ = ["TPServingPrograms", "tp_fused_unsupported_reason", "tp_unported"]


def _leaf_paths(params, prefix=""):
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + ".")
        else:
            yield path


def tp_unported(cfg, params) -> bool:
    """Whether `cfg` has a block feature that the fused programs do not
    carry (the first refusals of `tp_fused_unsupported_reason`): post-norm
    or parallel-residual blocks, ALiBi, windows, embedding projections."""
    return bool(cfg.post_norm or cfg.parallel_residual
                or cfg.pos_emb not in ("rope", "learned")
                or cfg.sliding_window is not None
                or cfg.sliding_window_layers is not None
                or "embed_in_proj" in params or "embed_out_proj" in params)


def tp_fused_unsupported_reason(cfg, config, params, arena) -> Optional[str]:
    """None when the fused-TP programs can serve this (cfg, config,
    params, arena); otherwise the reason the engine raises with (the
    reference's words, plus the head counts the reference's engine
    checks before it)."""
    tp = config.tensor_parallel_size
    if cfg.post_norm or cfg.parallel_residual:
        return ("post-norm / parallel-residual blocks are not wired "
                "through the fused-TP forward")
    if cfg.moe_experts > 1 or getattr(cfg, "moe_dense_layers",
                                      None) is not None:
        return "MoE layers are not wired through the fused-TP forward"
    if cfg.pos_emb not in ("rope", "learned"):
        return (f"pos_emb={cfg.pos_emb!r} is not wired through the "
                f"fused-TP forward (alibi slopes are global-head-indexed)")
    if cfg.sliding_window is not None or cfg.sliding_window_layers is not None:
        return "sliding windows are not wired through the fused-TP forward"
    if "embed_in_proj" in params or "embed_out_proj" in params:
        return ("OPT-style embed in/out projections are not wired "
                "through the fused-TP forward")
    if any("q_codes" in p or "q_scales" in p or "q_col_scales" in p
           for p in _leaf_paths(params)):
        return ("fp8 serving-weight dicts are not TP-sharded (their "
                "leaves carry no _TP_RULES spec), so the fused path "
                "would stream full-size codes")
    if arena["k"].ndim == 4:
        return ("the merged [L, nb, bs, NKV*D] arena layout cannot "
                "shard contiguous kv-head groups for the per-shard "
                "kernels (use arena_merged=False)")
    if cfg.num_heads % tp or cfg.kv_heads % tp:
        return (f"num_heads={cfg.num_heads} and kv_heads={cfg.kv_heads} "
                f"must divide by tp={tp} (attention runs on local heads)")
    if config.max_seqs % tp:
        return (f"max_seqs={config.max_seqs} must divide by tp={tp} "
                f"(the decode batch rows are the sharded stream)")
    if config.prefill_chunk_size % tp:
        return (f"prefill_chunk_size={config.prefill_chunk_size} must "
                f"divide by tp={tp}")
    if cfg.vocab_size % tp:
        return (f"vocab_size={cfg.vocab_size} must divide by tp={tp} "
                f"(vocab-sharded embedding / lm head)")
    ffn = params["layers"]["w_up"].shape[-1]
    if ffn % tp:
        return f"ffn width {ffn} must divide by tp={tp}"
    return None


class TPServingPrograms:
    """One rank's serving programs for fused-TP serving.  Signatures are
    the `ragged_ops` programs' minus `cfg` (bound here, with the
    topology), so the engine's call sites do not branch.  `params` is this
    rank's shard; the arena holds its local kv heads and is updated in
    place, as in `ragged_ops`."""

    def __init__(self, cfg, topology, params):
        self.cfg = cfg
        self.tp = topology.tp_size
        self.rank = topology.tp_rank
        self.group = topology.tp_group
        # plain_kernels engines (attn_impl="jnp") take the plain GEMM too
        self._mm_impl = "plain" if cfg.attn_impl == "jnp" else "auto"
        # the lm head's local vocab columns [E, V/tp], contiguous once (a
        # tied head is the local embedding chunk's transpose)
        head = params.get("lm_head")
        self._head = (params["tok_embed"].t() if head is None
                      else head).contiguous()

    # -- fused matmul halves ---------------------------------------------
    def _col(self, h_local, w, b):
        """Column-parallel stage on the row-sharded stream: fused
        all-gather matmul, h_local [rows, K] -> [tp*rows, N_local]."""
        dt = self.cfg.dtype
        mat = w.to(dt)
        out = ag_matmul(h_local, self.group, self.tp,
                        lambda c: tile_matmul(c, mat,
                                              impl=self._mm_impl).to(dt))
        if b is not None:
            out = out + b.to(dt)
        return out

    def _rowp(self, y_full, w, b):
        """Row-parallel stage back onto the row-sharded stream: fused
        matmul-reduce-scatter (f32 ring sums, ONE cast + bias after),
        y_full [S, K_local] -> [S/tp, N]."""
        dt = self.cfg.dtype
        mat = w.to(dt)
        out = matmul_rs(y_full, self.group, self.tp,
                        lambda c: tile_matmul(c, mat, impl=self._mm_impl)
                        ).to(dt)
        if b is not None:
            out = out + b.to(dt)
        return out

    # -- shared local pieces ---------------------------------------------
    def _rows(self, n: int) -> slice:
        rows = n // self.tp
        return slice(self.rank * rows, (self.rank + 1) * rows)

    def _embed_rows(self, params, tokens_flat, positions_flat):
        """Row-sharded embedding from the vocab-sharded table: every rank
        looks the FULL token vector up in its vocabulary chunk (rows
        outside it zero), one all-reduce assembles the embeddings (a
        token's row lives on exactly one rank, so the sum is exact), then
        this rank keeps its row chunk of the stream."""
        cfg = self.cfg
        emb = params["tok_embed"]                     # [V/tp, H] local
        vl = emb.shape[0]
        loc = tokens_flat.long() - self.rank * vl
        ok = (loc >= 0) & (loc < vl)
        x = emb[loc.clamp(0, vl - 1)].to(cfg.dtype)
        x = torch.where(ok[:, None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
        comm.all_reduce(x, self.group)                # [B_total, H] full
        mine = self._rows(x.shape[0])
        x = x[mine]
        if cfg.pos_emb == "learned":
            pos = positions_flat[mine].clamp(0, cfg.max_seq_len - 1)
            x = x + params["pos_embed"][pos].to(cfg.dtype)
        if cfg.embed_norm:
            x = _norm(x, params["embed_norm_scale"],
                      params["embed_norm_bias"], "layernorm", cfg.norm_eps)
        return x                                      # [rows, H]

    def _final_norm(self, params, x):
        cfg = self.cfg
        if cfg.final_norm:
            x = _norm(x, params["final_norm_scale"],
                      params.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
        return x

    def _logits_repl(self, params, xl):
        """Full-vocab logits of a REPLICATED row set `xl` [N, H]: the
        local vocab columns as an f32 product (a plain matmul, as the
        reference's einsum outside any kernel), then one vocab
        all-gather."""
        xl = self._final_norm(params, xl)
        lg = xl.float() @ self._head.float()
        if "lm_head_bias" in params:
            lg = lg + params["lm_head_bias"].float()   # local [V/tp] chunk
        return comm.all_gather(lg, self.group, dim=1)

    def _logits_rows(self, params, x_local):
        """Full-vocab logits of EVERY row of the row-sharded stream: the
        fused all-gather head matmul (tile kernel), then one vocab
        all-gather."""
        x_local = self._final_norm(params, x_local)
        head = self._head.to(x_local.dtype)
        lg = ag_matmul(x_local, self.group, self.tp,
                       lambda c: tile_matmul(c, head, impl=self._mm_impl))
        if "lm_head_bias" in params:
            lg = lg + params["lm_head_bias"].float()
        return comm.all_gather(lg, self.group, dim=1)  # [S, V] f32

    def _mlp_rows(self, x_local, lp):
        """norm -> MLP on the row-sharded stream, returning the
        row-sharded delta."""
        return _mlp_delta(self.cfg, x_local, lp, col=self._col,
                          row=self._rowp)

    # -- decode ------------------------------------------------------------
    def _decode_rows(self, params, arena, tokens, seq_lens, block_tables,
                     active):
        """One token for each of B rows (every rank the same host data):
        (logits [B, V] f32, arena)."""
        cfg = self.cfg
        dev = arena["k"].device
        if not isinstance(tokens, torch.Tensor):
            tokens = _dev(_host(tokens), dev)
        active = _host(active).astype(bool)
        positions = _host(seq_lens).astype(np.int64)
        tables = _host(block_tables).astype(np.int32)
        B = positions.shape[0]
        bs = arena["k"].shape[2]
        pos_t = _dev(positions, dev)
        x = self._embed_rows(params, tokens.to(dev), pos_t)       # [B/tp, H]
        slots = _KVSlots(tables, positions[:, None], active, bs, dev)
        tables_t = _dev(tables, dev, torch.int32)
        lens_t = _dev(np.where(active, positions, -1), dev, torch.int32)
        attend = _kernels(cfg, arena)[0]
        for li in range(cfg.num_layers):
            lp = _layer(params, li)
            q, k, v = _qkv(cfg, lp, x, (B,), pos_t, proj=self._col)
            slots.write(arena, li, k, v)
            attn = attend(q, arena["k"], arena["v"], tables_t, lens_t,
                          layer_idx=li)
            x = x + self._rowp(attn.reshape(B, -1), lp["wo"], lp.get("bo"))
            x = x + self._mlp_rows(x, lp)
        return self._logits_rows(params, x), arena

    def decode_step(self, params, arena, tokens, seq_lens, block_tables,
                    active):
        """`ragged_ops.decode_step` on this rank's shard."""
        return self._decode_rows(params, arena, tokens, seq_lens,
                                 block_tables, active)

    def decode_tokens(self, params, arena, tokens, seq_lens, block_tables,
                      active, rng, temperature=1.0, max_len=None,
                      top_k_vec=None, *, n_steps: int = 8,
                      mode: str = "greedy", top_k: int = 0):
        """`ragged_ops.decode_tokens`: every rank samples the same full
        logits with its own identically seeded generator, so the ranks
        agree on every token."""
        def core(arena, toks, lens):
            return self._decode_rows(params, arena, toks, lens,
                                     block_tables, active)
        if mode == "per_row":
            dev = arena["k"].device
            temperature = _operand(temperature, dev, torch.float32)
            top_k_vec = _operand(top_k_vec, dev, torch.int64)
        return decode_loop(core, arena, tokens, seq_lens, rng, temperature,
                           max_len, top_k_vec, n_steps=n_steps, mode=mode,
                           top_k=top_k)

    # -- chunks: prefill and the verify span ------------------------------
    def _chunk_rows(self, params, arena, tokens, positions, valid, pos0s,
                    n_valids, tables, live, regime=None):
        """`ragged_ops._chunk_layers` on this rank's shard: the layers
        over NC chunks of C rows (host plan as there), each chunk's
        attention one paged prefill launch a layer on the local heads.
        Returns this rank's rows of the stream, [NC*C/tp, H]."""
        cfg = self.cfg
        dev = arena["k"].device
        NC, C = tokens.shape
        bs = arena["k"].shape[2]
        pos_t = _dev(positions, dev)
        x = self._embed_rows(params, _dev(tokens.ravel(), dev),
                             pos_t.reshape(-1))                # [NC*C/tp, H]
        slots = _KVSlots(tables, positions, valid, bs, dev)
        tables_t = _dev(tables, dev, torch.int32)
        attend = _kernels(cfg, arena)[1]
        for li in range(cfg.num_layers):
            lp = _layer(params, li)
            q, k, v = _qkv(cfg, lp, x, (NC, C), pos_t, proj=self._col,
                           regime_len=regime)
            slots.write(arena, li, k.reshape(NC * C, *k.shape[2:]),
                        v.reshape(NC * C, *v.shape[2:]))
            attn = torch.zeros_like(q)
            for i in live:
                attn[i] = attend(q[i], arena["k"], arena["v"], tables_t[i],
                                 int(pos0s[i]), int(n_valids[i]),
                                 sliding_window=cfg.sliding_window,
                                 layer_idx=li)
            x = x + self._rowp(attn.reshape(NC * C, -1), lp["wo"],
                               lp.get("bo"))
            x = x + self._mlp_rows(x, lp)
        return x

    def prefill_chunks(self, params, arena, tokens, pos0s, n_valids,
                       block_tables, active, total_lens=None):
        """`ragged_ops.prefill_chunks` on this rank's shard: (logits [NC,
        V] f32 at each chunk's last valid token, arena); `total_lens`
        as there (longrope's band)."""
        dev = arena["k"].device
        tokens = _host(tokens)
        active = _host(active).astype(bool)
        pos0s = np.where(active, _host(pos0s), 0).astype(np.int64)
        n_valids = np.where(active, _host(n_valids), 0).astype(np.int64)
        tables = _host(block_tables).astype(np.int32)
        NC, C = tokens.shape
        H = self.cfg.hidden_size

        positions = pos0s[:, None] + np.arange(C)[None]            # [NC, C]
        valid = (np.arange(C)[None] < n_valids[:, None]) & active[:, None]
        regime = (None if total_lens is None
                  else _dev(_host(total_lens).astype(np.int64), dev))
        live = [i for i in range(NC) if active[i] and n_valids[i] > 0]
        x = self._chunk_rows(params, arena, tokens, positions, valid, pos0s,
                             n_valids, tables, live, regime)
        # each chunk's last valid row: gather the stream's rows once
        x_full = comm.all_gather(x, self.group)                  # [NC*C, H]
        last = np.clip(n_valids - 1, 0, C - 1)
        xl = x_full.reshape(NC, C, H)[_dev(np.arange(NC), dev),
                                      _dev(last, dev)]
        return self._logits_repl(params, xl), arena

    def verify_tokens(self, params, arena, tokens, seq_lens, n_valids,
                      block_tables, active, generator, temperature=0.0,
                      max_len=None, top_k_vec=None, fsm_mask=None,
                      fsm_accept=None, span_states=None, has_fsm=None,
                      fsm_eos=None, *, mode: str = "greedy"):
        """`ragged_ops.verify_tokens` on this rank's shard: the span's
        rows through `_chunk_rows` (the tile GEMM hops, each row's
        attention one paged prefill launch a layer on the local heads),
        the full logits of every span row by the fused all-gather head,
        then `_spec_accept` on them — every rank holds the same logits and
        an identically seeded generator, so the ranks take the same
        decisions."""
        _refuse_fsm(fsm_mask, fsm_accept, span_states, has_fsm, fsm_eos)
        tokens, pos0s, n_valids, positions, valid, live = _span_plan(
            tokens, seq_lens, n_valids, active, max_len)
        B, S = tokens.shape
        x = self._chunk_rows(params, arena, tokens, positions, valid, pos0s,
                             n_valids, _host(block_tables).astype(np.int32),
                             live)
        logits = self._logits_rows(params, x).reshape(B, S, -1)
        emitted, n_emitted = _spec_accept(logits, tokens, n_valids,
                                          generator, mode, temperature,
                                          top_k_vec)
        return emitted, n_emitted, arena
