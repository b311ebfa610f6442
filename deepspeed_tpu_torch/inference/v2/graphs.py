"""Decode groups replayed as captured CUDA graphs.

The reference compiles each decode burst (`ragged_ops.decode_tokens`) and
each step group (`ragged_ops.decode_multi_step`) into one program — `jit`
over a `lax.scan` — that the engine dispatches once a group.  On the card
the port's counterpart of that one dispatch is a CUDA graph: the eager
function is captured once for a key and then replayed, so a group of k
steps of L layers costs one launch from the host instead of the ~15 eager
ops a layer a step.

A program is captured for one key: the function and its static shape
(k, sampling mode and scalars, seeded or not, which operands are given),
LoRA on or off with its tile count, and the generator it draws from.  The
batch width and block-table width are the engine's and fixed.  Every
operand lives in a fixed device buffer that the host refills with `copy_`
before each replay; the arena (with its router census, where it has one),
the LoRA stacks and the expert weights (full stacks, or the expert
pool's slot stacks, slot map and resident mask) are read by address, and
the cache is emptied when those addresses (or shapes) change
(`attach_lora` with new stacks, a new arena, `enable_expert_paging`), so
the next call captures again.  The expert pool writes its tensors in
place, so a promote or demote between replays needs no capture: the next
replay routes by the new map and reads the new slot weights, and its
census adds to the arena's in place.  An expert layer's grouped GEMM
reads the group offsets on the device, so it replays as captured.  What a
capture relies on:

- no step reads the device from the host: the group is planned on the
  device (`ragged_ops._GroupSlots`), and a host read inside the capture
  raises — loudly, nothing falls back to eager;
- the generator a stochastic program draws from is registered with its
  graph, so each replay draws fresh numbers and advances it;
- one warm-up step runs on the capture stream first, so the kernels'
  scratch buffers (`ops._scratch`, keyed by the stream the graph replays
  on) and the libraries' handles exist before the capture: no fill node
  in the graph resets them at every replay; the program keeps the
  buffers its capture took, so one that a larger buffer replaces later
  lives as long as the graph;
- the wrappers' launch counters move while capturing, where no kernel
  launches: each program records how far each counter moved, takes it
  back, and adds it again at every replay;
- the model's per-layer windows are host ints, fixed in each launch at
  capture, and its ALiBi slopes one device tensor made before any
  capture and held here (`ragged_ops._slopes`); its rope frequency
  tables (`models.transformer.rope_tables`: longrope's two, between
  which each row's band is chosen on the device from its position at
  every step) are made by the eager steps and the warm-up before any
  capture and kept per device; the per-architecture switches (windows,
  positions, rope scaling, block kind) are in every program's key.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ...ops import _scratch
from ...ops.lora_matmul import LoraRows, lora_delta
from ...ops.moe_grouped import grouped_matmul
from ...ops.paged_attention import paged_decode_attention
from ...ops.paged_merged import merged_decode_attention
from .ragged_ops import (_slopes, decode_multi_step, decode_tokens,
                         write_rows)

__all__ = ["DecodeGraphs", "COUNTED"]

# the kernel wrappers a decode group can launch; their counters move per
# replay
COUNTED = (paged_decode_attention, merged_decode_attention, lora_delta,
           grouped_matmul)
# programs kept per engine (least recently used dropped first)
MAX_PROGRAMS = 16
# dtypes of the operand buffers, by name
_DTYPES = {"tokens": torch.int64, "seq_lens": torch.int64,
           "block_tables": torch.int32, "active": torch.bool,
           "temperature": torch.float32, "max_len": torch.int64,
           "top_k_vec": torch.int64, "eos_ids": torch.int64,
           "budget": torch.int64, "seed_hi": torch.int64,
           "seed_lo": torch.int64, "seed_pos": torch.int64,
           "has_seed": torch.bool, "rows": torch.int64,
           "lora_plan": torch.int32, "lora_ids": torch.int64}


def _counts():
    return {fn: (fn.launches, dict(fn.launches_by_variant))
            for fn in COUNTED}


def _set_counts(counts) -> None:
    for fn, (n, by) in counts.items():
        fn.launches = n
        fn.launches_by_variant.update(by)


class _Program:
    """One captured graph: its operand buffers, output and the launches
    one replay makes."""

    def __init__(self, graph, buffers, out, launches, generator, scratch):
        self.graph = graph
        self.buffers = buffers
        self.out = out
        self.launches = launches
        # held so that the registered generator and the kernels' scratch
        # buffers the graph reads outlive it
        self.generator = generator
        self.scratch = scratch

    def replay(self, host: Dict[str, np.ndarray]) -> torch.Tensor:
        for name, a in host.items():
            self.buffers[name].copy_(torch.from_numpy(a))
        self.graph.replay()
        for fn, (n, by) in self.launches.items():
            fn.launches += n
            for v, m in by.items():
                fn.launches_by_variant[v] += m
        return self.out


def _where(arena, lora, layers):
    """The addresses and shapes the captured programs read in place: the
    arena's tensors, the LoRA stacks and the expert leaves."""
    ts = [arena[n] for n in sorted(arena)]
    if lora is not None:
        ts += [lora["a"], lora["b"]]
    ts += [layers[n] for n in sorted(layers) if n.startswith("moe_")]
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in ts)


class DecodeGraphs:
    """The captured decode programs of one tensor-parallel-1 engine on a
    CUDA device: `decode_tokens` and `decode_multi_step` with the
    signatures of the ragged_ops functions (host data in), each call one
    replay on the current stream.  `captures` and `replays` count them."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self._programs: "OrderedDict[tuple, _Program]" = OrderedDict()
        self._where = None
        self._stream = None
        self._pool = None
        self.captures = 0
        self.replays = 0
        # the slopes every captured launch reads by address
        self.slopes = _slopes(cfg, self.device)
        self._arch = (cfg.pos_emb, cfg.alibi_scaled, cfg.sliding_window,
                      cfg.sliding_window_layers, cfg.post_norm,
                      cfg.parallel_residual, cfg.rope_pct, cfg.rope_scaling,
                      cfg.moe_experts, cfg.moe_top_k, cfg.moe_dense_layers)

    # -- the programs -----------------------------------------------------
    def decode_tokens(self, params, arena, tokens, seq_lens, block_tables,
                      active, rng, temperature=1.0, max_len=None,
                      top_k_vec=None, adapter_ids=None, lora=None,
                      seed_hi=None, seed_lo=None, seed_pos=None,
                      has_seed=None, *, n_steps: int = 8,
                      mode: str = "greedy", top_k: int = 0):
        """`ragged_ops.decode_tokens`, replayed: (tokens [B, n_steps]
        int32 on the device, arena).  The tokens are the program's output
        buffer: read them before the next call."""
        if seed_hi is not None and mode != "per_row":
            raise ValueError(
                "seeded burst decode needs mode='per_row' (per-row seed "
                "flags have no meaning for scalar sampling signatures)")
        host = dict(tokens=tokens, seq_lens=seq_lens,
                    block_tables=block_tables, active=active,
                    rows=write_rows(active))
        if max_len is not None:
            host["max_len"] = max_len
        if mode == "per_row":
            host.update(temperature=temperature, top_k_vec=top_k_vec)
            scalars = ()
        else:
            scalars = (float(temperature), int(top_k))
        if seed_hi is not None:
            host.update(seed_hi=seed_hi, seed_lo=seed_lo, seed_pos=seed_pos,
                        has_seed=has_seed)

        def body(b, steps, lrows):
            return decode_tokens(
                self.cfg, params, arena, b["tokens"], b["seq_lens"],
                b["block_tables"], b["active"], rng,
                b.get("temperature", temperature), b.get("max_len"),
                b.get("top_k_vec"), lrows, lora, b.get("seed_hi"),
                b.get("seed_lo"), b.get("seed_pos"), b.get("has_seed"),
                n_steps=steps, mode=mode, top_k=top_k, rows=b["rows"])[0]

        key = ("decode_tokens", n_steps, mode, scalars)
        out = self._run(key, n_steps, host, body, arena, lora, adapter_ids,
                        None if mode == "greedy" else rng, params)
        return out, arena

    def decode_multi_step(self, params, arena, tokens, seq_lens,
                          block_tables, active, rng, temperature, max_len,
                          top_k_vec, eos_ids, budget, seed_hi=None,
                          seed_lo=None, seed_pos=None, has_seed=None,
                          adapter_ids=None, lora=None, *, k: int = 8):
        """`ragged_ops.decode_multi_step`, replayed: (packed [B, k+1] int32
        on the device, arena); read it before the next call."""
        if k < 1:
            raise ValueError(f"decode_multi_step needs k >= 1, got {k}")
        host = dict(tokens=tokens, seq_lens=seq_lens,
                    block_tables=block_tables, active=active,
                    rows=write_rows(active), temperature=temperature,
                    max_len=max_len, top_k_vec=top_k_vec, eos_ids=eos_ids,
                    budget=budget)
        if seed_hi is not None:
            host.update(seed_hi=seed_hi, seed_lo=seed_lo, seed_pos=seed_pos,
                        has_seed=has_seed)

        def body(b, steps, lrows):
            return decode_multi_step(
                self.cfg, params, arena, b["tokens"], b["seq_lens"],
                b["block_tables"], b["active"], rng, b["temperature"],
                b["max_len"], b["top_k_vec"], b["eos_ids"], b["budget"],
                b.get("seed_hi"), b.get("seed_lo"), b.get("seed_pos"),
                b.get("has_seed"), lrows, lora, k=steps, rows=b["rows"])[0]

        out = self._run(("decode_multi_step", k), k, host, body, arena, lora,
                        adapter_ids, rng, params)
        return out, arena

    # -- capture and replay -----------------------------------------------
    def _run(self, key, steps, host, body, arena, lora, adapter_ids,
             generator: Optional[torch.Generator], params):
        """Refill the program of `key` (captured first where the cache has
        none) with the host operands and replay it; returns its output."""
        host = {n: np.ascontiguousarray(
            np.asarray(a if not isinstance(a, torch.Tensor)
                       else a.detach().cpu().numpy()),
            dtype=_np_dtype(n)) for n, a in host.items()}
        lrows = None
        if lora is not None:
            lrows = LoraRows.of(adapter_ids)
            if lrows.max_id >= lora["a"].shape[1]:
                raise ValueError(f"adapter slot {lrows.max_id} out of range "
                                 f"({lora['a'].shape[1]} slots)")
            plan, n_tiles, n_base = lrows.plan_host()
            host["lora_plan"] = plan
            host["lora_ids"] = lrows.ids.astype(np.int64)
            key += (("lora", n_tiles, n_base),)
        key += (tuple(sorted(host)), id(generator), self._arch)
        where = _where(arena, lora, params["layers"])
        if where != self._where:
            # the arena, the LoRA stacks or the expert leaves moved: every
            # graph read the old
            self._programs.clear()
            self._where = where
        prog = self._programs.get(key)
        if prog is None:
            prog = self._capture(host, steps, body, lrows, generator,
                                 arena.get("moe_census"))
            self._programs[key] = prog
            while len(self._programs) > MAX_PROGRAMS:
                self._programs.popitem(last=False)
        else:
            self._programs.move_to_end(key)
        self.replays += 1
        return prog.replay(host)

    def _capture(self, host, steps, body, lrows, generator,
                 census=None) -> _Program:
        """Warm up, capture and return the program of `body` for these
        operands (its first replay is the caller's).  The warm-up step's
        router counts are taken back out of `census` (the arena's rider,
        if any): only the replays are decode steps of the group."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        buffers = {n: torch.from_numpy(a).to(self.device, _DTYPES[n])
                   for n, a in host.items()}
        if lrows is not None:
            lrows.bind(buffers["lora_plan"], buffers["lora_ids"])
        cur = torch.cuda.current_stream(self.device)
        side = self._stream
        with _scratch.replaying_on(side.cuda_stream,
                                   cur.cuda_stream) as scratch:
            # one warm-up step on the capture stream: it writes what the
            # group's first step writes, from the same operands
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                before = None if census is None else census.clone()
                body(buffers, 1, lrows)
                if census is not None:
                    census.copy_(before)
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            warm = _counts()
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                out = body(buffers, steps, lrows)
            captured = _counts()
        # the capture launched nothing: keep the warm-up's launches only
        _set_counts(warm)
        launches = {}
        for fn, (n, by) in captured.items():
            n0, by0 = warm[fn]
            if n != n0:
                launches[fn] = (n - n0, {v: m - by0[v]
                                         for v, m in by.items()})
        self.captures += 1
        return _Program(graph, buffers, out, launches, generator,
                        list({id(b): b for b in scratch}.values()))


def _np_dtype(name: str):
    return {torch.int64: np.int64, torch.int32: np.int32,
            torch.bool: np.bool_, torch.float32: np.float32}[_DTYPES[name]]
