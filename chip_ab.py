#!/usr/bin/env python3
"""Compare two copies of `deepspeed_tpu_torch` on one NVIDIA card.

    python3 chip_ab.py DIR_A DIR_B [--rounds N]
                       [--what train|paged|paged_plans|sparse|evoformer|
                               evoformer_plans|tile|flash|lora]
                       [--train-layers N]

Each DIR holds a `deepspeed_tpu_torch` package (for example one unpacked
with `git archive` from another commit).  The copies run in turns, A, B,
B, A per round, each in a process of its own that builds its own kernels
(into DIR/build) and measures, with chip_smoke.py's phases:

- `--what train` (the default): the flash backward's device time at the
  training shape (chip_smoke's TRAIN_ATTN, bf16, causal; its
  `time_flash_bwd`: dq and dk/dv, and the delta kernel where the package
  has one, 0 where dq and dk/dv compute delta inside; `bwd_ms` is their
  sum), and bench.py's GPT-2-1.3B training step (chip_smoke phase 5: 3
  warm-up and 10 timed steps, the first warm-up loss) with its device
  time by kind (phase 7);
- `--what paged`: the paged prefill and paged decode kernels' device time
  at chip_smoke phase 1's main shapes (its `paged_main_inputs`), through
  the 5-D and the merged wrappers, prefill at phase 13's local heads at
  tp 4, and the host time of one call of each, on the kernels each
  package routes to; `--what paged_plans` (a package with the TMA
  kernels, given as both DIRs for the spread) times prefill under every
  split choice of its plan and decode with 32- and 256-block tables;
- `--what sparse`: the block-sparse forward, delta, dq and dk/dv
  kernels' device time at chip_smoke phase 1's main shape (SPARSE_SHAPE
  bf16, phase 10's first layout; delta 0 where a package has no delta
  kernel), the host time of phase 10's module forward per layout, the
  backward (CUDA events, on the pair each package routes to) and the
  forward (CUDA graphs: device time without host gaps, on the kernel
  each package routes to) at phase 10's three layouts and its pair-gate
  sweep (`sweep_layouts`);
- `--what lora`: the gather-LoRA delta's device time at chip_smoke phase
  1's wave shapes (32, 512 and 2048 bf16 rows, K = N = 4096, rank 16, 4
  slots, its `_lora_ids`) on the kernel each package routes to, and the
  host time of one 32-row call;
- `--what evoformer`: the Evoformer forward, dq, dk/dv (with db1 where
  the mask bias requires grad) and db2 kernels' device time, and the
  backward's sum, at phase 12's MSA row, triangle and extra-MSA row shapes
  (chip_smoke's `EVO_SHAPES` and `evo_inputs`), on the kernels each
  package routes to (`<shape>_routes`: the forward's and db2's variants);
  `--what evoformer_plans` (a package with the plans, given as both DIRs
  for the spread) times the forward under rows 1-8 a CTA and db2 under
  1-16 splits at those shapes (CUDA graphs), beside the first kernels,
  and the new forward and db2 kernels against the first ones at phase
  1's other bf16 cases (`evo_cases`) and at longer rows (`EVO_LONG`: L
  384-1024, the forward's strip in shared memory up to its limit);
- `--what tile`: the tile GEMM's device time at phase 13's decode hops
  (warm, and with the L2 flushed before each call: chip_smoke's
  `cold_time_ms`) and NC=2 prefill hops (chip_smoke's `tile_hop_shapes`),
  bf16, and the host time of one decode-hop call (`host_us`);
- `--what flash`: the flash forward's device time at the serving shape
  [4, 512, 32, 128] and the training shape (TRAIN_ATTN), bf16, causal,
  and the host time of one call at [1, 128, 8, 128].

One JSON line per run, then a summary; two versions compare only within
one call, on one card.  Exits non-zero without a card.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def paged_worker(cs, np, torch):
    """Device ms of the paged prefill and decode kernels, through the 5-D
    and the merged wrappers, at phase 1's main shapes, and of prefill at
    phase 13's local heads at tp 4 (NH 8); the host time of one call
    where the card keeps up (a 16-query chunk at pos0 0, a decode step
    of 8 rows at 16 keys)."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_merged as pm
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    dec, pre = cs.paged_main_inputs(torch, np, "cuda")
    merged = [(t[0], *(a.view(*a.shape[:3], -1) for a in t[1:3]), *t[3:])
              for t in (dec, pre)]
    _, pre8 = cs.paged_main_inputs(torch, np, "cuda", NH=8, NKV=8)
    res = {"prefill_ms": cs.time_ms(
               lambda: pp.paged_prefill_attention(*pre, layer_idx=1)),
           "decode_ms": cs.time_ms(
               lambda: pa.paged_decode_attention(*dec, layer_idx=1)),
           "merged_prefill_ms": cs.time_ms(
               lambda: pm.merged_prefill_attention(*merged[1], layer_idx=1)),
           "merged_decode_ms": cs.time_ms(
               lambda: pm.merged_decode_attention(*merged[0], layer_idx=1)),
           "prefill_nh8_ms": cs.time_ms(
               lambda: pp.paged_prefill_attention(*pre8, layer_idx=1))}
    q, ak, av, tables, lens = dec
    short = torch.full_like(lens, 15)
    res["decode_host_us"] = cs.host_us(
        torch, lambda: pa.paged_decode_attention(q, ak, av, tables, short,
                                                 layer_idx=1))
    qc, _, _, table = pre[:4]
    res["prefill_host_us"] = cs.host_us(
        torch, lambda: pp.paged_prefill_attention(qc[:16], ak, av, table, 0,
                                                  16, layer_idx=1))
    return res


def paged_plans_worker(cs, np, torch):
    """Device ms of the paged TMA kernels at phase 1's main shapes: prefill
    under each split choice its plan could make (1-8 splits a query
    tile), decode with the main shape's 32-block tables and with the
    serving engine's 256-block ones (the same live blocks, garbage after
    them).  A package without the prefill plan times its own kernels."""
    import dataclasses
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    dec, pre = cs.paged_main_inputs(torch, np, "cuda")
    q, ak, av, tables, lens = dec
    rng = np.random.RandomState(6)
    wide = torch.from_numpy(rng.randint(
        -5, 261, (q.shape[0], 256)).astype(np.int32)).to("cuda")
    wide[:, :tables.shape[1]] = tables
    res = {"decode_ms": cs.time_ms(
               lambda: pa.paged_decode_attention(*dec, layer_idx=1)),
           "decode_mb256_ms": cs.time_ms(
               lambda: pa.paged_decode_attention(q, ak, av, wide, lens,
                                                 layer_idx=1))}
    if not hasattr(pp, "prefill_plan"):
        res["prefill_ms"] = cs.time_ms(
            lambda: pp.paged_prefill_attention(*pre, layer_idx=1))
        return res
    real = pp.prefill_plan
    try:
        for splits in (1, 2, 3, 4, 6, 8):
            pp.prefill_plan = (lambda *a, n=splits, **k: dataclasses.replace(
                real(*a, **k), splits=n))
            res[f"prefill_splits{splits}_ms"] = cs.time_ms(
                lambda: pp.paged_prefill_attention(*pre, layer_idx=1))
    finally:
        pp.prefill_plan = real
    return res


def lora_worker(cs, np, torch):
    """Device ms of the LoRA delta at phase 1's three wave shapes, on the
    kernel each package routes to; host us of one 32-row call."""
    from deepspeed_tpu_torch.ops import lora_matmul as lm
    rng = np.random.RandomState(5)
    g = torch.Generator(device="cuda").manual_seed(5)
    K = N = 4096
    r = 16
    a = torch.randn(4, K, r, generator=g, device="cuda") / K ** 0.5
    b = torch.randn(4, r, N, generator=g, device="cuda") / r ** 0.5
    res = {}
    for S in (32, 512, 2048):
        x = torch.randn(S, K, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        rows = lm.LoraRows(cs._lora_ids(np, rng, S, 4))
        res[f"rows{S}_ms"] = cs.time_ms(lambda: lm.lora_delta(x, a, b, rows))
        if S == 32:
            res["rows32_host_us"] = cs.host_us(
                torch, lambda: lm.lora_delta(x, a, b, rows))
    return res


def _fwd_kw(sf, kw):
    """The forward's keywords: the plan, where the package's forward
    takes one."""
    import inspect
    takes = "plan" in inspect.signature(
        sf.block_sparse_flash_attention).parameters
    return {"plan": kw["plan"]} if takes and "plan" in kw else {}


def _sparse_tables(sa, kidx, block):
    """(idx, rev, backward keywords) of a package's device tables: a
    package with the backward plan takes it, an older one has none."""
    try:
        tables = sa._device_tables(kidx, "cuda", block)
    except TypeError:   # a package from before the plan
        tables = sa._device_tables(kidx, "cuda")
    kw = {"plan": tables[2]} if len(tables) > 2 else {}
    return tables[0], tables[1], kw


def sparse_worker(cs, np, torch):
    """Device ms of the block-sparse kernels at phase 1's main shape (the
    delta kernel 0 where the package has none), the backward at phase
    10's layouts and at its pair-gate sweep (CUDA events, the pair each
    package routes to)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import sparse_flash as sf
    B, S, H, D = cs.SPARSE_SHAPE
    _, cfg = cs.sparse_layouts(sa, H)[0]
    block = cfg.block
    idx, rev, kw = _sparse_tables(
        sa, sa._layout_to_gather(cfg.make_layout(S)), block)
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    fk = _fwd_kw(sf, kw)
    out, lse = sf.block_sparse_flash_attention(q, k, v, idx, block, False,
                                               return_lse=True, **fk)
    res = {"fwd_ms": cs.time_ms(lambda: sf.block_sparse_flash_attention(
        q, k, v, idx, block, False, return_lse=True, **fk)), "delta_ms": 0.0}
    if hasattr(sf, "block_sparse_flash_bwd_delta") and sf.bwd_variant(
            q.dtype, D, block) == "wgmma":
        kw["delta"] = sf.block_sparse_flash_bwd_delta(out, do)
        res["delta_ms"] = cs.time_ms(
            lambda: sf.block_sparse_flash_bwd_delta(out, do))
    res["dq_ms"] = cs.time_ms(lambda: sf.block_sparse_flash_dq(
        q, k, v, idx, out, do, lse, block, False, **kw))
    res["dkv_ms"] = cs.time_ms(lambda: sf.block_sparse_flash_dkv(
        q, k, v, idx, rev, out, do, lse, block, False, **kw))
    res["bwd_sum_ms"] = res["delta_ms"] + res["dq_ms"] + res["dkv_ms"]
    del out, lse
    for name, cfg_ in cs.sparse_layouts(sa, H):
        # phase 10's host side of one call: the module's forward, tables
        # and plan cached; the least of five readings (the host's own
        # noise spreads single readings by some 2x)
        attn = sa.SparseSelfAttention(cfg_)
        with torch.no_grad():
            res[f"{name}_fwd_host_us"] = min(
                cs.host_us(torch, lambda: attn(q, k, v), iters=30)
                for _ in range(5))
    layouts = [(n, c.make_layout(S), c.block,
                sa.SparseSelfAttention(c).causal)
               for n, c in cs.sparse_layouts(sa, H)]
    for name, layout, bl, causal in layouts + cs.sweep_layouts(np, sa, H, S):
        idx, rev, kw = _sparse_tables(sa, sa._layout_to_gather(layout), bl)
        fk = _fwd_kw(sf, kw)
        out, lse = sf.block_sparse_flash_attention(q, k, v, idx, bl, causal,
                                                   return_lse=True, **fk)
        res[f"{name}_fwd_ms"] = cs.graph_time_ms(
            lambda: sf.block_sparse_flash_attention(
                q, k, v, idx, bl, causal, return_lse=True, **fk))
        res[f"{name}_bwd_ms"] = cs.event_time_ms(
            lambda: sf.block_sparse_flash_backward(
                q, k, v, idx, rev, out, do, lse, bl, causal, **kw))
        del out, lse
    return res


def evoformer_worker(cs, np, torch):
    """Device ms of the Evoformer kernels at phase 12's three shapes (the
    dk/dv kernel with db1 where the shape's mask bias requires grad), and
    the backward's sum."""
    from deepspeed_tpu_torch.ops import evoformer_flash as ef
    res = {}
    for name, shape, b1_grad in cs.EVO_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(12)
        q, k, v, b1, b2 = cs.evo_inputs(torch, g, "cuda", *shape,
                                        torch.bfloat16)
        do = torch.randn(q.shape, generator=g, device="cuda", dtype=q.dtype)
        out, lse = ef.evoformer_flash_forward(q, k, v, b1, b2,
                                              return_lse=True)
        _, delta = ef.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
        ms = {"fwd": cs.time_ms(lambda: ef.evoformer_flash_forward(
                  q, k, v, b1, b2, return_lse=True)),
              "dq": cs.time_ms(lambda: ef.evoformer_flash_dq(
                  q, k, v, b1, b2, out, do, lse)),
              "dkv": cs.time_ms(lambda: ef.evoformer_flash_dkv(
                  q, k, v, b1, b2, do, lse, delta, need_db1=b1_grad)),
              "db2": cs.time_ms(lambda: ef.evoformer_flash_db2(
                  q, k, v, b1, b2, do, lse, delta))}
        ms["bwd"] = ms["dq"] + ms["dkv"] + ms["db2"]
        res.update({f"{name}_{k_}_ms": float(t) for k_, t in ms.items()})
        # the kernels this package routes the forward and db2 to (a
        # package without the rules ran its only kernels)
        B, N, L, H, D = shape
        res[f"{name}_routes"] = (
            f"{ef.fwd_variant(q.dtype, D, L, b2.dtype)}/"
            f"{ef.db2_variant(q.dtype, D, L, N)}"
            if hasattr(ef, "db2_variant") else "mma/mma")
        del q, k, v, b1, b2, do, out, lse, delta
        torch.cuda.empty_cache()
    return res


# AlphaFold 2's fine-tuning crop (L 384) and longer rows, at the MSA row's
# (H 8, D 32) and extra-MSA row's (H 8, D 8) widths and at D 64 and 128,
# N cut to 32 (64 at D 8): (N, L, H, D, pair-bias dtype)
EVO_LONG = [(32, L, 8, 32, "bf16") for L in (384, 512, 768, 1024)] + [
    (64, L, 8, 8, "bf16") for L in (384, 512, 768, 1024)] + [
    (32, 384, 8, 64, "bf16"), (32, 768, 8, 64, "bf16"),
    (32, 384, 8, 128, "bf16"), (32, 768, 8, 128, "bf16"),
    (32, 384, 8, 32, "f32"), (32, 384, 8, 128, "f32")]


def evoformer_plans_worker(cs, np, torch):
    """Device ms (CUDA graphs) of the Evoformer forward under rows 1-8 a
    CTA and of db2 under 1-16 splits at phase 12's shapes, on the new
    kernels the package routes the shape to (its plans' choices are
    `<shape>_fwd_plan_rows` / `_db2_plan_splits`; the others are run by
    replacing `fwd_plan` / `db2_plan` for the call), beside the first
    kernels (`variant="mma"`); the new forward and db2 kernels (named by
    D) against the first ones at phase 1's other bf16 cases (`evo_cases`)
    and at the long rows of EVO_LONG (`long_<N>x<L>x<H>x<D>_<b2>_*`, with
    the variants the rules name and the plans' rows and splits)."""
    from deepspeed_tpu_torch.ops import _scratch
    from deepspeed_tpu_torch.ops import evoformer_flash as ef
    sms = _scratch.sm_count(torch.device("cuda"))
    res = {}

    def planned(name, value, call):
        """`call`'s device ms with the plan `name` giving `value`."""
        kept = getattr(ef, name)
        setattr(ef, name, lambda *args: value)
        try:
            return cs.graph_time_ms(call)
        finally:
            setattr(ef, name, kept)

    for name, shape, _ in cs.EVO_SHAPES:
        B, N, L, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(12)
        q, k, v, b1, b2 = cs.evo_inputs(torch, g, "cuda", *shape,
                                        torch.bfloat16)
        do = torch.randn(q.shape, generator=g, device="cuda", dtype=q.dtype)
        out, lse = ef.evoformer_flash_forward(q, k, v, b1, b2,
                                              return_lse=True)
        _, delta = ef.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
        res[f"{name}_fwd_plan_rows"] = ef.fwd_plan(B, N, L, H, D, b2.dtype,
                                                   sms)
        res[f"{name}_db2_plan_splits"] = ef.db2_plan(B, N, L, H, D,
                                                     b2.dtype, sms)
        res[f"{name}_fwd_first_ms"] = cs.graph_time_ms(
            lambda: ef.evoformer_flash_forward(q, k, v, b1, b2,
                                               return_lse=True,
                                               variant="mma"))
        res[f"{name}_db2_first_ms"] = cs.graph_time_ms(
            lambda: ef.evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta,
                                           variant="mma"))
        for rows in (1, 2, 3, 4, 6, 8):
            res[f"{name}_fwd_rows{rows}_ms"] = planned(
                "fwd_plan", rows, lambda: ef.evoformer_flash_forward(
                    q, k, v, b1, b2, return_lse=True))
        for splits in (1, 2, 3, 4, 6, 8, 16):
            res[f"{name}_db2_splits{splits}_ms"] = planned(
                "db2_plan", splits, lambda: ef.evoformer_flash_db2(
                    q, k, v, b1, b2, do, lse, delta))
        del q, k, v, b1, b2, do, out, lse, delta
        torch.cuda.empty_cache()
    cases = [(f"case_{B}x{N}x{L}x{H}x{D}", B, N, L, H, D, torch.bfloat16)
             for B, N, L, H, D, dt, _, _ in cs.evo_cases(torch)[1:]
             if dt == torch.bfloat16]
    cases += [(f"long_{N}x{L}x{H}x{D}_{b2t}", 1, N, L, H, D,
               torch.bfloat16 if b2t == "bf16" else torch.float32)
              for N, L, H, D, b2t in EVO_LONG]
    # the new forward and db2 kernels (named) beside the first
    for name, B, N, L, H, D, b2_dtype in cases:
        g = torch.Generator(device="cuda").manual_seed(12)
        q, k, v, b1, b2 = cs.evo_inputs(torch, g, "cuda", B, N, L, H, D,
                                        torch.bfloat16)
        b2 = b2.to(b2_dtype)
        do = torch.randn(q.shape, generator=g, device="cuda", dtype=q.dtype)
        out, lse = ef.evoformer_flash_forward(q, k, v, b1, b2,
                                              return_lse=True)
        _, delta = ef.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
        # the new kernels by D, named (the rule may route elsewhere)
        wg = D in ef.WGMMA_HEAD_DIMS
        fv, dv = ("wgmma", "wgmma") if wg else ("rows", "split")
        res[f"{name}_fwd_routed"] = ef.fwd_variant(q.dtype, D, L, b2_dtype)
        res[f"{name}_db2_routed"] = ef.db2_variant(q.dtype, D, L, N)
        res[f"{name}_fwd_plan_rows"] = ef.fwd_plan(B, N, L, H, D, b2_dtype,
                                                   sms)
        res[f"{name}_db2_plan_splits"] = ef.db2_plan(B, N, L, H, D,
                                                     b2_dtype, sms)
        for kernel, vr in (("fwd", fv), ("fwd", "mma"), ("db2", dv),
                           ("db2", "mma")):
            call = (lambda vr=vr: ef.evoformer_flash_forward(
                        q, k, v, b1, b2, return_lse=True, variant=vr)) \
                if kernel == "fwd" else \
                (lambda vr=vr: ef.evoformer_flash_db2(
                    q, k, v, b1, b2, do, lse, delta, variant=vr))
            res[f"{name}_{kernel}_{vr}_ms"] = cs.graph_time_ms(call)
        del q, k, v, b1, b2, do, out, lse, delta
        torch.cuda.empty_cache()
    return res


def tile_worker(cs, np, torch):
    """Device ms of the tile GEMM at phase 13's decode (warm and L2
    flushed) and NC=2 prefill hops; host us of one decode-hop call."""
    from deepspeed_tpu_torch.ops import tp_matmul as tm
    g = torch.Generator(device="cuda").manual_seed(9)
    res = {}
    for (M, K, N), labels in cs.tile_hop_shapes().items():
        decode = any("decode" in lb for lb in labels)
        if not (decode or any("NC=2" in lb for lb in labels)):
            continue
        x = torch.randn(M, K, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(K, N, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        key = f"{M}x{K}x{N}"
        res[f"{key}_ms"] = cs.time_ms(lambda: tm.tile_matmul(x, w))
        if decode:
            res[f"{key}_cold_ms"] = cs.cold_time_ms(
                torch, lambda: tm.tile_matmul(x, w))
        if "tp4 decode gate/up" in labels:
            res["decode_host_us"] = cs.host_us(
                torch, lambda: tm.tile_matmul(x, w))
    return res


def flash_worker(cs, np, torch):
    """Device ms of the flash forward at the serving and training shapes;
    host us of one call at a small shape."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    for name, shape in (("serve", (4, 512, 32, 32, 128)),
                        ("train", cs.TRAIN_ATTN)):
        q, k, v = cs._qkv(torch, g, "cuda", *shape)
        res[f"{name}_ms"] = cs.time_ms(lambda: fa.flash_attention_fwd(
            q, k, v))
    q, k, v = cs._qkv(torch, g, "cuda", 1, 128, 8, 8, 128)
    res["host_us"] = cs.host_us(torch, lambda: fa.flash_attention_fwd(
        q, k, v))
    return res


def worker(pkg_dir, train_layers, what):
    import importlib.util
    sys.path.insert(0, os.path.abspath(pkg_dir))
    import numpy as np
    import torch
    # this script's chip_smoke (its helpers and shapes), whatever DIR holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import deepspeed_tpu_torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    package = os.path.dirname(deepspeed_tpu_torch.__file__)
    workers = {"paged": paged_worker, "paged_plans": paged_plans_worker,
               "sparse": sparse_worker, "lora": lora_worker,
               "evoformer": evoformer_worker,
               "evoformer_plans": evoformer_plans_worker, "tile": tile_worker,
               "flash": flash_worker}
    if what in workers:
        print("AB " + json.dumps(dict(package=package, **workers[what](
            cs, np, torch))), flush=True)
        return
    from deepspeed_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = cs._qkv(torch, g, "cuda", *cs.TRAIN_ATTN)
    do = torch.randn(q.shape, generator=g, device="cuda", dtype=q.dtype)
    out, lse = fa.flash_attention_fwd(q, k, v)
    kernels = {f"{name}_ms": ms for name, ms in cs.time_flash_bwd(
        fa, q, k, v, out, lse, do).items()}
    kernels["bwd_ms"] = sum(kernels.values())
    del q, k, v, do, out, lse
    counters = [fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv]
    if hasattr(fa, "flash_attention_bwd_delta"):
        counters.append(fa.flash_attention_bwd_delta)
    eng, batch, res = cs.train(torch, np, train_layers, counters)
    prof = cs.profile_train_step(torch, eng, batch, res["step_ms"],
                                 counters)
    print("AB " + json.dumps(dict(
        package=package, **kernels,
        step_ms=res["step_ms"], tokens_per_s=res["tokens_per_s"],
        mfu=res["mfu"], first_loss=res["warmup_losses"][0],
        idle_share=prof["idle_share"], ms_by_kind=prof["ms_by_kind"])),
        flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="*", help="DIR_A DIR_B")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--what", default="train",
                    choices=("train", "paged", "paged_plans", "sparse",
                             "evoformer", "evoformer_plans", "tile", "flash",
                             "lora"))
    ap.add_argument("--train-layers", type=int, default=24)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.train_layers, args.what)
        return 0
    if len(args.dirs) != 2:
        ap.error("need DIR_A and DIR_B")
    runs = []
    for _ in range(args.rounds):
        for label in ("A", "B", "B", "A"):
            d = args.dirs[0 if label == "A" else 1]
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", d,
                 "--train-layers", str(args.train_layers),
                 "--what", args.what],
                capture_output=True, text=True)
            lines = [ln[3:] for ln in proc.stdout.splitlines()
                     if ln.startswith("AB ")]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                print(f"chip_ab: FAILED: run of {d} exited "
                      f"{proc.returncode}", file=sys.stderr)
                return 1
            run = dict(label=label, **json.loads(lines[-1]))
            runs.append(run)
            print(json.dumps(run), flush=True)
    keys = {"train": ("delta_ms", "dq_ms", "dkv_ms", "bwd_ms", "step_ms",
                      "tokens_per_s", "mfu", "first_loss")}.get(args.what)
    if keys is None:   # the others: every number the runs share
        keys = [k for k in runs[0] if k not in ("label", "package")
                and isinstance(runs[0][k], (int, float))]
    for key in keys:
        print(f"{key}: " + ", ".join(f"{r['label']} {r[key]:.6g}"
                                     for r in runs))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
