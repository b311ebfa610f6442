#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--train-layers N] [--out DIR]

Phases (any failure exits non-zero and prints no result):
  0. report the card (name, power limit) and build the CUDA kernels from
     `deepspeed_tpu_torch/csrc` (one nvcc per source, all in parallel);
  1. hold each kernel against its plain PyTorch version on the card, at
     the serving and training paths' shapes and at edge cases (GQA,
     ragged lengths, head dims 32/64/128, f32), and time both (device time
     from torch.profiler) beside the card's bound for the same work;
  2. serve one wave of 8 requests through `build_engine("llama", "7b")`
     (Llama-2-7B widths, random weights from a seeded generator) and
     `generate_batch`, with every kernel's launch counter reset just
     before and read just after: each serving kernel must have launched;
  3. rerun the wave's prefill and one decode step through the kernels and
     through an engine that selects the plain versions explicitly
     (`plain_kernels=True`) and compare the logits;
  4. profile a rerun of the wave (torch.profiler): device time by kernel
     kind, and the device's idle share against phase 2's wall time;
  5. train bench.py's step: `initialize(model=Transformer(gpt2_config(
     "1.3b", ...)), config=<bench.py's dict>)` (random weights from the
     config's seed, one seeded batch of 2049-token rows reused every
     step), 3 warm-up steps, then 10 timed steps with the counters reset
     just before: step ms, tokens/s, mfu, peak memory, every loss, and
     the flash forward, dq and dk/dv launches (one each per layer per
     step under save_attn);
  6. the same initial state and batch through `plain_kernels=True` for 3
     steps, against the kernel engine's warm-up steps (loss and grad
     norm, and at step 1 each layer's attention gradient norms); a control
     run with a known fault in the plain backward, which these checks
     must refuse; one step under nothing_saveable (2 flash forward
     launches per layer, the same loss);
  7. profile one training step: device time by kind (matmuls, the three
     attention kernels, the optimizer's update, other) and the idle share;
  8. (run after phase 4, on phase 2's parameters) the multi-tenant wave:
     phase 2's 8 requests on an engine with chunked prefill only, first
     without adapters (arm A), then through an `AdapterPool` of 4 slots
     holding 5 rank-16 adapters with a host tier (a demote and a promote
     on the card), rows 1, 3 and 5 bound to three adapters and row 7 to
     row 1's (arm B, counters reset just before it): base rows must give
     arm A's tokens and prefill logits exactly, adapter rows other
     chains, the LoRA kernel 32 launches per serving call with adapter
     rows; arm B's prefill and one decode step against the plain-version
     engine with the same stacks; a profiled rerun of arm B; pool and
     engine audits clean;
  9. phase 2's wave on an engine with the merged [L, nb, bs, NKV*D] arena
     sharing the parameters: tokens and phase-3 logits equal to the 5-D
     engine's, through the merged wrappers only.
Every profile must hold each launch the kernels' counters saw in it (a
session that dropped device events is repeated).
Prints a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  `--layers` cuts the serving model's
depth and `--train-layers` the training model's (the widths stay
Llama-2-7B's and GPT-2-1.3B's); the defaults are the full 32 and 24.
"""
import argparse
import json
import os
import subprocess
import sys
import time

# bf16 kernel-vs-plain tolerance, elementwise |out - plain| <= ATOL +
# RTOL * |plain|: both versions read the same bf16 inputs and sum in f32;
# the attention kernels round P to bf16 before P.V on the tensor cores and
# every output is rounded to bf16 once, so two bf16 ulps (2^-7 relative)
# plus a floor of about one ulp at the unit-normal outputs' scale.
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2 ** -7
TOL_TEXT = f"{KERNEL_ATOL} + {KERNEL_RTOL} |plain|"
# lse is f32 in both versions: summation order only
LSE_ATOL = 1e-3
# end-to-end logits, kernel engine vs plain engine (bf16 model, 32 layers):
# each layer's attention output may differ by a bf16 ulp, and the residual
# stream of a random-weight model amplifies that through every later
# layer.  The bound is on max |dlogit| relative to the logits' own scale
# (max |logit|): on an H100 the 16 comparisons (8 requests, first and
# second token) measured 0.035-0.061, alike for every prompt length and
# path (at 2 layers, 0.0075); a wrong mask, block or head moves the
# logits by O(1).
E2E_REL_TOL = 1e-1

# flash backward kernels vs their plain versions, elementwise:
#   |kernel - plain| <= BWD_RTOL |plain| + BWD_ATOL_REL max|plain|.
# bf16: the plain versions keep P and dS in f32; the kernels round them to
# bf16 before the tensor-core products (as the TPU kernels do) and round
# each output once, so each output, a sum over up to S keys or queries,
# carries one to two bf16 ulps of its largest magnitude.  f32: summation
# order only.
BWD_RTOL = 2 ** -7
BWD_ATOL_REL = 2 ** -6
BWD_F32_REL = 1e-5
BWD_TOL_TEXT = (f"bf16 {BWD_RTOL} |plain| + {BWD_ATOL_REL} max|plain|, "
                f"f32 {BWD_F32_REL} max|plain|")
# kernel training engine vs the plain-version engine, per-step loss and
# grad norm, relative.  The engines differ only in attention, where the
# kernels round P and dS to bf16 (the plain versions keep f32): about one
# bf16 ulp per attention output and gradient element.
# - Step 1 runs both from the same parameters: on an H100 it measured
#   2e-6 (loss, about 11) and 1.3e-4 (grad norm, a sum over 1.3e9 bf16
#   gradients); a wrong mask or tile moves either by O(1).
# - Steps 2 and 3 follow AdamW updates, the first of which is nearly
#   sign(g) * lr for every element, so gradient elements near zero whose
#   sign differs between the engines move the two models apart by up to
#   2 lr each; they measured up to 3.5e-4 (loss) and 1.5e-2 (grad norm,
#   at a grad-norm spike of 27).
# - The global norm sums the attention gradients with every other leaf's,
#   so step 1 also holds each layer's wq, wk, wv and wo gradient norm
#   apart: the kernels' rounding of P and dS moved them by 5.0e-4 (wo)
#   to 1.7e-3 (wk) at most over the 24 layers.
# A control run (phase 6) drops delta from the plain backward; these
# checks must refuse it.  On an H100 it read, against the plain engine,
# 0.20 (step-1 grad norm), 0.43-22 (the per-layer attention norms), and
# 2.9e-3 and 2.5e-2 (the loss at steps 2 and 3).
TRAIN_STEP1_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
TRAIN_LATER_RTOL = {"loss": 2e-3, "grad_norm": 5e-2}
TRAIN_LEAF_RTOL = 1e-2
ATTN_LEAVES = ("wq", "wk", "wv", "wo")

PROMPT_LENS = [37, 64, 96, 128, 200, 311, 500, 1500]
MAX_NEW = 32

TRAIN_SEQ = 2048          # bench.py: GPT-2-1.3B at seq 2048, micro 4
TRAIN_MICRO = 4
# (B, S, NH, NKV, D) of the training path's attention: GPT-2-1.3B's 16
# heads of 128 at bench.py's micro-batch and length
TRAIN_ATTN = (TRAIN_MICRO, TRAIN_SEQ, 16, 16, 128)
TRAIN_WARMUP = 3
TRAIN_STEPS = 10

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12       # f32 on the CUDA cores, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM

# gather-LoRA kernel vs its plain version: |kernel - plain| <= LORA_REL
# max|plain|.  Both sides take f32 products of the same inputs (bf16 rows
# widen exactly); only the order of the sums over K and r differs.
LORA_REL = 1e-5
# phase 8: rank-16 adapters over Llama-2-7B's attention output, 5 of them
# through a pool of 4 slots; factors a ~ N(0, 1/K), b ~ N(0, 1/r), so an
# adapter row's delta is about as large as the attention output itself
LORA_RANK = 16
LORA_ADAPTERS = 5
LORA_SLOTS = 4
LORA_BLOCK_ELEMS = 4096      # the pool's residency grain (its default)
# request index -> adapter (row 7 shares row 1's; t0 is demoted when t4
# registers and promoted back by row 1's reservation)
LORA_PLAN = {1: "t0", 3: "t2", 5: "t3", 7: "t0"}

# each kernel as the profiler names it -> (its wrapper, whose `launches`
# counts the wrapper's calls; the device kernels one call runs)
KERNELS = {"flash_fwd": ("flash_attention_fwd", 1),
           "flash_bwd_dq": ("flash_attention_bwd_dq", 1),
           "flash_bwd_dkv": ("flash_attention_bwd_dkv", 1),
           "paged_decode": ("paged_decode_attention", 2),  # + combine
           "paged_prefill": ("paged_prefill_attention", 1),
           "lora_delta": ("lora_delta", 2)}                # shrink + expand
# each row of the kernels line -> the wrapper whose counter it reads (the
# merged wrappers launch the paged kernels on a view of their arena)
WRAPPERS = {**{k: fn for k, (fn, _) in KERNELS.items()},
            "merged_decode": "merged_decode_attention",
            "merged_prefill": "merged_prefill_attention"}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(flops, nbytes, peak=H100_BF16_FLOPS):
    t_ops = flops / peak
    t_mem = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


PROFILE_TRIES = 3


def _kind(name):
    """The kind of a device kernel: one of the port's (they live in
    anonymous namespaces of csrc/*.cu), a cuBLAS matmul, or other."""
    for kernel in KERNELS:
        if f"(anonymous namespace)::{kernel}" in name:
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profiled(body, complete=bool, what="device events"):
    """The device events of `body()` under torch.profiler.  A session
    can come back with device events missing (seen on the H100 machine:
    none at all once, a quarter of a timing loop's kernels once), so a
    session whose events are not `complete(events)` is repeated, up to
    PROFILE_TRIES times, before the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        events = device_events(prof)
        if complete(events):
            return events
    fail(f"the profiler missed {what} in {PROFILE_TRIES} sessions")


def holds_launches(launches):
    """A `complete` test for `profiled`: the events hold, for each of the
    port's kernels, every launch its counter saw during the session
    (`launches`, filled in by the session's body)."""
    def complete(events):
        kinds = {}
        for e in events:
            kinds[_kind(e.name)] = kinds.get(_kind(e.name), 0) + 1
        return bool(launches) and all(
            kinds.get(kernel, 0) == per * launches[fn]
            for kernel, (fn, per) in KERNELS.items() if fn in launches)
    return complete


def counted(counters, body, launches):
    """`body` with the counters set to 0 before it and read into
    `launches` after it."""
    def run():
        for c in counters:
            c.launches = 0
        body()
        launches.update({c.__name__: c.launches for c in counters})
    return run


def time_ms(fn, iters=20, warmup=3):
    """Device time of one call of `fn`: the summed durations of the
    kernels it launches over `iters` calls (torch.profiler), divided by
    `iters`.  Host gaps between launches are left out, which CUDA events
    around a call of a few tens of microseconds would count; the inputs
    stay warm in the 50 MB L2 from call to call.  The loop's session
    must hold `iters` times the events of one call's session."""
    for _ in range(warmup):
        fn()
    per_call = len(profiled(fn, what="the device events of one call"))

    def body():
        for _ in range(iters):
            fn()

    events = profiled(body, lambda ev: len(ev) == iters * per_call,
                      what=f"{iters} x {per_call} device events")
    us = sum(e.time_range.elapsed_us() for e in events)
    if us <= 0:
        fail("the profiler saw no device time")
    return us / 1e3 / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def kernel_close(out, ref):
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs()
                 <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())


# ----------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ----------------------------------------------------------------------
def _qkv(torch, g, dev, B, S, NH, NKV, D, dtype=None):
    dtype = dtype or torch.bfloat16
    return (torch.randn(B, S, NH, D, generator=g, device=dev, dtype=dtype),
            torch.randn(B, S, NKV, D, generator=g, device=dev, dtype=dtype),
            torch.randn(B, S, NKV, D, generator=g, device=dev, dtype=dtype))


def _flash_fwd_work(B, S, NH, NKV, D):
    """(FLOPs, bytes) of one causal bf16 forward call."""
    flops = 4 * B * NH * D * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * NH * D + 2 * B * S * NKV * D) + 4 * B * NH * S
    return flops, nbytes


def check_flash(torch, fa, dev):
    import torch.nn.functional as F
    errs = []
    g = torch.Generator(device=dev).manual_seed(1)
    f32 = torch.float32
    # (B, S, NH, NKV, D, dtype): the serving path's shape first, the
    # training path's second
    cases = [(4, 512, 32, 32, 128, None), TRAIN_ATTN + (None,),
             (1, 300, 32, 8, 128, None), (2, 200, 16, 16, 64, None),
             (2, 100, 8, 2, 32, None), (2, 200, 8, 2, 128, f32)]
    for B, S, NH, NKV, D, dt in cases:
        q, k, v = _qkv(torch, g, dev, B, S, NH, NKV, D, dt)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        print(f"  flash_fwd B={B} S={S} NH={NH} NKV={NKV} D={D} "
              f"{str(q.dtype)[6:]}: max|dout|={e:.3e} max|dlse|={el:.3e}")
        if not (kernel_close(out, ref) and el <= LSE_ATOL):
            fail(f"flash_fwd disagrees with its plain version at "
                 f"{(B, S, NH, NKV, D, q.dtype)}: {e} (tol {TOL_TEXT}), "
                 f"lse {el} (tol {LSE_ATOL})")
        errs.append(max(e, el))
        del ref, ref_lse
    B, S, NH, NKV, D, _ = cases[0]
    q, k, v = _qkv(torch, g, dev, B, S, NH, NKV, D)
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain = time_ms(lambda: fa.flash_attention_reference(q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    bms, by = bound_ms(*_flash_fwd_work(B, S, NH, NKV, D))
    # the training path's shape: kernel time beside its bound
    tq, tk, tv = _qkv(torch, g, dev, *TRAIN_ATTN)
    train_ms = time_ms(lambda: fa.flash_attention_fwd(tq, tk, tv))
    train_bound = bound_ms(*_flash_fwd_work(*TRAIN_ATTN))[0]
    print(f"  flash_fwd at the training shape: {train_ms:.4f} ms (bound "
          f"{train_bound:.4f} ms)")
    return dict(name="flash_fwd", route="cuda",
                source="deepspeed_tpu_torch/csrc/flash_fwd.cu",
                replaces="deepspeed_tpu/ops/flash_attention.py:272",
                shape=f"q [{B},{S},{NH},{D}] k/v [{B},{S},{NKV},{D}] bf16",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
                train_shape="q/k/v [{},{},{},{}] bf16".format(
                    *TRAIN_ATTN[:3], TRAIN_ATTN[4]),
                train_ms=train_ms, train_bound_ms=train_bound)


def _arena(torch, g, dev, L, nb, bs, NKV, D):
    return (torch.randn(L, nb, bs, NKV, D, generator=g, device=dev,
                        dtype=torch.bfloat16),
            torch.randn(L, nb, bs, NKV, D, generator=g, device=dev,
                        dtype=torch.bfloat16))


def _garbage_tables(np, rng, B, MB, nb, bs, lens):
    """Live blocks are distinct arena blocks; entries past a row's live
    blocks are garbage (negative and past the arena included)."""
    perm = rng.permutation(nb)
    tables = rng.randint(-5, nb + 5, size=(B, MB)).astype(np.int32)
    used = 0
    for b in range(B):
        live = max(int(lens[b]), 0) // bs + 1
        tables[b, :live] = perm[used:used + live]
        used += live
    return tables


def check_decode(torch, np, pa, dev):
    rng = np.random.RandomState(2)
    g = torch.Generator(device=dev).manual_seed(2)
    L, nb, bs, MB = 2, 256, 64, 32
    errs, main = [], None
    # (NH, NKV, D, lens): main shape first — B=8 at mixed lens up to ~1500
    cases = [(32, 32, 128, [36, 63, 95, 127, 199, 310, 499, 1499]),
             (32, 8, 128, [5, -1, 700, 64, 1, -3, 1200, 0]),
             (8, 2, 32, [40, -1, 300, 0])]
    for NH, NKV, D, lens_l in cases:
        B = len(lens_l)
        ak, av = _arena(torch, g, dev, L, nb, bs, NKV, D)
        q = torch.randn(B, NH, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        lens_np = np.asarray(lens_l, np.int32)
        tables = torch.from_numpy(_garbage_tables(
            np, rng, B, MB, nb, bs, lens_np)).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        out = pa.paged_decode_attention(q, ak, av, tables, lens, layer_idx=1)
        ref = pa.paged_decode_reference(q, ak, av, tables, lens, layer_idx=1)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        zero_ok = bool((out[lens < 0] == 0).all())
        print(f"  paged_decode B={B} NH={NH} NKV={NKV} D={D} lens={lens_l}: "
              f"max|dout|={e:.3e} inactive rows zero: {zero_ok}")
        if not (kernel_close(out, ref) and zero_ok):
            fail(f"paged_decode disagrees with its plain version "
                 f"(NH={NH}, NKV={NKV}): {e} (tol {TOL_TEXT}), "
                 f"inactive rows zero: {zero_ok}")
        errs.append(e)
        if main is None:
            main = (q, ak, av, tables, lens, lens_np, NH, NKV, D)
    q, ak, av, tables, lens, lens_np, NH, NKV, D = main
    B = q.shape[0]
    ms = time_ms(lambda: pa.paged_decode_attention(q, ak, av, tables, lens,
                                                   layer_idx=1))
    plain = time_ms(lambda: pa.paged_decode_reference(
        q, ak, av, tables, lens, layer_idx=1))
    keys = int(np.sum(np.maximum(lens_np, -1) + 1))
    flops = 4 * NH * D * keys
    nbytes = (2 * keys * NKV * D * 2 + 2 * 2 * B * NH * D + 4 * B * MB
              + 4 * B)
    bms, by = bound_ms(flops, nbytes)
    return dict(name="paged_decode", route="cuda",
                source="deepspeed_tpu_torch/csrc/paged_decode.cu",
                replaces="deepspeed_tpu/ops/paged_attention.py:208",
                shape=f"q [{B},{NH},{D}] arena [{L},{nb},{bs},{NKV},{D}] "
                      f"bf16, lens {lens_np.tolist()}",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def _prefill_work(C, NH, NKV, D, pos0, n_valid, window):
    """(FLOPs, bytes) one paged prefill call needs: the valid queries'
    visible keys, each distinct visible key row read once."""
    vis, lo_min = 0, None
    for c in range(n_valid):
        qp = pos0 + c
        lo = 0 if window is None else max(0, qp - window + 1)
        lo_min = lo if lo_min is None else min(lo_min, lo)
        vis += qp - lo + 1
    distinct = pos0 + n_valid - (lo_min or 0)
    flops = 4 * NH * D * vis
    nbytes = 2 * distinct * NKV * D * 2 + 2 * 2 * C * NH * D
    return flops, nbytes


def check_prefill(torch, np, pp, dev):
    rng = np.random.RandomState(3)
    g = torch.Generator(device=dev).manual_seed(3)
    L, nb, bs, MB = 2, 256, 64, 32
    errs, main = [], None
    # (C, NH, NKV, D, pos0, n_valid, window): main shape first
    cases = [(256, 32, 32, 128, 1024, 256, None),
             (256, 32, 8, 128, 700, 100, None),
             (3, 32, 32, 128, 77, 3, None), (64, 32, 8, 128, 300, 64, 128),
             (5, 32, 32, 128, 0, 2, None), (70, 8, 2, 32, 100, 61, None)]
    for C, NH, NKV, D, pos0, n_valid, win in cases:
        ak, av = _arena(torch, g, dev, L, nb, bs, NKV, D)
        q = torch.randn(C, NH, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        last = pos0 + n_valid - 1
        table = torch.from_numpy(_garbage_tables(
            np, rng, 1, MB, nb, bs, np.asarray([last]))[0]).to(dev)
        out = pp.paged_prefill_attention(q, ak, av, table, pos0, n_valid,
                                         sliding_window=win, layer_idx=1)
        ref = pp.paged_prefill_reference(q, ak, av, table, pos0, n_valid,
                                         sliding_window=win, layer_idx=1)
        torch.cuda.synchronize()
        e = max_err(out[:n_valid], ref[:n_valid])
        print(f"  paged_prefill C={C} NH={NH} NKV={NKV} D={D} pos0={pos0} "
              f"n_valid={n_valid} window={win}: max|dout|={e:.3e}")
        if not kernel_close(out[:n_valid], ref[:n_valid]):
            fail(f"paged_prefill disagrees with its plain version at "
                 f"{(C, NH, NKV, D, pos0, n_valid, win)}: {e} "
                 f"(tol {TOL_TEXT})")
        errs.append(e)
        if main is None:
            main = (q, ak, av, table, C, NH, NKV, D, pos0, n_valid)
    q, ak, av, table, C, NH, NKV, D, pos0, n_valid = main
    ms = time_ms(lambda: pp.paged_prefill_attention(
        q, ak, av, table, pos0, n_valid, layer_idx=1))
    plain = time_ms(lambda: pp.paged_prefill_reference(
        q, ak, av, table, pos0, n_valid, layer_idx=1))
    flops, nbytes = _prefill_work(C, NH, NKV, D, pos0, n_valid, None)
    bms, by = bound_ms(flops, nbytes)
    return dict(name="paged_prefill", route="cuda",
                source="deepspeed_tpu_torch/csrc/paged_prefill.cu",
                replaces="deepspeed_tpu/ops/paged_prefill.py:309",
                shape=f"q [{C},{NH},{D}] arena [{L},{nb},{bs},{NKV},{D}] "
                      f"bf16, pos0={pos0} n_valid={n_valid}",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def _lora_ids(np, rng, S, slots):
    """Unsorted slot ids with base rows (-1) and an empty slot (the last)."""
    ids = rng.randint(-1, slots - 1, S).astype(np.int32)
    ids[::5] = -1
    return ids


def _lora_work(np, ids, K, N, r, x_bytes):
    """(FLOPs, bytes) one call needs for these ids: the adapter rows'
    two products, their x rows, each used slot's factors and the ids read
    once, every output row (the base rows' zeros too) written once."""
    rows = int((ids >= 0).sum())
    used = len(np.unique(ids[ids >= 0]))
    flops = 2 * rows * (K * r + r * N)
    nbytes = (rows * K * x_bytes + used * (K * r + r * N) * 4
              + 4 * ids.size + 4 * ids.size * N)
    return flops, nbytes


def check_lora(torch, np, lm, dev):
    """The gather-LoRA kernel against its plain version: the wave's shapes
    (decode rows 32, prefill rows 512 and 2048; K = N = 4096, rank 16, 4
    slots of f32 factors), then ranks 1 and 128, K and N not multiples of
    64, f32 rows and a batch of base rows only."""
    rng = np.random.RandomState(5)
    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    # (S, K, N, r, slots, x dtype): the timed prefill shape first
    cases = [(512, 4096, 4096, 16, 4, bf16), (32, 4096, 4096, 16, 4, bf16),
             (2048, 4096, 4096, 16, 4, bf16), (512, 4096, 4096, 1, 4, bf16),
             (512, 4096, 4096, 128, 4, bf16), (77, 1000, 777, 16, 3, bf16),
             (64, 4096, 4096, 16, 4, f32), (48, 4096, 4096, 16, 4, None)]
    errs, rels, main = [], [], None
    for S, K, N, r, slots, dt in cases:
        x = torch.randn(S, K, generator=g, device=dev, dtype=dt or bf16)
        a = torch.randn(slots, K, r, generator=g, device=dev) / K ** 0.5
        b = torch.randn(slots, r, N, generator=g, device=dev) / r ** 0.5
        ids = (_lora_ids(np, rng, S, slots) if dt is not None
               else np.full(S, -1, np.int32))
        rows = lm.LoraRows(ids)
        out = lm.lora_delta(x, a, b, rows)
        ref = lm.lora_delta_reference(x, a, b, rows)
        torch.cuda.synchronize()
        base = torch.from_numpy(ids < 0).to(dev)
        zeros = bool((out[base] == 0).all()
                     and not out[base].signbit().any())
        scale = float(ref.abs().max())
        err = max_err(out, ref)
        rel = err / scale if scale > 0 else err
        print(f"  lora_delta S={S} K={K} N={N} r={r} slots={slots} x "
              f"{str(dt)[6:] if dt else 'bf16, every row base'}: "
              f"max|d|/max|plain|={rel:.3e} base rows exactly 0: {zeros}")
        if not (zeros and rel <= LORA_REL):
            fail(f"lora_delta disagrees with its plain version at "
                 f"{(S, K, N, r, slots, dt)}: {rel} of max|plain| (tol "
                 f"{LORA_REL}), base rows exactly 0: {zeros}")
        errs.append(err)
        rels.append(rel)
        if main is None:
            main = (x, a, b, ids, rows, S, K, N, r)
    # the timed shapes: prefill rows (the first case) and decode rows
    x, a, b, ids, rows, S, K, N, r = main
    ms = time_ms(lambda: lm.lora_delta(x, a, b, rows))
    plain = time_ms(lambda: lm.lora_delta_reference(x, a, b, rows), iters=5)
    bms, by = bound_ms(*_lora_work(np, ids, K, N, r, 2), H100_F32_FLOPS)
    xd = torch.randn(32, K, generator=g, device=dev, dtype=bf16)
    ids_d = _lora_ids(np, rng, 32, 4)
    rows_d = lm.LoraRows(ids_d)
    dec_ms = time_ms(lambda: lm.lora_delta(xd, a, b, rows_d))
    dec_bound = bound_ms(*_lora_work(np, ids_d, K, N, r, 2),
                         H100_F32_FLOPS)[0]
    print(f"  lora_delta at the decode shape (32 rows): {dec_ms:.4f} ms "
          f"(bound {dec_bound:.4f} ms); at {S} rows {ms:.4f} ms (bound "
          f"{bms:.4f} ms)")
    return dict(name="lora_delta", route="cuda",
                source="deepspeed_tpu_torch/csrc/lora_delta.cu",
                replaces="deepspeed_tpu/ops/lora_matmul.py:125",
                shape=f"x [{S},{K}] bf16, A [4,{K},{r}] / B [4,{r},{N}] "
                      f"f32, ids {int((ids >= 0).sum())} adapter rows of "
                      f"{len(np.unique(ids[ids >= 0]))} slots",
                max_abs_err=max(errs), max_rel_err=max(rels),
                max_rel_err_note="max|kernel - plain| / max|plain|",
                ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None,
                library_note="no single PyTorch call does a per-row slot "
                             "gather and product",
                decode_shape=f"x [32,{K}] bf16", decode_ms=dec_ms,
                decode_bound_ms=dec_bound)


WAVE_LENS = [36, 63, 95, 127, 199, 310, 499, 1499]   # decode positions


def paged_main_inputs(torch, np, dev, NH=32, NKV=32, D=128, seed=6):
    """Phase 1's main paged shapes on one [2, 256, 64, NKV, D] bf16 arena
    (table entries past the live blocks garbage): decode, q [8, NH, D] at
    the wave's positions WAVE_LENS, and prefill, q [256, NH, D] at pos0
    1024 — (q, ak, av, tables, lens) and (q, ak, av, table, pos0,
    n_valid), layer 1 to be read."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, nb, bs, MB = 2, 256, 64, 32
    ak, av = _arena(torch, g, dev, L, nb, bs, NKV, D)
    lens = np.asarray(WAVE_LENS, np.int32)
    q = torch.randn(lens.size, NH, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    tables = torch.from_numpy(_garbage_tables(
        np, rng, lens.size, MB, nb, bs, lens)).to(dev)
    qc = torch.randn(256, NH, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    table = torch.from_numpy(_garbage_tables(
        np, rng, 1, MB, nb, bs, np.asarray([1024 + 255]))[0]).to(dev)
    return ((q, ak, av, tables, torch.from_numpy(lens).to(dev)),
            (qc, ak, av, table, 1024, 256))


def check_merged(torch, np, pa, pp, pm, dev):
    """The merged-arena wrappers: bit for bit the 5-D kernels on the same
    bytes, and within the paged limits of their plain versions; timed at
    phase 1's main decode and prefill shapes."""
    errs, main = [], None
    # (NH, NKV, D): the serving shape first, then GQA and D 64
    for NH, NKV, D in ((32, 32, 128), (32, 8, 128), (8, 2, 64)):
        dec, pre = paged_main_inputs(torch, np, dev, NH, NKV, D)
        ak, av = (t.view(*t.shape[:3], NKV * D) for t in dec[1:3])
        mdec, mpre = (dec[0], ak, av, *dec[3:]), (pre[0], ak, av, *pre[3:])
        out = pm.merged_decode_attention(*mdec, layer_idx=1)
        ref = pm.merged_decode_reference(*mdec, layer_idx=1)
        outc = pm.merged_prefill_attention(*mpre, layer_idx=1)
        refc = pm.merged_prefill_reference(*mpre, layer_idx=1)
        same = (torch.equal(out, pa.paged_decode_attention(*dec,
                                                            layer_idx=1)),
                torch.equal(outc, pp.paged_prefill_attention(*pre,
                                                             layer_idx=1)))
        torch.cuda.synchronize()
        e = (max_err(out, ref), max_err(outc, refc))
        print(f"  merged NH={NH} NKV={NKV} D={D}: decode == 5-D kernel: "
              f"{same[0]}, max|d plain|={e[0]:.3e}; prefill == 5-D "
              f"kernel: {same[1]}, max|d plain|={e[1]:.3e}")
        if not (all(same) and kernel_close(out, ref)
                and kernel_close(outc, refc)):
            fail(f"merged wrappers at {(NH, NKV, D)}: equal to the 5-D "
                 f"kernels {same}, plain differences {e} (tol {TOL_TEXT})")
        errs.append(e)
        if main is None:
            main = (mdec, mpre, NH, NKV, D)
    (q, ak, av, tables, lens), mpre, NH, NKV, D = main
    L, nb, bs, M = ak.shape
    B, MB = q.shape[0], tables.shape[1]
    keys = int(np.sum(np.asarray(WAVE_LENS) + 1))
    dec = dict(ms=time_ms(lambda: pm.merged_decode_attention(
                   *main[0], layer_idx=1)),
               plain_ms=time_ms(lambda: pm.merged_decode_reference(
                   *main[0], layer_idx=1)))
    dec["bound_ms"], dec["bound_by"] = bound_ms(
        4 * NH * D * keys, 2 * keys * NKV * D * 2 + 2 * 2 * B * NH * D
        + 4 * B * MB + 4 * B)
    pre = dict(ms=time_ms(lambda: pm.merged_prefill_attention(
                   *mpre, layer_idx=1)),
               plain_ms=time_ms(lambda: pm.merged_prefill_reference(
                   *mpre, layer_idx=1)))
    pre["bound_ms"], pre["bound_by"] = bound_ms(
        *_prefill_work(256, NH, NKV, D, 1024, 256, None))
    arena = f"arena [{L},{nb},{bs},{M}] bf16"
    return [dict(name="merged_decode", route="cuda",
                 source="deepspeed_tpu_torch/csrc/paged_decode.cu",
                 wrapper="deepspeed_tpu_torch/ops/paged_merged.py",
                 replaces="deepspeed_tpu/ops/paged_merged.py:202",
                 shape=f"q [{B},{NH},{D}] {arena}, lens {WAVE_LENS}",
                 max_abs_err=max(e[0] for e in errs), **dec,
                 library_ms=None),
            dict(name="merged_prefill", route="cuda",
                 source="deepspeed_tpu_torch/csrc/paged_prefill.cu",
                 wrapper="deepspeed_tpu_torch/ops/paged_merged.py",
                 replaces="deepspeed_tpu/ops/paged_merged.py:400",
                 shape=f"q [256,{NH},{D}] {arena}, pos0=1024 n_valid=256",
                 max_abs_err=max(e[1] for e in errs), **pre,
                 library_ms=None)]


def _flash_bwd_work(B, S, NH, NKV, D, nmm, n_out_kv):
    """(FLOPs, bytes) of one causal backward kernel call: `nmm` [S, S, D]
    products over the S(S+1)/2 visible pairs per head; q, k, v, out, dO
    (bf16) and lse (f32) read once, and dq or dk/dv written once."""
    flops = nmm * 2 * D * (S * (S + 1) // 2) * B * NH
    q_like = B * S * NH * D
    kv_like = B * S * NKV * D
    nbytes = 2 * (3 * q_like + 2 * kv_like) + 4 * B * NH * S
    nbytes += 2 * (n_out_kv * kv_like if n_out_kv else q_like)
    return flops, nbytes


def bwd_close(got, ref, rtol, atol_rel):
    """Elementwise |got - ref| <= rtol |ref| + atol_rel max|ref| (max|ref|
    floored at 1, the unit-normal inputs' scale); returns (ok,
    max|got - ref| / max|ref|)."""
    got, ref = got.float(), ref.float()
    scale = max(float(ref.abs().max()), 1.0)
    ok = bool(((got - ref).abs()
               <= rtol * ref.abs() + atol_rel * scale).all())
    return ok, float((got - ref).abs().max()) / scale


def time_flash_bwd(fa, q, k, v, out, lse, do):
    """Device ms of the dq and of the dk/dv kernel on these inputs."""
    return {"dq": time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, out, lse, do)),
            "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, out, lse, do))}


def check_flash_bwd(torch, fa, dev):
    """The dq and dk/dv kernels against their plain versions, both fed the
    flash forward kernel's out and lse; timed at the training shape."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(4)
    # (B, S, NH, NKV, D, dtype): the training shape first, then GQA with a
    # ragged tail, D 64, D 32, and f32
    cases = [TRAIN_ATTN + (torch.bfloat16,),
             (1, 1000, 32, 4, 128, torch.bfloat16),
             (2, 300, 8, 8, 64, torch.bfloat16),
             (2, 100, 8, 2, 32, torch.bfloat16),
             (2, 200, 8, 2, 128, torch.float32)]
    errs = {"dq": [], "dkv": []}
    main = None
    for B, S, NH, NKV, D, dt in cases:
        q, do = (torch.randn(B, S, NH, D, generator=g, device=dev, dtype=dt)
                 for _ in range(2))
        k, v = (torch.randn(B, S, NKV, D, generator=g, device=dev,
                            dtype=dt) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do)
        rdq = fa.flash_attention_bwd_dq_reference(q, k, v, out, lse, do)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, out, lse,
                                                        do)
        torch.cuda.synchronize()
        rtol, arel = ((BWD_RTOL, BWD_ATOL_REL) if dt == torch.bfloat16
                      else (0.0, BWD_F32_REL))
        res = {n: bwd_close(a, b, rtol, arel)
               for n, a, b in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv))}
        print(f"  flash_bwd B={B} S={S} NH={NH} NKV={NKV} D={D} "
              f"{str(dt)[6:]}: max|d| / max|plain| " + ", ".join(
                  f"{n} {r[1]:.3e}" for n, r in res.items()))
        for n, (ok, rel) in res.items():
            if not ok:
                fail(f"flash backward {n} disagrees with its plain version "
                     f"at {(B, S, NH, NKV, D, dt)}: {rel} of max|plain| "
                     f"(tol {BWD_TOL_TEXT})")
        errs["dq"].append(max_err(dq, rdq))
        errs["dkv"].append(max(max_err(dk, rdk), max_err(dv, rdv)))
        if main is None:
            main = (q, k, v, out, lse, do, B, S, NH, NKV, D)
        del rdq, rdk, rdv
    q, k, v, out, lse, do, B, S, NH, NKV, D = main
    ms = time_flash_bwd(fa, q, k, v, out, lse, do)
    plain = {"dq": time_ms(lambda: fa.flash_attention_bwd_dq_reference(
                 q, k, v, out, lse, do), iters=3, warmup=1),
             "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
                 q, k, v, out, lse, do), iters=3, warmup=1)}
    # library yardstick: SDPA's backward (forward + backward less forward)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_bwd = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)
    print(f"  SDPA backward at the training shape: {lib_bwd:.4f} ms "
          f"(dq + dk/dv kernels {ms['dq'] + ms['dkv']:.4f} ms)")
    shape = (f"q/k/v/dO [{B},{S},{NH},{D}] bf16 causal")
    rows = []
    for name, nmm, nkv, line in (("dq", 3, 0, 374), ("dkv", 4, 2, 398)):
        flops, nbytes = _flash_bwd_work(B, S, NH, NKV, D, nmm, nkv)
        bms, by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=f"flash_bwd_{name}", route="cuda",
            source="deepspeed_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"deepspeed_tpu/ops/flash_attention.py:{line}",
            shape=shape, max_abs_err=max(errs[name]), ms=ms[name],
            plain_ms=plain[name], bound_ms=bms, bound_by=by,
            library_ms=lib_bwd,
            library_note="SDPA backward (fwd+bwd less fwd): dq, dk and dv "
                         "in one call"))
    return rows


# ----------------------------------------------------------------------
# phases 5-7: the training path
# ----------------------------------------------------------------------
def bench_config(policy):
    """bench.py's training configuration on one device."""
    return {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.1,
                                     "state_dtype": "int8f"}},
            "data_types": {"grad_accum_dtype": "bf16"},
            "zero_optimization": {"stage": 1},
            "bf16": {"enabled": True},
            "gradient_clipping": 1.0,
            "steps_per_print": 0,
            "activation_checkpointing": {"policy": policy}}


def train_model(torch, layers):
    import deepspeed_tpu_torch as dt
    return dt.Transformer(dt.gpt2_config(
        "1.3b", max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16, remat=True,
        tiled_loss_shards=8, num_layers=layers))


def train_batch_np(np, cfg, gbs):
    """One seeded batch of S+1-token rows, reused every step (bench.py)."""
    rng = np.random.RandomState(0)
    return {"input_ids": rng.randint(0, cfg.vocab_size, (gbs, TRAIN_SEQ + 1)
                                     ).astype(np.int32)}


def attn_grad_norms(eng):
    """Each layer's attention gradient norms of the engine's last step,
    {leaf: [L floats]} for wq, wk, wv and wo."""
    g = eng.grads["layers"]
    return {k: g[k].float().flatten(1).norm(dim=1).tolist()
            for k in ATTN_LEAVES}


def _steps(torch, eng, batch, n):
    """n steps: (losses, grad norms, step 1's `attn_grad_norms`)."""
    out, first = [], None
    for i in range(n):
        out.append(eng.train_batch(batch))
        if i == 0:
            first = attn_grad_norms(eng)
    torch.cuda.synchronize()
    return ([float(m["loss"]) for m in out],
            [float(m["grad_norm"]) for m in out], first)


def train(torch, np, layers, counters):
    import deepspeed_tpu_torch as dt
    model = train_model(torch, layers)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = dt.initialize(model=model, config=bench_config("save_attn"))
    torch.cuda.synchronize()
    gbs = eng.config.train_batch_size
    batch = train_batch_np(np, cfg, gbs)
    n_params = model.num_params()
    print(f"phase 5: GPT-2-1.3B widths (H={cfg.hidden_size}, "
          f"L={cfg.num_layers}, NH={cfg.num_heads}, D={cfg.head_dim}, "
          f"V={cfg.vocab_size}, {n_params} parameters) bf16, random "
          f"weights (seed {eng.config.seed}); micro {gbs} x S "
          f"{TRAIN_SEQ}, save_attn, tiled loss x8, AdamW int8f; engine up "
          f"in {time.perf_counter() - t0:.1f} s")
    warm = _steps(torch, eng, batch, TRAIN_WARMUP)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = [eng.train_batch(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    losses = [float(m["loss"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = gbs * TRAIN_SEQ * TRAIN_STEPS / wall
    flops_tok = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size \
        * TRAIN_SEQ
    mfu = flops_tok * tok_s / H100_BF16_FLOPS
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"phase 5: warm-up losses {warm[0]}, grad norms {warm[1]}")
    print(f"phase 5: {TRAIN_STEPS} steps in {wall:.3f} s: step "
          f"{step_ms:.2f} ms, {tok_s:.1f} tokens/s, mfu {mfu:.4f} "
          f"(6N + 12 L H S FLOP/token at {H100_BF16_FLOPS:.3g} FLOP/s), "
          f"peak memory {peak / 2 ** 30:.2f} GiB")
    print(f"phase 5: losses {losses}")
    print(f"phase 5: launches per step {per_step}")
    if not all(np.isfinite(losses + warm[0] + warm[1])):
        fail(f"non-finite training loss or grad norm: {losses}, {warm}")
    for name, n in launches.items():
        if n != cfg.num_layers * TRAIN_STEPS:
            fail(f"{name} launched {n} times over {TRAIN_STEPS} steps, "
                 f"want {cfg.num_layers} per step (one per layer under "
                 f"save_attn)")
    res = dict(step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
               peak_memory_bytes=peak, losses=losses,
               warmup_losses=warm[0], warmup_grad_norms=warm[1],
               warmup_attn_grad_norms=warm[2], launches=launches, launches_per_step=per_step,
               n_params=n_params, layers=cfg.num_layers)
    return eng, batch, res


def profile_train_step(torch, eng, batch, step_ms, counters):
    """Device time of one training step by kind, and the device's idle
    share against the unprofiled steps' mean wall time."""
    from deepspeed_tpu_torch.runtime.engine import OPTIMIZER_RANGE
    launches = {}
    events = profiled(counted(counters, lambda: eng.train_batch(batch),
                              launches),
                      holds_launches(launches),
                      what="attention kernels of the training step")
    # the optimizer range also shows on the device timeline as an
    # annotation spanning its kernels: it is a window, not a kernel
    spans = [e.time_range for e in events if e.name == OPTIMIZER_RANGE]
    by_kind = {}
    opt_ms = 0.0
    for e in events:
        if e.name == OPTIMIZER_RANGE:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if any(r.start <= e.time_range.start < r.end for r in spans):
            opt_ms += ms
            continue
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + ms
    if spans:
        by_kind["optimizer"] = opt_ms
    busy = sum(by_kind.values())
    if busy <= 0:
        fail("the profiler saw no device time in the training step")
    res = dict(device_ms=busy, step_wall_ms=step_ms,
               idle_share=max(0.0, 1 - busy / step_ms), ms_by_kind=by_kind,
               optimizer_share=(opt_ms / busy if spans else None))
    print(f"phase 7: training step device time {busy:.2f} ms of "
          f"{step_ms:.2f} ms wall (idle share {res['idle_share']:.3f}); by "
          f"kind (ms) " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              by_kind.items(), key=lambda kv: -kv[1])))
    if not spans:
        print("phase 7: the optimizer range did not show on the device "
              "timeline: its share is not measured")
    return res


def plain_train_run(torch, np, layers, counters):
    """bench.py's step from the same initial state and batch through
    `plain_kernels=True`, for the warm-up's steps: `_steps`'s readings."""
    import deepspeed_tpu_torch as dt
    model = train_model(torch, layers)
    eng = dt.initialize(model=model, config=bench_config("save_attn"),
                        plain_kernels=True)
    batch = train_batch_np(np, model.cfg, eng.config.train_batch_size)
    before = [c.launches for c in counters]
    run = _steps(torch, eng, batch, TRAIN_WARMUP)
    if [c.launches for c in counters] != before:
        fail("the plain_kernels engine launched a kernel")
    del eng
    torch.cuda.empty_cache()
    return run


def train_differences(got, plain):
    """`_steps` readings against the plain engine's: (the relative
    differences {"loss": [by step], "grad_norm": [...], "attn_leaves":
    {leaf: max over layers at step 1}}, the checks they fail)."""
    rel = {key: [abs(a - b) / abs(b) for a, b in zip(got[j], plain[j])]
           for j, key in enumerate(("loss", "grad_norm"))}
    rel["attn_leaves"] = {
        k: max(abs(a - b) / b for a, b in zip(got[2][k], plain[2][k]))
        for k in ATTN_LEAVES}
    failed = [f"step {i + 1} {key} {r:.3e} > "
              f"{(TRAIN_STEP1_RTOL if i == 0 else TRAIN_LATER_RTOL)[key]}"
              for key in ("loss", "grad_norm")
              for i, r in enumerate(rel[key])
              if r > (TRAIN_STEP1_RTOL if i == 0 else TRAIN_LATER_RTOL)[key]]
    failed += [f"step 1 {k} gradient norm {r:.3e} > {TRAIN_LEAF_RTOL}"
               for k, r in rel["attn_leaves"].items() if r > TRAIN_LEAF_RTOL]
    return rel, failed


def _rel_text(rel):
    return (", ".join(f"{k} {[float(f'{r:.3e}') for r in rel[k]]}"
                      for k in ("loss", "grad_norm"))
            + "; step 1 per-layer attention gradient norms, max over "
              "layers: " + ", ".join(f"{k} {r:.3e}" for k, r in
                                    rel["attn_leaves"].items()))


def compare_train_plain(kernel_warm, plain):
    """The kernel engine's warm-up steps against the plain engine's."""
    rel, failed = train_differences(kernel_warm, plain)
    print(f"phase 6: kernel engine vs plain engine over {TRAIN_WARMUP} "
          f"steps: losses {kernel_warm[0]} vs {plain[0]}, grad norms "
          f"{kernel_warm[1]} vs {plain[1]}; relative differences by step "
          f"{_rel_text(rel)} (tol step 1 {TRAIN_STEP1_RTOL}, later "
          f"{TRAIN_LATER_RTOL}, attention leaves {TRAIN_LEAF_RTOL})")
    if failed:
        fail("kernel and plain training engines disagree: "
             + "; ".join(failed))
    return dict(plain_losses=plain[0], plain_grad_norms=plain[1],
                rel_dloss=rel["loss"], rel_dgrad_norm=rel["grad_norm"],
                rel_attn_leaves=rel["attn_leaves"])


def control_fault(torch, np, fa, layers, counters, plain):
    """Control for phase 6's checks: the plain engine again, with delta =
    rowsum(dO * O) dropped from its attention backward (O read as
    zeros), against the plain engine.  The checks must refuse it."""
    reference = fa._bwd_reference   # the plain backward the op calls

    def no_delta(q, k, v, out, lse, do, causal):
        return reference(q, k, v, torch.zeros_like(out), lse, do, causal)

    fa._bwd_reference = no_delta
    try:
        faulty = plain_train_run(torch, np, layers, counters)
    finally:
        fa._bwd_reference = reference
    rel, failed = train_differences(faulty, plain)
    print(f"phase 6: control (delta dropped from the plain backward) vs "
          f"plain engine: losses {faulty[0]}, grad norms {faulty[1]}; "
          f"relative differences by step {_rel_text(rel)}; refused by: "
          f"{failed}")
    if not failed:
        fail("phase 6's checks pass a backward without delta")
    return dict(losses=faulty[0], grad_norms=faulty[1],
                rel_dloss=rel["loss"], rel_dgrad_norm=rel["grad_norm"],
                rel_attn_leaves=rel["attn_leaves"], refused_by=failed)


def remat_launches(torch, np, layers, counters, first_loss):
    """One step under nothing_saveable: the layer recompute reruns the
    flash forward kernel (2L launches), and the loss equals save_attn's."""
    import deepspeed_tpu_torch as dt
    model = train_model(torch, layers)
    eng = dt.initialize(model=model,
                        config=bench_config("nothing_saveable"))
    batch = train_batch_np(np, model.cfg, eng.config.train_batch_size)
    for c in counters:
        c.launches = 0
    m = eng.train_batch(batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    loss = float(m["loss"])
    del eng
    L = model.cfg.num_layers
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    print(f"phase 6: one nothing_saveable step: launches {launches} (want "
          f"{want}); loss {loss} vs save_attn's {first_loss}")
    if launches != want:
        fail(f"nothing_saveable launches {launches}, want {want}")
    if abs(loss - first_loss) > 1e-6 * abs(first_loss):
        fail(f"nothing_saveable loss {loss} != save_attn loss {first_loss}")
    return dict(launches=launches, loss=loss)


# ----------------------------------------------------------------------
# phases 2 and 3: the serving path
# ----------------------------------------------------------------------
def _timed(torch, np, fn, acc, key, finite):
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        acc[key + "_calls"] += 1
        if key == "prefill":
            for uid, row in out.items():
                finite.append(bool(np.isfinite(row).all()))
        return out
    return wrapped


def serve(torch, np, layers, counters):
    from deepspeed_tpu_torch.inference.v2 import build_engine
    t0 = time.perf_counter()
    eng = build_engine("llama", "7b", dtype=torch.bfloat16, device="cuda",
                       num_layers=layers)
    torch.cuda.synchronize()
    cfg = eng.cfg
    print(f"phase 2: Llama-2-7B widths (H={cfg.hidden_size}, "
          f"L={cfg.num_layers}, NH={cfg.num_heads}, NKV={cfg.kv_heads}, "
          f"D={cfg.head_dim}, V={cfg.vocab_size}) bf16, random weights "
          f"(seed 0) built in {time.perf_counter() - t0:.1f} s; arena "
          f"{tuple(eng.arena['k'].shape)} x2")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    acc = {"prefill": 0.0, "prefill_calls": 0, "decode": 0.0,
           "decode_calls": 0}
    finite = []
    eng.step = _timed(torch, np, eng.step, acc, "prefill", finite)
    eng.decode_burst_step = _timed(torch, np, eng.decode_burst_step, acc,
                                   "decode", finite)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    del eng.step, eng.decode_burst_step
    if len(finite) != len(prompts) or not all(finite):
        fail(f"prefill logits not finite for every request ({finite})")
    for o in outs:
        if o.shape != (MAX_NEW,) or o.min() < 0 or o.max() >= cfg.vocab_size:
            fail(f"bad output {o}")
    n_prompt = sum(PROMPT_LENS)
    n_dec = len(prompts) * (MAX_NEW - 1)
    res = dict(prefill_tok_s=n_prompt / acc["prefill"],
               decode_tok_s=n_dec / acc["decode"],
               prefill_steps=acc["prefill_calls"],
               decode_bursts=acc["decode_calls"], wall_s=wall,
               launches=launches)
    print(f"phase 2: {len(prompts)} requests, {n_prompt} prompt tokens in "
          f"{acc['prefill']:.3f} s over {acc['prefill_calls']} steps "
          f"({res['prefill_tok_s']:.0f} tok/s); {n_dec} decode tokens in "
          f"{acc['decode']:.3f} s over {acc['decode_calls']} bursts "
          f"({res['decode_tok_s']:.0f} tok/s); launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the serving path")
    return eng, prompts, outs, res


def prefill_and_step(np, e, prompts, outs, bind=None):
    """The wave's prefill through put/step, then one decode step fed the
    served run's first tokens `outs[i][0]`: ({uid: first-token logits},
    {uid: second-token logits}).  `bind` ({uid: slot}) binds adapters
    first; every sequence is flushed at the end."""
    uids = list(range(len(prompts)))
    for u, slot in (bind or {}).items():
        e.set_adapter(u, slot)
    e.put(uids, prompts)
    while any(e.query(u) is None for u in uids):
        e.step()
    first = {u: e.query(u).copy() for u in uids}
    e.put(uids, [np.asarray([int(o[0])], np.int32) for o in outs])
    second = {u: e.query(u).copy() for u in uids}
    for u in uids:
        e.flush(u)
    return first, second


def logit_differences(np, got, want):
    """max |dlogit| / max |logit| for each request, first and second
    token: ([first-token values], [second-token values])."""
    rels = ([], [])
    for idx in (0, 1):
        for u in sorted(want[idx]):
            a, b = got[idx][u], want[idx][u]
            if not (np.isfinite(a).all() and np.isfinite(b).all()):
                fail(f"logits of request {u} not finite")
            rels[idx].append(float(np.abs(a - b).max() / np.abs(b).max()))
    return rels


def compare_plain(torch, np, eng, prompts, outs):
    """Prefill the wave and run one decode step through the kernels and
    through the plain versions; compare the logits.  Returns (the
    comparison, the kernel engine's logits)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    plain = InferenceEngineV2(eng.cfg, params=eng.params, config=eng.config,
                              device="cuda", plain_kernels=True)
    logits = {name: prefill_and_step(np, e, prompts, outs)
              for name, e in (("kernel", eng), ("plain", plain))}
    del plain
    worst, agree = 0.0, 0
    for which, idx in (("first-token", 0), ("second-token", 1)):
        rels = []
        for u in range(len(prompts)):
            a = logits["kernel"][idx][u]
            b = logits["plain"][idx][u]
            if not (np.isfinite(a).all() and np.isfinite(b).all()):
                fail(f"{which} logits of request {u} not finite")
            rel = float(np.abs(a - b).max() / np.abs(b).max())
            rels.append(rel)
            worst = max(worst, rel)
            if idx == 0:
                agree += int(a.argmax() == b.argmax())
                if int(a.argmax()) != int(outs[u][0]):
                    fail(f"request {u}: served first token {outs[u][0]} "
                         f"!= the rerun's argmax {a.argmax()}")
        print(f"  {which} max |dlogit| / max |logit| by request (prompt "
              f"lens {PROMPT_LENS}): {[float(f'{r:.3e}') for r in rels]}")
    rate = agree / len(prompts)
    print(f"phase 3: kernel vs plain engine logits: max |dlogit| / "
          f"max |logit| = {worst:.3e} (tol {E2E_REL_TOL}); greedy "
          f"first-token agreement {agree}/{len(prompts)} = {rate:.3f}")
    if worst > E2E_REL_TOL:
        fail(f"end-to-end logits differ by {worst} relative "
             f"(tol {E2E_REL_TOL})")
    return dict(e2e_max_rel_dlogit=worst, greedy_agreement=rate), \
        logits["kernel"]


def profile_wave(torch, eng, prompts, served_wall, counters):
    """Where the device time of the wave goes: torch.profiler over a rerun
    of the same wave, kernel time summed by kind.  The device's idle share
    is taken against the unprofiled run's wall time (phase 2), since the
    profiler slows the host but not the kernels."""
    launches = {}
    events = profiled(
        counted(counters, lambda: eng.generate_batch(
            prompts, max_new_tokens=MAX_NEW), launches),
        holds_launches(launches), what="kernels of the served wave")
    by_kind, by_name = {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(by_kind.values())
    if busy <= 0:
        fail("the profiler saw no device time in the served wave")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    res = dict(device_ms=busy, served_wall_ms=served_wall * 1e3,
               idle_share=max(0.0, 1 - busy / (served_wall * 1e3)),
               ms_by_kind=by_kind,
               top_kernels=[(n[:60], ms) for n, ms in top])
    print(f"phase 4: wave device time {busy:.1f} ms of {served_wall * 1e3:.1f}"
          f" ms wall (idle share {res['idle_share']:.3f}); by kind (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
              by_kind.items(), key=lambda kv: -kv[1])))
    for n, ms in res["top_kernels"]:
        print(f"  {ms:8.2f} ms  {n}")
    return res


# ----------------------------------------------------------------------
# phases 8 and 9: multi-tenant LoRA serving and the merged arena
# ----------------------------------------------------------------------
def lora_factors(np, cfg, seed=8):
    """LORA_ADAPTERS rank-LORA_RANK adapters over the attention output,
    {"t<i>": (a [L, K, r] ~ N(0, 1/K), b [L, r, H] ~ N(0, 1/r))}, f32,
    from a seed."""
    rng = np.random.default_rng(seed)
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size
    r = LORA_RANK
    return {f"t{i}": (rng.standard_normal((L, K, r), np.float32)
                      / np.float32(K ** 0.5),
                      rng.standard_normal((L, r, H), np.float32)
                      / np.float32(r ** 0.5))
            for i in range(LORA_ADAPTERS)}


def count_serving_calls(calls):
    """Count the engine's serving calls — each `prefill_chunks` and each
    decode step's `_decode_core` — and those that carry adapter rows
    (`lora` given), into `calls`.  Returns a function that restores
    them."""
    from deepspeed_tpu_torch.inference.v2 import engine_v2, ragged_ops
    saved = [(engine_v2, "prefill_chunks", engine_v2.prefill_chunks),
             (ragged_ops, "_decode_core", ragged_ops._decode_core)]

    def wrap(fn):
        def counted_call(*args, **kw):
            calls["all"] += 1
            calls["with_adapters"] += kw.get("lora") is not None
            return fn(*args, **kw)
        return counted_call

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn))

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return restore


def recorded_wave(eng, prompts):
    """generate_batch over the wave, recording each request's first
    prefill logits: (outputs, {uid: logits})."""
    logits = {}
    step = eng.step

    def recording_step(*args, **kw):
        out = step(*args, **kw)
        for uid, row in out.items():
            logits.setdefault(uid, row.copy())
        return out

    eng.step = recording_step
    try:
        outs = eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
    finally:
        del eng.step
    return outs, logits


def serve_tenants(torch, np, cfg, params, config, prompts, counters, lm):
    """Phase 8 (see the module docstring)."""
    from dataclasses import replace
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.serving.tenancy import AdapterPool
    # both arms plan the same chunks: adapter rows never take prefill_full
    ecfg = replace(config, full_prompt_prefill=False)
    eng = InferenceEngineV2(cfg, params=params, config=ecfg, device="cuda")
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size

    def timed_wave():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, logits = recorded_wave(eng, prompts)
        torch.cuda.synchronize()
        return outs, logits, time.perf_counter() - t0

    for c in counters:
        c.launches = 0
    outs_a, logits_a, wall_a = timed_wave()
    launches_a = {c.__name__: c.launches for c in counters}

    t0 = time.perf_counter()
    factors = lora_factors(np, cfg)
    per_adapter = L * -(-(K * LORA_RANK + LORA_RANK * H)
                        // LORA_BLOCK_ELEMS)
    pool = AdapterPool(eng, LORA_SLOTS * per_adapter,
                       block_elems=LORA_BLOCK_ELEMS,
                       host_blocks=2 * per_adapter)
    for aid, (a, b) in factors.items():
        pool.register(aid, a, b)
    slots = {u: pool.reserve(aid) for u, aid in LORA_PLAN.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"phase 8: {LORA_ADAPTERS} rank-{LORA_RANK} adapters (a ~ N(0, "
          f"1/K), b ~ N(0, 1/r), f32) through a {pool.slots}-slot pool "
          f"({per_adapter} blocks an adapter, host tier "
          f"{pool.host_blocks}): demotes {pool.demotes}, promotes "
          f"{pool.promotes}; rows {sorted(LORA_PLAN)} bound to "
          f"{[LORA_PLAN[u] for u in sorted(LORA_PLAN)]} in slots "
          f"{[slots[u] for u in sorted(LORA_PLAN)]}; set-up {setup_s:.1f} s")
    if pool.demotes < 1 or pool.promotes < 1:
        fail(f"the pool made {pool.demotes} demotes and {pool.promotes} "
             f"promotes; want at least one of each")

    calls = {"all": 0, "with_adapters": 0}
    restore = count_serving_calls(calls)
    try:
        for u, slot in slots.items():
            eng.set_adapter(u, slot)
        for c in counters:
            c.launches = 0
        outs_b, logits_b, wall = timed_wave()
    finally:
        restore()
    launches = {c.__name__: c.launches for c in counters}
    # arm A again, the pool attached but no row bound: the walls in turns
    outs_a2, _, wall_a2 = timed_wave()
    if [o.tolist() for o in outs_a2] != [o.tolist() for o in outs_a]:
        fail("arm A's rerun (pool attached, no binding) changed tokens")
    base = [i for i in range(len(prompts)) if i not in LORA_PLAN]
    same_tokens = [outs_b[i].tolist() == outs_a[i].tolist() for i in base]
    same_logits = [torch.equal(torch.from_numpy(logits_b[i]),
                               torch.from_numpy(logits_a[i])) for i in base]
    moved = [outs_b[u].tolist() != outs_a[u].tolist() for u in LORA_PLAN]
    want = L * calls["with_adapters"]
    print(f"phase 8: arm A (no pool) in {wall_a:.3f} s, launches "
          f"{launches_a}; arm B in {wall:.3f} s, launches {launches}; arm "
          f"A again (pool attached, nothing bound) in {wall_a2:.3f} s; "
          f"serving calls "
          f"{calls['all']} ({calls['with_adapters']} with adapter rows: "
          f"want {want} LoRA launches); base rows {base}: tokens equal "
          f"{same_tokens}, prefill logits equal {same_logits}; adapter "
          f"rows' chains differ from arm A: {moved}")
    if launches_a.get("lora_delta", 0) != 0:
        fail("arm A (no adapters) launched the LoRA kernel")
    if not (all(same_tokens) and all(same_logits)):
        fail("base rows differ between the arms")
    if not all(moved):
        fail("an adapter row gave the base model's chain")
    if calls["with_adapters"] == 0 or launches["lora_delta"] != want:
        fail(f"lora_delta launched {launches['lora_delta']} times, want "
             f"{L} per serving call with adapter rows ({want})")
    for name, n in launches.items():
        if n <= 0 and name != "flash_attention_fwd":
            fail(f"kernel {name} was never launched in arm B")

    # arm B's prefill and one decode step against the plain versions,
    # the same adapter stacks attached to both engines
    plain = InferenceEngineV2(cfg, params=params, config=ecfg,
                              device="cuda", plain_kernels=True)
    plain.attach_lora(eng._lora)
    got = prefill_and_step(np, eng, prompts, outs_b, bind=slots)
    before = lm.lora_delta.launches
    want_logits = prefill_and_step(np, plain, prompts, outs_b, bind=slots)
    if lm.lora_delta.launches != before:
        fail("the plain_kernels engine launched the LoRA kernel")
    del plain
    torch.cuda.empty_cache()
    rels = logit_differences(np, got, want_logits)
    worst = max(max(r) for r in rels)
    print(f"phase 8: kernel vs plain engine, adapters bound: max |dlogit| "
          f"/ max |logit| by request, first token "
          f"{[float(f'{r:.3e}') for r in rels[0]]}, second token "
          f"{[float(f'{r:.3e}') for r in rels[1]]} (tol {E2E_REL_TOL})")
    if worst > E2E_REL_TOL:
        fail(f"multi-tenant logits differ by {worst} relative")

    # the device time of arm B's wave by kind, the LoRA kernel's share
    prof_launches = {}

    def body():
        for u, slot in slots.items():
            eng.set_adapter(u, slot)
        eng.generate_batch(prompts, max_new_tokens=MAX_NEW)

    events = profiled(counted(counters, body, prof_launches),
                      holds_launches(prof_launches),
                      what="kernels of the multi-tenant wave")
    by_kind = {}
    for e in events:
        by_kind[_kind(e.name)] = (by_kind.get(_kind(e.name), 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_kind.values())
    lora_ms = by_kind.get("lora_delta", 0.0)
    print(f"phase 8: profiled arm B: device time {busy:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall (idle share "
          f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}); LoRA kernel "
          f"{lora_ms:.2f} ms over {prof_launches['lora_delta']} launches "
          f"({lora_ms / busy:.4f} of device time); by kind (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
              by_kind.items(), key=lambda kv: -kv[1])))

    for aid in LORA_PLAN.values():
        pool.release(aid)
    audit = pool.audit()
    blocks = eng.audit_blocks()
    if pool._pins or eng._adapter_slots:
        fail(f"pins {pool._pins} or bindings {eng._adapter_slots} remain")
    print(f"phase 8: pool audit {audit}; engine audit {blocks}; pool "
          f"{pool.stats()}")
    res = dict(wall_s=wall, wall_arm_a_s=[wall_a, wall_a2],
               launches=launches,
               launches_arm_a=launches_a,
               serving_calls=calls, e2e_rel_dlogit=rels,
               e2e_max_rel_dlogit=worst, device_ms=busy,
               idle_share=max(0.0, 1 - busy / (wall * 1e3)),
               ms_by_kind=by_kind, lora_ms=lora_ms,
               lora_share=lora_ms / busy, pool=pool.stats(),
               pool_audit=audit)
    del eng, pool
    torch.cuda.empty_cache()
    return res


def serve_merged(torch, np, cfg, params, config, prompts, outs, logits,
                 counters):
    """Phase 9: phase 2's wave on a merged-arena engine sharing the
    parameters; tokens and phase-3 logits must equal the 5-D engine's."""
    from dataclasses import replace
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    eng = InferenceEngineV2(cfg, params=params,
                            config=replace(config, arena_merged=True),
                            device="cuda")
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    first, second = prefill_and_step(np, eng, prompts, outs)
    same_tokens = [g.tolist() == o.tolist() for g, o in zip(got, outs)]
    same_logits = [torch.equal(torch.from_numpy(a[u]),
                               torch.from_numpy(b[u]))
                   for a, b in ((first, logits[0]), (second, logits[1]))
                   for u in sorted(b)]
    eng.audit_blocks()
    print(f"phase 9: merged arena {tuple(eng.arena['k'].shape)} x2: wave "
          f"in {wall:.3f} s, launches {launches}; tokens equal the 5-D "
          f"engine's: {same_tokens}; first- and second-token logits "
          f"equal: {same_logits}")
    if eng.arena["k"].dim() != 4:
        fail("arena_merged=True did not give a 4-D arena")
    if not (all(same_tokens) and all(same_logits)):
        fail("the merged-arena wave differs from the 5-D engine's")
    if (launches["merged_decode_attention"] <= 0
            or launches["merged_prefill_attention"] <= 0):
        fail(f"a merged wrapper was never launched: {launches}")
    if launches["paged_decode_attention"] or \
            launches["paged_prefill_attention"]:
        fail(f"the merged engine went through the 5-D wrappers: "
             f"{launches}")
    del eng
    torch.cuda.empty_cache()
    return dict(wall_s=wall, launches=launches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="serving model depth (Llama-2-7B has 32)")
    ap.add_argument("--train-layers", type=int, default=24,
                    help="training model depth (GPT-2-1.3B has 24)")
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory for the run's JSON record, relative to "
                         "this script's directory")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on the card)")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deepspeed_tpu_torch")):
        fail(f"no deepspeed_tpu_torch package beside {__file__}")
    sys.path.insert(0, root)
    import numpy as np
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import lora_matmul as lm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_merged as pm
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 and round once, as the JAX `_dense`
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # phase 0
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"phase 0: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name in _build.KERNELS:
        log = _build.library_path(name).with_name(f"{name}.ptxas.txt")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Function properties for" in line:
                    print(f"  {name}: {line.split('for ')[-1][:90]}")
                elif "registers" in line or "spill" in line:
                    print(f"  {name}:   {line.strip()}")

    # phase 1
    print(f"phase 1: kernels against their plain versions (forward bf16 "
          f"tol {TOL_TEXT}; backward tol {BWD_TOL_TEXT}; LoRA tol "
          f"{LORA_REL} max|plain|)")
    kernels = [check_flash(torch, fa, "cuda"),
               *check_flash_bwd(torch, fa, "cuda"),
               check_decode(torch, np, pa, "cuda"),
               check_prefill(torch, np, pp, "cuda"),
               check_lora(torch, np, lm, "cuda"),
               *check_merged(torch, np, pa, pp, pm, "cuda")]

    # phase 2
    serve_counters = [fa.flash_attention_fwd, pa.paged_decode_attention,
                      pp.paged_prefill_attention]
    eng, prompts, outs, served = serve(torch, np, args.layers,
                                       serve_counters)

    # phase 3
    e2e, kernel_logits = compare_plain(torch, np, eng, prompts, outs)

    # phase 4
    prof = profile_wave(torch, eng, prompts, served["wall_s"],
                        serve_counters)
    cfg, params, config = eng.cfg, eng.params, eng.config
    del eng
    torch.cuda.empty_cache()

    # phase 8 (phase 2's parameters, before the training phases)
    tenants = serve_tenants(torch, np, cfg, params, config, prompts,
                            serve_counters + [lm.lora_delta], lm)

    # phase 9
    merged = serve_merged(
        torch, np, cfg, params, config, prompts, outs, kernel_logits,
        [pm.merged_decode_attention, pm.merged_prefill_attention,
         pa.paged_decode_attention, pp.paged_prefill_attention,
         fa.flash_attention_fwd])
    del params
    torch.cuda.empty_cache()

    # phase 5
    train_counters = [fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                      fa.flash_attention_bwd_dkv]
    teng, batch, trained = train(torch, np, args.train_layers,
                                 train_counters)

    # phase 7 (on phase 5's engine, before it is freed)
    tprof = profile_train_step(torch, teng, batch, trained["step_ms"],
                               train_counters)
    del teng
    torch.cuda.empty_cache()

    # phase 6
    plain = plain_train_run(torch, np, args.train_layers, train_counters)
    tplain = compare_train_plain(
        (trained["warmup_losses"], trained["warmup_grad_norms"],
         trained["warmup_attn_grad_norms"]), plain)
    control = control_fault(torch, np, fa, args.train_layers,
                            train_counters, plain)
    remat = remat_launches(torch, np, args.train_layers, train_counters,
                           trained["warmup_losses"][0])

    # each path's run: the serving wave (phase 2), the training steps
    # (phase 5), arm B of the multi-tenant wave (phase 8), the merged
    # wave (phase 9)
    paths = (("serve", served["launches"]), ("train", trained["launches"]),
             ("tenants", tenants["launches"]), ("merged", merged["launches"]))
    for k in kernels:
        fn = WRAPPERS[k["name"]]
        by_path = {path: launches[fn] for path, launches in paths
                   if fn in launches}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path

    record = dict(kernels=kernels, serve=served, e2e=e2e, profile=prof,
                  tenants=tenants, merged=merged,
                  train=trained, train_profile=tprof, train_plain=tplain,
                  train_control=control, remat=remat,
                  device=dict(kind=kind, nvidia_smi=smi,
                              layers=args.layers,
                              train_layers=args.train_layers))
    os.makedirs(os.path.join(root, args.out), exist_ok=True)
    with open(os.path.join(root, args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
