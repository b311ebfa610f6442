#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one NVIDIA card
(or N with `--tp N`).

    python3 chip_smoke.py [--layers N] [--train-layers N] [--out DIR]
    python3 chip_smoke.py --tp N [--layers N] [--out DIR]      (N cards)

Phases (any failure exits non-zero and prints no result):
  0. report the card (name, power limit) and build the CUDA kernels from
     `deepspeed_tpu_torch/csrc` (one nvcc per source, all in parallel);
  1. hold each kernel against its plain PyTorch version on the card, at
     the serving and training paths' shapes and at edge cases (GQA,
     ragged lengths, head dims 32/64/128, f32), and time both (device time
     from torch.profiler; CUDA events where its sessions keep missing
     device events, as each row's `clocks` says) beside the card's bound
     for the same work;
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
     the flash forward, delta, dq and dk/dv launches (one each per layer
     per step under save_attn; every dq and dk/dv launch on the TMA +
     wgmma kernels, by their launches per variant);
  6. the same initial state and batch through `plain_kernels=True` for 3
     steps, against the kernel engine's warm-up steps (loss and grad
     norm, and at step 1 each layer's attention gradient norms); a control
     run with a known fault in the plain backward, which these checks
     must refuse; one step under nothing_saveable (2 flash forward
     launches per layer, the same loss);
  7. profile one training step: device time by kind (matmuls, the four
     attention kernels, the optimizer's update, other) and the idle share;
  8. (run after phase 4, on phase 2's parameters) the multi-tenant wave:
     phase 2's 8 requests on an engine with chunked prefill only, first
     without adapters (arm A), then through an `AdapterPool` of 4 slots
     holding 5 rank-16 adapters with a host tier (a demote and a promote
     on the card), rows 1, 3 and 5 bound to three adapters and row 7 to
     row 1's (arm B, counters reset just before it): base rows must give
     arm A's tokens and prefill logits exactly, adapter rows other
     chains, the LoRA kernel 32 launches per serving call with adapter
     rows, every one on the fused kernel (`launches_by_variant`), and the
     wave's LoRA device ms; arm B's prefill and one decode step against the plain-version
     engine with the same stacks; a profiled rerun of arm B; pool and
     engine audits clean;
  9. phase 2's wave on an engine with the merged [L, nb, bs, NKV*D] arena
     sharing the parameters: tokens and phase-3 logits equal to the 5-D
     engine's, through the merged wrappers only;
 10. (run after phase 9) block-sparse attention: `SparseSelfAttention`
     forward and backward (loss = sum of squares) over q/k/v [4, 4096, 16,
     64] bf16 (BERT-large heads at 4096 tokens) for three layouts
     (DeepSpeed's "fixed" config at block 16, BigBird at block 64, causal
     "fixed" at block 64): out and
     the three gradients against the plain versions, one launch of each
     kernel per call (counters reset just before; the delta kernel only
     where the backward takes the wgmma pair), dq and dk/dv on the pair
     `bwd_variant` names (launches by variant; the plan's walks and
     padding factors), density, ms of forward
     and backward (CUDA events: most of this phase's profiler sessions
     come back without device events) against their bound, against SDPA
     with the dense mask and, for the causal layout, against the dense
     flash kernels; the host time of one call (the tables and the
     kernels' plan are cached on the module); the forward on the kernel
     `fwd_variant` names (TMA + wgmma at bf16 D 64/128, block 16/32/64;
     launches by variant); then the pair gate: over 16 layouts at blocks
     16 and 32 (the port's sparsity configs and scattered random
     layouts), both bf16 backward pairs' and both bf16 forward kernels'
     device time from CUDA graphs in the same call, failing where a
     routed kernel is more than 1.25x slower than the other;
 11. (run after phase 10, before phase 5) bench.py's training step with
     8-bit Adam moments and the fused update (`state_dtype "int8"`,
     `fused_update: true`): phase 5's readings, one fused_adam8 launch per
     leaf per step, a profiled step (the update's device ms against its
     bound; phase 7 prints it beside the int8f update's), then the same initial
     state through the plain int8 update for 3 steps (step 1 equal, steps
     2-3 within INT8_LATER_RTOL), and two control runs of the fused engine
     with a planted fault, which these checks must refuse.
 12. (run after phase 10, before phase 11) Evoformer attention:
     `evoformer_attention` forward and backward (loss = sum of squares) at
     AlphaFold 2's MSA row [1, 128, 256, 8, 32], triangle [1, 256, 256, 4,
     32] and extra-MSA row [1, 1024, 256, 8, 8] attention (q/k/v [B, N, L,
     H, D] bf16), with a f32 mask bias (15% of keys at -1e9) and a bf16
     pair bias that requires grad (the mask bias too at the MSA row): one
     launch of each kernel per call (counters reset just before; the db1
     epilogue only where the mask bias requires grad), every kernel on the
     variant its rule names (`fwd_variant`, `bwd_variant`, `db2_variant`:
     TMA + wgmma at D 32, mma.sync at the extra-MSA row's D 8; launches by
     variant), a rerun bit-identical, out and every gradient against the
     plain versions, forward and backward ms and each backward kernel's
     (dq, dk/dv, db2) against their bounds and against SDPA with the
     summed bias as a dense float mask; then the gate: the routed forward
     and db2 against the first kernels (`variant="mma"`), CUDA graphs in
     turns in this call, failing where a routed kernel takes more than
     EVO_GATE (1.05) times the first.
Every profile must hold each launch the kernels' counters saw in it (a
session that dropped device events is repeated).  The bf16 paged prefill
and decode run on their TMA kernels (`variant` "tma"): phase 1 holds them
over block sizes 16-128, groups 1-8, head dims 32-128, windows, ragged
lens and chunks, reruns bit-identical, beside the mma.sync kernels they
replaced (timed in the same call); phases 2-4, 8, 9 and 13 fail on a
paged launch off "tma".
Phase 1 also holds the gather-LoRA kernel (the fused one-launch kernel
and the two-pass kernel it replaced, in the same call: the wave's decode,
prefill and 2048-row shapes, ranks 1-128, K off the 16-byte grain, one
row, f32 rows, NaN in base rows' x; reruns bit-identical), the fused
8-bit Adam kernel (one w_up layer's slice), the block-sparse forward,
delta, dq and dk/dv kernels (at phase 10's first layout, each timed
beside its mma.sync kernel, and at edge cases: the wgmma kernels at
blocks 16, 32 and 64, D 64 and 128, causal and not, a fully-masked row,
lists that end mid-step, ragged forward groups, NaN in key and value
blocks no row visits, over every walk the plan can take, the forward
against the mma.sync kernel; f32, block 8 and 128, head dims 192 and
256; reruns bit-identical), the
four Evoformer kernels (at phase 12's MSA row shape, D 8, 64 and 128, f32,
L 100 with a fully masked row, each bias alone and none, each case's
kernels on the variants the rules name, and at every bf16 case the
first forward and db2 kernels against the plain versions too and phase
12's gate of the forward and db2 against the first kernels; the main
shape's forward and db2 timed beside the first kernels; a mask bias view
off the 16-byte boundary through `evoformer_attention`, and B*N = 70000
rows past the grid limit) and the tile GEMM of the tensor-parallel
ring (at every per-hop shape of phase 13's wave at tp 2 and 4, bf16 and
f32, and at edges: M 1, K 2752, N 1001, a misaligned view, M tiles past
the grid limit; each case prints the kernel `tile_plan` gave it, and a
bf16 hop that ran neither the split-K TMA stream nor the wgmma kernel
fails) against their plain versions, times the tile GEMM's decode hops
warm and with the L2 flushed before each call, and the flash forward
beside SDPA at the training shape too; the flash backward's delta, dq
and dk/dv kernels (every bf16 case on the TMA + wgmma pair, reruns
bit-identical) beside SDPA's backward and the mma.sync kernels' times
they replaced.
 13. (only with `--tp N`, N in 2, 4, on N cards: the one-card run says
     so and skips it) tensor-parallel serving over the fused ring: phase
     0, phase 1's tile GEMM rows, then phase 2's wave on Llama-2-7B
     widths at tp 1 on one card and at tp 2 (and 4) with one NCCL rank a
     card (`comm.spawn_ranks`, the kernels built once, here), each rank
     building `build_engine("llama", "7b", engine_config=...(tensor_
     parallel_size=N, tp_collectives="fused"))` from the same seed: tile
     GEMM launches (7 L per prefill call + 7 L + 1 per decode step, times
     N), every one on a TMA kernel (launches by kernel), the paged
     kernels' launches as at tp 1, no plain version;
     logits within phase 3's limit of tp 1's (greedy tokens reported);
     the same at f32 and 2 layers with tokens identical and logits within
     TP_STRICT_ATOL; rank 0's profiled decode step (device ms by kind,
     idle share, NCCL send/recv time under a tile GEMM); prefill tokens/s
     and decode ms per step beside tp 1's.
Prints a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  `--layers` cuts the serving models'
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
# phase 1's LoRA cases, (S, K, N, r, slots, x dtype; None: bf16 rows all
# base): the timed shapes first (prefill, decode, 2048 rows), then ranks
# 1, 128 and 40, K not a multiple of 8 and N not of 4, one row, f32 rows
LORA_CASES = [(512, 4096, 4096, 16, 4, "bfloat16"),
              (32, 4096, 4096, 16, 4, "bfloat16"),
              (2048, 4096, 4096, 16, 4, "bfloat16"),
              (512, 4096, 4096, 1, 4, "bfloat16"),
              (512, 4096, 4096, 128, 4, "bfloat16"),
              (77, 1000, 777, 16, 3, "bfloat16"),
              (45, 1003, 1001, 40, 4, "bfloat16"),
              (1, 4096, 4096, 16, 4, "bfloat16"),
              (64, 4096, 4096, 16, 4, "float32"),
              (48, 4096, 4096, 16, 4, None)]

# fused 8-bit Adam kernel vs its plain version: the kernel keeps the plain
# version's operation order with IEEE roundings and no FMA contraction, so
# only the last bit of exp2f/log2f may differ: master |d| <= ADAM8_RTOL
# |plain| + ADAM8_ATOL, codes within one (the share that differ printed),
# scales relative ADAM8_RTOL
ADAM8_RTOL, ADAM8_ATOL = 1e-6, 1e-7
ADAM8_SHAPE = (2048, 8192)     # one layer's slice of GPT-2-1.3B's w_up
ADAM8_KW = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.1, adam_w=True)
# f32 operations per element of the update: decode 5, gradient scale 1,
# moments 7, step 9, requantize 13
ADAM8_OPS = 35
# phase 11: bench.py's optimizer with 8-bit moments and the fused update
INT8_PARAMS = {"lr": 1e-4, "weight_decay": 0.1, "state_dtype": "int8",
               "fused_update": True}
# the fused-update engine vs the plain int8 update at steps 2-3, relative.
# Both run the same attention kernels and differ only in the update, whose
# codes may differ by one where exp2f/log2f's last bit does (one element's
# moment moves by one code step), and whose f32 operations the kernel
# orders as the plain version does.  On an H100 they measured 7.4e-6 and
# 8.0e-5 (loss, steps 2 and 3) and 1.1e-4 and 2.4e-3 (grad norm, at step
# 3's spike of 27); the limits sit about 6x and 8x above the largest.
# Two control runs of the fused engine (the bf16 parameters left stale, as
# if the cast went into a copy; bias correction dropped) must be refused.
INT8_LATER_RTOL = {"loss": 5e-4, "grad_norm": 2e-2}
# phase 10: BERT-large's 16 heads of 64 at 4096 tokens, batch 4
SPARSE_SHAPE = (4, 4096, 16, 64)
# phase 12: AlphaFold 2's Evoformer attention at its training crop
# (Jumper et al. 2021, Supplementary Algorithms 7, 13-14 and 19; OpenFold's
# training preset): (name, q/k/v [B, N, L, H, D], whether the mask bias
# requires grad).  Every shape carries a f32 mask bias with EVO_MASKED of
# its keys at -1e9 and a bf16 pair bias that requires grad.
EVO_SHAPES = [("msa_row", (1, 128, 256, 8, 32), True),
              ("triangle", (1, 256, 256, 4, 32), False),
              ("extra_msa_row", (1, 1024, 256, 8, 8), False)]
EVO_MASKED = 0.15

# each kernel as the profiler names it -> (its wrapper, whose `launches`
# counts the wrapper's calls; the device kernels one call runs, or by the
# variant the call took: {variant: kernels})
KERNELS = {"flash_fwd": ("flash_attention_fwd", 1),
           "flash_bwd_delta": ("flash_attention_bwd_delta", 1),
           "flash_bwd_dq": ("flash_attention_bwd_dq", 1),
           "flash_bwd_dkv": ("flash_attention_bwd_dkv", 1),
           # the TMA kernel merges its splits itself; mma and f32 + combine
           "paged_decode": ("paged_decode_attention",
                            {"tma": 1, "mma": 2, "f32": 2}),
           "paged_prefill": ("paged_prefill_attention", 1),
           # the fused kernel is one launch; the two-pass one shrink +
           # expand
           "lora_delta": ("lora_delta", {"fused": 1, "two_pass": 2}),
           "fused_adam8": ("fused_adam8_leaf", 1),
           "sparse_fwd": ("block_sparse_flash_attention", 1),
           "sparse_dq": ("block_sparse_flash_dq", 1),
           "sparse_dkv": ("block_sparse_flash_dkv", 1),
           "sparse_bwd_delta": ("block_sparse_flash_bwd_delta", 1),
           "evo_fwd": ("evoformer_flash_forward", 1),
           "evo_dq": ("evoformer_flash_dq", 1),
           "evo_dkv": ("evoformer_flash_dkv", 1),
           "evo_db2": ("evoformer_flash_db2", 1),
           "tile_matmul": ("tile_matmul", 1)}
# each row of the kernels line -> the wrapper whose counter it reads (the
# merged wrappers launch the paged kernels on a view of their arena; the
# TPU's D-major Evoformer forward is the same kernel as its forward, and
# its db1 kernel the dk/dv kernel's epilogue, counted where it ran)
WRAPPERS = {**{k: fn for k, (fn, _) in KERNELS.items()},
            "merged_decode": "merged_decode_attention",
            "merged_prefill": "merged_prefill_attention",
            "evo_fwd_dmajor": "evoformer_flash_forward",
            "evo_db1": "evoformer_flash_db1"}


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


PROFILE_TRIES = 5


class Timing(float):
    """A time in ms with the clock that took it: "profiler" (the summed
    device durations of the kernels, `time_ms`) or "cuda_events" (events
    around a loop of calls, host gaps between launches counted,
    `event_time_ms`)."""

    def __new__(cls, ms, clock):
        t = super().__new__(cls, ms)
        t.clock = clock
        return t


def timing_less(a, b):
    """a - b as a Timing; its clock names both clocks where they differ."""
    return Timing(a - b, a.clock if a.clock == b.clock
                  else f"{a.clock} - {b.clock}")


def clocks(row):
    """{key: clock} of each time in a row of the kernels line."""
    return {k: v.clock for k, v in row.items() if isinstance(v, Timing)}


def _kind(name):
    """The kind of a device kernel: one of the port's (they live in
    anonymous namespaces of csrc/*.cu), a cuBLAS matmul, or other."""
    for kernel in KERNELS:
        if f"(anonymous namespace)::{kernel}" in name:
            return kernel
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profile_session(body):
    """The device events of one torch.profiler session around `body()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    return device_events(prof)


def profiled(body, complete=bool, what="device events"):
    """The device events of `body()` under torch.profiler.  A session
    can come back with device events missing (seen on the H100 machine:
    none at all, or a quarter of a timing loop's kernels), so a session
    whose events are not `complete(events)` is repeated, up to
    PROFILE_TRIES times, before the run fails."""
    for i in range(PROFILE_TRIES):
        events = profile_session(body)
        if complete(events):
            return events
        print(f"  (profiler session {i + 1} missed {what}: repeated)")
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
            kinds.get(kernel, 0) == device_launches(fn, per, launches)
            for kernel, (fn, per) in KERNELS.items() if fn in launches)
    return complete


def device_launches(fn, per, launches):
    """The device kernels that `launches[fn]` wrapper calls ran: `per`
    each, or by variant from `launches[fn + "/" + variant]`."""
    if isinstance(per, dict):
        return sum(n * launches.get(f"{fn}/{v}", 0) for v, n in per.items())
    return per * launches[fn]


def reset_counts(counters):
    """Set each wrapper's launch count (and its counts per kernel
    variant, where it keeps them) to 0."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "launches_by_variant"):
            c.launches_by_variant = dict.fromkeys(c.launches_by_variant, 0)


def by_variant(counters):
    """{wrapper: {variant: launches}} of the wrappers that count them."""
    return {c.__name__: dict(c.launches_by_variant) for c in counters
            if hasattr(c, "launches_by_variant")}


def counted(counters, body, launches):
    """`body` with the counters set to 0 before it and read into
    `launches` after it (with each variant's count as
    `launches[name + "/" + variant]`)."""
    def run():
        reset_counts(counters)
        body()
        launches.update({c.__name__: c.launches for c in counters})
        for name, by in by_variant(counters).items():
            launches.update({f"{name}/{v}": n for v, n in by.items()})
    return run


PAGED_WRAPPERS = ("paged_decode_attention", "paged_prefill_attention",
                  "merged_decode_attention", "merged_prefill_attention")


def paged_on_tma(counters, where):
    """Fail where a paged wrapper among `counters` ran a bf16 call off the
    TMA kernels since its counts were reset (the engines' shapes are bf16
    at D 128 and block size 64: the rule names "tma")."""
    for c in counters:
        if c.__name__ not in PAGED_WRAPPERS:
            continue
        off = {v: n for v, n in c.launches_by_variant.items()
               if v != "tma" and n}
        if off or c.launches_by_variant["tma"] != c.launches:
            fail(f"{where}: {c.__name__} launched {dict(c.launches_by_variant)}"
                 f" of {c.launches} calls: every bf16 paged call must take "
                 f"the TMA kernel")


def time_ms(fn, iters=20, warmup=3):
    """Device time of one call of `fn`: the summed durations of the
    kernels it launches over `iters` calls (torch.profiler), divided by
    `iters`.  Host gaps between launches are left out, which CUDA events
    around a call of a few tens of microseconds would count; the inputs
    stay warm in the 50 MB L2 from call to call.  A try profiles one call
    and then the loop, and holds when the loop's events are `iters` times
    the call's (a session that dropped events, in either, fails it).
    After PROFILE_TRIES tries that miss, the time is taken with CUDA
    events (`event_time_ms`) and its clock says so."""
    for _ in range(warmup):
        fn()

    def body():
        for _ in range(iters):
            fn()

    for _ in range(PROFILE_TRIES):
        per_call = len(profile_session(fn))
        events = profile_session(body)
        us = sum(e.time_range.elapsed_us() for e in events)
        if per_call and len(events) == iters * per_call and us > 0:
            return Timing(us / 1e3 / iters, "profiler")
    print(f"  (the profiler missed device events in {PROFILE_TRIES} tries, "
          f"the last {len(events)} for {iters} x {per_call}: timed with "
          f"CUDA events)")
    return event_time_ms(fn, iters, warmup=0)


def event_time_ms(fn, iters=20, warmup=3):
    """Time of one call of `fn` from CUDA events around `iters` calls.
    Host gaps between the launches are counted, so it reads high for
    calls of tens of microseconds; phase 10 times its calls (0.4 ms and
    more) with it, as most of its profiler sessions came back without
    device events on the H100 machine, and `time_ms` falls back to it."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return Timing(start.elapsed_time(end) / iters, "cuda_events")


def graph_time_ms(fn, iters=20, replays=5):
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph (after warm-up calls on a side stream), replayed `replays` times
    between two CUDA events.  No host gaps and no profiler: for calls of
    tens of microseconds that host overhead would hide, as in phase 10's
    pair gate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return Timing(ms, "cuda_graph")


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
    # the training path's shape: kernel time beside its bound and SDPA's
    tq, tk, tv = _qkv(torch, g, dev, *TRAIN_ATTN)
    train_ms = time_ms(lambda: fa.flash_attention_fwd(tq, tk, tv))
    train_bound = bound_ms(*_flash_fwd_work(*TRAIN_ATTN))[0]
    tqt, tkt, tvt = (t.transpose(1, 2).contiguous() for t in (tq, tk, tv))
    train_lib = time_ms(lambda: F.scaled_dot_product_attention(
        tqt, tkt, tvt, is_causal=True))
    print(f"  flash_fwd at the training shape: {train_ms:.4f} ms (bound "
          f"{train_bound:.4f} ms, SDPA forward {train_lib:.4f} ms)")
    return dict(name="flash_fwd", route="cuda",
                source="deepspeed_tpu_torch/csrc/flash_fwd.cu",
                replaces="deepspeed_tpu/ops/flash_attention.py:272",
                shape=f"q [{B},{S},{NH},{D}] k/v [{B},{S},{NKV},{D}] bf16",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
                train_shape="q/k/v [{},{},{},{}] bf16".format(
                    *TRAIN_ATTN[:3], TRAIN_ATTN[4]),
                train_ms=train_ms, train_bound_ms=train_bound,
                train_library_ms=train_lib)


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
    """The paged decode kernels: every case on the variant the rule names
    (TMA at every bf16 case here) against the plain version, rerun bit
    for bit, the mma.sync pair beside it; timed at the main shape, with
    the mma.sync pair (the kernels the TMA kernel replaced) in the same
    call."""
    rng = np.random.RandomState(2)
    g = torch.Generator(device=dev).manual_seed(2)
    L, nb = 2, 256
    errs, main = [], None
    # (NH, NKV, D, bs, lens): main shape first — B=8 at mixed lens up to
    # ~1500; then GQA 4 and 8, D 32 and 64, block sizes 16, 32, 128 with
    # lens -1, 0, bs - 1, bs
    cases = [(32, 32, 128, 64, [36, 63, 95, 127, 199, 310, 499, 1499]),
             (32, 8, 128, 64, [5, -1, 700, 64, 1, -3, 1200, 0]),
             (8, 2, 32, 64, [40, -1, 300, 0]),
             (8, 2, 64, 16, [-1, 0, 15, 16, 700, 333]),
             (32, 4, 128, 128, [-1, 0, 127, 128, 1499, 900]),
             (16, 2, 32, 32, [-1, 0, 31, 32, 1000, 2047])]
    for NH, NKV, D, bs, lens_l in cases:
        B, MB = len(lens_l), 2048 // bs
        ak, av = _arena(torch, g, dev, L, nb, bs, NKV, D)
        q = torch.randn(B, NH, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        lens_np = np.asarray(lens_l, np.int32)
        tables = torch.from_numpy(_garbage_tables(
            np, rng, B, MB, nb, bs, lens_np)).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        args = (q, ak, av, tables, lens)
        variant = pa.decode_variant(q.dtype, D, bs, NH // NKV)
        out = pa.paged_decode_attention(*args, layer_idx=1)
        again = pa.paged_decode_attention(*args, layer_idx=1)
        old = pa.paged_decode_attention(*args, layer_idx=1, variant="mma")
        ref = pa.paged_decode_reference(*args, layer_idx=1)
        torch.cuda.synchronize()
        e, e_old = max_err(out, ref), max_err(old, ref)
        zero_ok = bool((out[lens < 0] == 0).all())
        same = torch.equal(out, again)
        print(f"  paged_decode B={B} NH={NH} NKV={NKV} D={D} bs={bs} "
              f"lens={lens_l}: {variant} max|dout|={e:.3e} (mma.sync "
              f"{e_old:.3e}), rerun equal: {same}, inactive rows zero: "
              f"{zero_ok}")
        if not (variant == "tma" and kernel_close(out, ref) and zero_ok
                and same and kernel_close(old, ref)):
            fail(f"paged_decode ({variant}) disagrees with its plain "
                 f"version at {(NH, NKV, D, bs)}: {e} (mma.sync {e_old}; "
                 f"tol {TOL_TEXT}), rerun equal: {same}, inactive rows "
                 f"zero: {zero_ok}")
        errs.append(e)
        if main is None:
            main = (q, ak, av, tables, lens, lens_np, NH, NKV, D, bs)
    q, ak, av, tables, lens, lens_np, NH, NKV, D, bs = main
    B, MB = q.shape[0], tables.shape[1]
    ms = time_ms(lambda: pa.paged_decode_attention(q, ak, av, tables, lens,
                                                   layer_idx=1))
    mma_ms = time_ms(lambda: pa.paged_decode_attention(
        q, ak, av, tables, lens, layer_idx=1, variant="mma"))
    plain = time_ms(lambda: pa.paged_decode_reference(
        q, ak, av, tables, lens, layer_idx=1))
    keys = int(np.sum(np.maximum(lens_np, -1) + 1))
    flops = 4 * NH * D * keys
    nbytes = (2 * keys * NKV * D * 2 + 2 * 2 * B * NH * D + 4 * B * MB
              + 4 * B)
    bms, by = bound_ms(flops, nbytes)
    work = pa.decode_work(lens_np, NKV, MB, bs,
                          pa.tma_ctas(D, NH // NKV, B))
    shares = work.tiles_per_cta
    print(f"  paged_decode at the main shape: tma {ms:.4f} ms ({sum(shares)}"
          f" key tiles on {len(shares)} CTAs, {min(shares)}-{max(shares)} "
          f"each), mma.sync pair {mma_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="paged_decode", route="cuda",
                source="deepspeed_tpu_torch/csrc/paged_decode.cu",
                replaces="deepspeed_tpu/ops/paged_attention.py:208",
                variant="tma",
                shape=f"q [{B},{NH},{D}] arena [{L},{nb},{bs},{NKV},{D}] "
                      f"bf16, lens {lens_np.tolist()}",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None,
                mma_ms=mma_ms,
                mma_note="the mma.sync split-KV pass + combine it "
                         "replaced, same call")


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
    """The paged prefill kernels, as `check_decode` does."""
    rng = np.random.RandomState(3)
    g = torch.Generator(device=dev).manual_seed(3)
    L, nb = 2, 256
    errs, main = [], None
    # (C, NH, NKV, D, pos0, n_valid, window, bs): main shape first, then
    # GQA, short chunks, windows 8 and 128, pos0 0, n_valid < C, block
    # sizes 16, 32, 128, phase 13's local heads at tp 4
    cases = [(256, 32, 32, 128, 1024, 256, None, 64),
             (256, 32, 8, 128, 700, 100, None, 64),
             (3, 32, 32, 128, 77, 3, None, 64),
             (64, 32, 8, 128, 300, 64, 128, 64),
             (5, 32, 32, 128, 0, 2, None, 64),
             (70, 8, 2, 32, 100, 61, None, 64),
             (512, 16, 4, 64, 0, 500, None, 16),
             (256, 32, 4, 128, 1024, 250, 128, 128),
             (70, 16, 2, 32, 100, 61, 8, 32),
             (1, 8, 1, 128, 0, 1, None, 16),
             (256, 8, 8, 128, 1024, 256, None, 64)]
    for C, NH, NKV, D, pos0, n_valid, win, bs in cases:
        MB = 2048 // bs
        ak, av = _arena(torch, g, dev, L, nb, bs, NKV, D)
        q = torch.randn(C, NH, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        last = pos0 + n_valid - 1
        table = torch.from_numpy(_garbage_tables(
            np, rng, 1, MB, nb, bs, np.asarray([last]))[0]).to(dev)
        args = (q, ak, av, table, pos0, n_valid)
        variant = pp.prefill_variant(q.dtype, D, bs)
        out = pp.paged_prefill_attention(*args, sliding_window=win,
                                         layer_idx=1)
        again = pp.paged_prefill_attention(*args, sliding_window=win,
                                           layer_idx=1)
        old = pp.paged_prefill_attention(*args, sliding_window=win,
                                         layer_idx=1, variant="mma")
        ref = pp.paged_prefill_reference(*args, sliding_window=win,
                                         layer_idx=1)
        torch.cuda.synchronize()
        e = max_err(out[:n_valid], ref[:n_valid])
        e_old = max_err(old[:n_valid], ref[:n_valid])
        same = torch.equal(out, again)
        print(f"  paged_prefill C={C} NH={NH} NKV={NKV} D={D} pos0={pos0} "
              f"n_valid={n_valid} window={win} bs={bs}: {variant} "
              f"max|dout|={e:.3e} (mma.sync {e_old:.3e}), rerun equal: "
              f"{same}")
        if not (variant == "tma" and same
                and kernel_close(out[:n_valid], ref[:n_valid])
                and kernel_close(old[:n_valid], ref[:n_valid])):
            fail(f"paged_prefill ({variant}) disagrees with its plain "
                 f"version at {(C, NH, NKV, D, pos0, n_valid, win, bs)}: "
                 f"{e} (mma.sync {e_old}; tol {TOL_TEXT}), rerun equal: "
                 f"{same}")
        errs.append(e)
        if main is None:
            main = (q, ak, av, table, C, NH, NKV, D, pos0, n_valid, bs)
    q, ak, av, table, C, NH, NKV, D, pos0, n_valid, bs = main
    ms = time_ms(lambda: pp.paged_prefill_attention(
        q, ak, av, table, pos0, n_valid, layer_idx=1))
    mma_ms = time_ms(lambda: pp.paged_prefill_attention(
        q, ak, av, table, pos0, n_valid, layer_idx=1, variant="mma"))
    plain = time_ms(lambda: pp.paged_prefill_reference(
        q, ak, av, table, pos0, n_valid, layer_idx=1))
    flops, nbytes = _prefill_work(C, NH, NKV, D, pos0, n_valid, None)
    bms, by = bound_ms(flops, nbytes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # phase 13's local heads at tp 4 (the last case's shape)
    qt = q[:, :8].contiguous()
    akt, avt = (t[..., :8, :].contiguous() for t in (ak, av))
    tp4_ms = time_ms(lambda: pp.paged_prefill_attention(
        qt, akt, avt, table, pos0, n_valid, layer_idx=1))
    tp4_mma = time_ms(lambda: pp.paged_prefill_attention(
        qt, akt, avt, table, pos0, n_valid, layer_idx=1, variant="mma"))
    plan = pp.prefill_plan(C, n_valid, pos0, None, NH, NKV, sms,
                           table.shape[0] * bs)
    plan8 = pp.prefill_plan(C, n_valid, pos0, None, 8, 8, sms,
                            table.shape[0] * bs)
    print(f"  paged_prefill at the main shape: tma {ms:.4f} ms ({plan.splits}"
          f" splits, {plan.ctas(NH)} CTAs), mma.sync {mma_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}); at NH 8 (tp 4's local heads) tma "
          f"{tp4_ms:.4f} ms ({plan8.splits} splits, {plan8.ctas(8)} CTAs), "
          f"mma.sync {tp4_mma:.4f} ms")
    return dict(name="paged_prefill", route="cuda",
                source="deepspeed_tpu_torch/csrc/paged_prefill.cu",
                replaces="deepspeed_tpu/ops/paged_prefill.py:309",
                variant="tma",
                shape=f"q [{C},{NH},{D}] arena [{L},{nb},{bs},{NKV},{D}] "
                      f"bf16, pos0={pos0} n_valid={n_valid}",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None,
                mma_ms=mma_ms,
                mma_note="the mma.sync kernel it replaced, same call",
                tp4_shape=f"q [{C},8,{D}] (phase 13's local heads at tp 4)",
                tp4_ms=tp4_ms, tp4_mma_ms=tp4_mma)


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
    """The gather-LoRA kernels against their plain version: the fused
    kernel (every call's route) and the two-pass kernel it replaced, at
    the wave's shapes (decode rows 32, prefill rows 512 and 2048 -- more
    work items than resident CTAs; K = N = 4096, rank 16, 4 slots of f32
    factors), then ranks 1, 40 and 128, K not a multiple of 8 and N not
    of 4, one row, f32 rows and a batch of base rows only.  Base rows'
    x rows hold NaN and must give exactly +0.0; the fused kernel's rerun
    is bit for bit; a variant that does not exist is refused.  The three
    wave shapes are timed on both kernels in this call."""
    rng = np.random.RandomState(5)
    g = torch.Generator(device=dev).manual_seed(5)
    errs, rels, timed = [], [], []
    fn = lm.lora_delta
    for S, K, N, r, slots, dt in LORA_CASES:
        dt = dt and getattr(torch, dt)
        x = torch.randn(S, K, generator=g, device=dev,
                        dtype=dt or torch.bfloat16)
        a = torch.randn(slots, K, r, generator=g, device=dev) / K ** 0.5
        b = torch.randn(slots, r, N, generator=g, device=dev) / r ** 0.5
        ids = (_lora_ids(np, rng, S, slots) if dt is not None
               else np.full(S, -1, np.int32))
        if S == 1:
            ids[:] = 1
        base = torch.from_numpy(ids < 0).to(dev)
        x[base] = float("nan")          # base rows: never multiplied
        rows = lm.LoraRows(ids)
        before = dict(fn.launches_by_variant)
        out = fn(x, a, b, rows)
        again = fn(x, a, b, rows)
        two = fn(x, a, b, rows, variant="two_pass")
        ref = lm.lora_delta_reference(x, a, b, rows)
        torch.cuda.synchronize()
        ran = {v: n - before[v] for v, n in fn.launches_by_variant.items()}
        zeros = all(bool((t[base] == 0).all()
                         and not t[base].signbit().any()) for t in (out,
                                                                     two))
        scale = float(ref.abs().max())
        err, err2 = max_err(out, ref), max_err(two, ref)
        rel = err / scale if scale > 0 else err
        rel2 = err2 / scale if scale > 0 else err2
        same = torch.equal(out, again)
        print(f"  lora_delta S={S} K={K} N={N} r={r} slots={slots} x "
              f"{str(dt)[6:] if dt else 'bf16, every row base'}: fused "
              f"max|d|/max|plain|={rel:.3e}, two-pass {rel2:.3e}; base rows "
              f"exactly 0: {zeros}; rerun equal {same}; launches {ran}")
        if not (zeros and rel <= LORA_REL and rel2 <= LORA_REL and same):
            fail(f"lora_delta disagrees with its plain version at "
                 f"{(S, K, N, r, slots, dt)}: fused {rel}, two-pass {rel2} "
                 f"of max|plain| (tol {LORA_REL}), base rows exactly 0: "
                 f"{zeros}, rerun equal {same}")
        if ran != {"fused": 2, "two_pass": 1}:
            fail(f"lora_delta ran {ran}, want fused 2, two_pass 1")
        errs.append(max(err, err2))
        rels.append(max(rel, rel2))
        if len(timed) < 3:
            timed.append((x, a, b, ids, rows, S, K, N, r))
    with_bad = fn.launches
    try:
        fn(x, a, b, rows, variant="mma")
    except ValueError:
        pass
    else:
        fail("lora_delta took variant 'mma'")
    if fn.launches != with_bad:
        fail("a refused LoRA variant launched")
    # the timed shapes on both kernels: prefill rows (the row's main
    # shape), decode rows and 2048 rows
    times, sizes = {}, [t[5] for t in timed]
    for x, a, b, ids, rows, S, K, N, r in timed:
        times[S] = dict(
            fused=time_ms(lambda: fn(x, a, b, rows)),
            two_pass=time_ms(lambda: fn(x, a, b, rows, variant="two_pass")),
            bound=bound_ms(*_lora_work(np, ids, K, N, r, 2),
                           H100_F32_FLOPS))
        print(f"  lora_delta at {S} rows: fused {times[S]['fused']:.4f} ms, "
              f"two-pass {times[S]['two_pass']:.4f} ms (bound "
              f"{times[S]['bound'][0]:.4f} ms, {times[S]['bound'][1]})")
        if times[S]["fused"] > times[S]["two_pass"]:
            print(f"  NOTE: the fused kernel is slower than the two-pass one "
                  f"at {S} rows")
    x, a, b, ids, rows, S, K, N, r = timed[0]
    plain = time_ms(lambda: lm.lora_delta_reference(x, a, b, rows), iters=5)
    main = times[S]
    return dict(name="lora_delta", route="cuda",
                source="deepspeed_tpu_torch/csrc/lora_delta.cu",
                replaces="deepspeed_tpu/ops/lora_matmul.py:125",
                variant="fused",
                shape=f"x [{S},{K}] bf16, A [4,{K},{r}] / B [4,{r},{N}] "
                      f"f32, ids {int((ids >= 0).sum())} adapter rows of "
                      f"{len(np.unique(ids[ids >= 0]))} slots",
                max_abs_err=max(errs), max_rel_err=max(rels),
                max_rel_err_note="max|kernel - plain| / max|plain|, both "
                                 "kernels",
                ms=main["fused"], two_pass_ms=main["two_pass"],
                two_pass_note="the two-pass kernel it replaced, same call",
                plain_ms=plain, bound_ms=main["bound"][0],
                bound_by=main["bound"][1], library_ms=None,
                library_note="no single PyTorch call does a per-row slot "
                             "gather and product",
                decode_shape=f"x [{sizes[1]},{K}] bf16",
                decode_ms=times[sizes[1]]["fused"],
                decode_two_pass_ms=times[sizes[1]]["two_pass"],
                decode_bound_ms=times[sizes[1]]["bound"][0],
                rows2048_ms=times[sizes[2]]["fused"],
                rows2048_two_pass_ms=times[sizes[2]]["two_pass"],
                rows2048_bound_ms=times[sizes[2]]["bound"][0])


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
                   *main[0], layer_idx=1)),
               mma_ms=time_ms(lambda: pm.merged_decode_attention(
                   *main[0], layer_idx=1, variant="mma")))
    dec["bound_ms"], dec["bound_by"] = bound_ms(
        4 * NH * D * keys, 2 * keys * NKV * D * 2 + 2 * 2 * B * NH * D
        + 4 * B * MB + 4 * B)
    pre = dict(ms=time_ms(lambda: pm.merged_prefill_attention(
                   *mpre, layer_idx=1)),
               plain_ms=time_ms(lambda: pm.merged_prefill_reference(
                   *mpre, layer_idx=1)),
               mma_ms=time_ms(lambda: pm.merged_prefill_attention(
                   *mpre, layer_idx=1, variant="mma")))
    print(f"  merged at the main shapes: decode tma {dec['ms']:.4f} ms, "
          f"mma.sync {dec['mma_ms']:.4f} ms; prefill tma {pre['ms']:.4f} "
          f"ms, mma.sync {pre['mma_ms']:.4f} ms")
    pre["bound_ms"], pre["bound_by"] = bound_ms(
        *_prefill_work(256, NH, NKV, D, 1024, 256, None))
    arena = f"arena [{L},{nb},{bs},{M}] bf16"
    return [dict(name="merged_decode", route="cuda",
                 source="deepspeed_tpu_torch/csrc/paged_decode.cu",
                 wrapper="deepspeed_tpu_torch/ops/paged_merged.py",
                 replaces="deepspeed_tpu/ops/paged_merged.py:202",
                 variant="tma",
                 shape=f"q [{B},{NH},{D}] {arena}, lens {WAVE_LENS}",
                 max_abs_err=max(e[0] for e in errs), **dec,
                 library_ms=None),
            dict(name="merged_prefill", route="cuda",
                 source="deepspeed_tpu_torch/csrc/paged_prefill.cu",
                 wrapper="deepspeed_tpu_torch/ops/paged_merged.py",
                 replaces="deepspeed_tpu/ops/paged_merged.py:400",
                 variant="tma",
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


def time_flash_bwd(fa, q, k, v, out, lse, do, timer=time_ms):
    """ms of the backward's kernels on these inputs (device ms under the
    default `timer`): the delta kernel and dq and dk/dv fed its delta,
    each alone.  A package without the delta kernel (its dq and dk/dv
    compute delta inside) reads "delta" 0."""
    delta, res = None, {"delta": 0.0}
    if hasattr(fa, "flash_attention_bwd_delta"):
        delta = fa.flash_attention_bwd_delta(out, do)
        res["delta"] = timer(lambda: fa.flash_attention_bwd_delta(out, do))
    kw = {} if delta is None else {"delta": delta}
    res["dq"] = timer(lambda: fa.flash_attention_bwd_dq(
        q, k, v, out, lse, do, **kw))
    res["dkv"] = timer(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, out, lse, do, **kw))
    return res


# The mma.sync dq and dk/dv kernels that the TMA + wgmma pair replaced, at
# the training shape (TRAIN_ATTN): PERF.md's kernel table, rows 4 and 5,
# on an H100 80GB HBM3 at 700 W.  Printed beside this run's times only.
MMA_SYNC_BWD_MS = {"dq": 0.5946, "dkv": 1.5495}
DELTA_REL = 1e-5   # delta vs plain rowsum: f32 sums of D terms, reordered


def check_flash_bwd(torch, fa, dev):
    """The delta, dq and dk/dv kernels against their plain versions, all
    fed the flash forward kernel's out and lse; the bf16 cases on the TMA
    + wgmma pair and rerun bit for bit; timed at the training shape."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(4)
    # (B, S, NH, NKV, D, dtype, causal): the training shape first, then GQA
    # with a ragged tail, D 64, D 32 (GQA 4), one row, non-causal, and f32
    cases = [TRAIN_ATTN + (torch.bfloat16, True),
             (1, 1000, 32, 4, 128, torch.bfloat16, True),
             (2, 300, 8, 8, 64, torch.bfloat16, True),
             (2, 100, 8, 2, 32, torch.bfloat16, True),
             (1, 1, 8, 2, 128, torch.bfloat16, True),
             (2, 200, 8, 2, 128, torch.bfloat16, False),
             (2, 130, 4, 4, 32, torch.bfloat16, False),
             (2, 200, 8, 2, 128, torch.float32, True)]
    counters = (fa.flash_attention_bwd_delta, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    errs = {"delta": [], "dq": [], "dkv": []}
    main = None
    for B, S, NH, NKV, D, dt, causal in cases:
        q, do = (torch.randn(B, S, NH, D, generator=g, device=dev, dtype=dt)
                 for _ in range(2))
        k, v = (torch.randn(B, S, NKV, D, generator=g, device=dev,
                            dtype=dt) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        reset_counts(counters)
        delta = fa.flash_attention_bwd_delta(out, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal, delta)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, causal,
                                            delta)
        variants = by_variant(counters)
        again = (fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                           delta),
                 *fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, causal,
                                             delta))
        rdelta = fa.flash_attention_bwd_delta_reference(out, do)
        rdq = fa.flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                                  causal)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, out, lse,
                                                        do, causal)
        torch.cuda.synchronize()
        rtol, arel = ((BWD_RTOL, BWD_ATOL_REL) if dt == torch.bfloat16
                      else (0.0, BWD_F32_REL))
        res = {n: bwd_close(a, b, rtol, arel)
               for n, a, b in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv))}
        res["delta"] = bwd_close(delta, rdelta, 0.0, DELTA_REL)
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        want = fa.bwd_variant(dt)
        print(f"  flash_bwd B={B} S={S} NH={NH} NKV={NKV} D={D} "
              f"{str(dt)[6:]} {'causal' if causal else 'full'}: "
              f"max|d| / max|plain| " + ", ".join(
                  f"{n} {r[1]:.3e}" for n, r in res.items())
              + f"; rerun equal {same}; kernels {variants}")
        for n, (ok, rel) in res.items():
            if not ok:
                fail(f"flash backward {n} disagrees with its plain version "
                     f"at {(B, S, NH, NKV, D, dt, causal)}: {rel} of "
                     f"max|plain| (tol {BWD_TOL_TEXT}; delta {DELTA_REL})")
        if not same:
            fail(f"flash backward rerun differs at "
                 f"{(B, S, NH, NKV, D, dt, causal)}")
        if any(v[want] != 1 for v in variants.values()):
            fail(f"flash backward at {(B, S, NH, NKV, D, dt)} ran "
                 f"{variants}, want one {want} launch each")
        errs["delta"].append(max_err(delta, rdelta))
        errs["dq"].append(max_err(dq, rdq))
        errs["dkv"].append(max(max_err(dk, rdk), max_err(dv, rdv)))
        if main is None:
            main = (q, k, v, out, lse, do, B, S, NH, NKV, D)
        del rdq, rdk, rdv, again
    q, k, v, out, lse, do, B, S, NH, NKV, D = main
    ms = time_flash_bwd(fa, q, k, v, out, lse, do)
    plain = {"delta": time_ms(lambda: fa.flash_attention_bwd_delta_reference(
                 out, do), iters=3, warmup=1),
             "dq": time_ms(lambda: fa.flash_attention_bwd_dq_reference(
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

    lib_bwd = timing_less(time_ms(sdpa_fwd_bwd), time_ms(sdpa_fwd))
    total = ms["delta"] + ms["dq"] + ms["dkv"]
    print(f"  flash backward at the training shape: delta {ms['delta']:.4f}"
          f", dq {ms['dq']:.4f}, dk/dv {ms['dkv']:.4f} ms, together "
          f"{total:.4f} ms ({total / lib_bwd:.2f}x SDPA's backward "
          f"{lib_bwd:.4f} ms); the mma.sync kernels it replaced: dq "
          f"{MMA_SYNC_BWD_MS['dq']}, dk/dv {MMA_SYNC_BWD_MS['dkv']} ms "
          f"(PERF.md)")
    shape = (f"q/k/v/dO [{B},{S},{NH},{D}] bf16 causal")
    q_like = B * S * NH * D
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
    # out and dO read, delta written: 2 q-like bf16 reads, one f32 per row
    bms, by = bound_ms(2 * q_like, 2 * 2 * q_like + 4 * B * NH * S)
    rows.append(dict(
        name="flash_bwd_delta", route="cuda",
        source="deepspeed_tpu_torch/csrc/flash_bwd.cu",
        replaces="deepspeed_tpu/ops/flash_attention.py:374",
        replaces_note="delta = rowsum(dO * O), which the TPU's dq and dk/dv "
                      "kernels compute from the out tile (:141, :216): "
                      "part of rows 4 and 5",
        shape=shape, max_abs_err=max(errs["delta"]), ms=ms["delta"],
        plain_ms=plain["delta"], bound_ms=bms, bound_by=by,
        library_ms=None))
    return rows


# ----------------------------------------------------------------------
# phases 5-7: the training path
# ----------------------------------------------------------------------
def bench_config(policy, opt_params=None):
    """bench.py's training configuration on one device (its optimizer
    params replaced by `opt_params` where given)."""
    return {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adamw",
                          "params": opt_params or {
                              "lr": 1e-4, "weight_decay": 0.1,
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
    reset_counts(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = [eng.train_batch(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    variants = by_variant(counters)
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
    print(f"phase 5: launches per step {per_step}; by variant {variants}")
    if not all(np.isfinite(losses + warm[0] + warm[1])):
        fail(f"non-finite training loss or grad norm: {losses}, {warm}")
    for name, n in launches.items():
        if n != cfg.num_layers * TRAIN_STEPS:
            fail(f"{name} launched {n} times over {TRAIN_STEPS} steps, "
                 f"want {cfg.num_layers} per step (one per layer under "
                 f"save_attn)")
    check_bwd_variants(variants, launches, "phase 5")
    res = dict(step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
               peak_memory_bytes=peak, losses=losses,
               warmup_losses=warm[0], warmup_grad_norms=warm[1],
               warmup_attn_grad_norms=warm[2], launches=launches,
               launches_per_step=per_step, launches_by_variant=variants,
               n_params=n_params, layers=cfg.num_layers)
    return eng, batch, res


def check_bwd_variants(variants, launches, where):
    """Every flash dq and dk/dv launch of a bf16 training run took the
    TMA + wgmma kernels (`variants` from `by_variant`)."""
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if name in variants and \
                variants[name].get("wgmma") != launches[name]:
            fail(f"{where}: {name} launches by variant {variants[name]}: "
                 f"every bf16 launch must take the TMA + wgmma kernel")


def profile_train_step(torch, eng, batch, step_ms, counters, phase=7):
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
    print(f"phase {phase}: training step device time {busy:.2f} ms of "
          f"{step_ms:.2f} ms wall (idle share {res['idle_share']:.3f}); by "
          f"kind (ms) " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              by_kind.items(), key=lambda kv: -kv[1])))
    if not spans:
        print(f"phase {phase}: the optimizer range did not show on the "
              f"device timeline: its share is not measured")
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
    reset_counts(counters)
    m = eng.train_batch(batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    loss = float(m["loss"])
    del eng
    L = model.cfg.num_layers
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_delta": L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L}
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
def sync(torch, dev="cuda"):
    """Wait for `dev`'s queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(torch, np, fn, acc, key, finite, dev="cuda"):
    def wrapped(*a, **kw):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(torch, dev)
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
    reset_counts(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    paged_on_tma(counters, "phase 2")
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
               launches=launches, launches_by_variant=by_variant(counters))
    print(f"phase 2: {len(prompts)} requests, {n_prompt} prompt tokens in "
          f"{acc['prefill']:.3f} s over {acc['prefill_calls']} steps "
          f"({res['prefill_tok_s']:.0f} tok/s); {n_dec} decode tokens in "
          f"{acc['decode']:.3f} s over {acc['decode_calls']} bursts "
          f"({res['decode_tok_s']:.0f} tok/s); launches {launches}, by "
          f"variant {res['launches_by_variant']}")
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

    reset_counts(counters)
    outs_a, logits_a, wall_a = timed_wave()
    launches_a = {c.__name__: c.launches for c in counters}
    paged_on_tma(counters, "phase 8 arm A")

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
        reset_counts(counters)
        outs_b, logits_b, wall = timed_wave()
    finally:
        restore()
    launches = {c.__name__: c.launches for c in counters}
    variants = by_variant(counters)
    paged_on_tma(counters, "phase 8 arm B")
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
    if variants["lora_delta"] != {"fused": want, "two_pass": 0}:
        fail(f"lora_delta launched {variants['lora_delta']}: every LoRA "
             f"launch of the wave must take the fused kernel")
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
    lora_by = {v: prof_launches.get("lora_delta/" + v, 0)
               for v in lm.VARIANTS}
    print(f"phase 8: the wave's LoRA device ms {lora_ms:.2f} over "
          f"{prof_launches['lora_delta']} launches (by kernel {lora_by})")
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
               launches_by_variant=variants,
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
    reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    variants = by_variant(counters)
    paged_on_tma(counters, "phase 9")
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
    return dict(wall_s=wall, launches=launches,
                launches_by_variant=variants)


# ----------------------------------------------------------------------
# phase 1: the fused 8-bit Adam and block-sparse kernels
# ----------------------------------------------------------------------
def adam8_inputs(torch, topt, g, dev, shape, gdtype):
    """(grad, m codes, m scales, v codes, v scales, master) after one real
    quantized step of seeded moments."""
    p = torch.randn(*shape, generator=g, device=dev) * 0.1
    grad = (torch.randn(*shape, generator=g, device=dev) * 1e-3).to(gdtype)
    m0 = torch.randn(*shape, generator=g, device=dev) * 1e-3
    m_q, m_s = topt._q8_signed(m0)
    v_q, v_s = topt._q8_log(m0 * m0)
    return grad, m_q, m_s, v_q, v_s, p


def adam8_args(torch, dev):
    """lr, gscale (a device scalar, as the engine passes it), c1, c2 at
    step 2."""
    return (1e-4, torch.tensor(0.5, device=dev), 1 - 0.9 ** 2,
            1 - 0.999 ** 2)


def adam8_bytes(n, rows):
    """Bytes one update of n elements in `rows` rows must move: bf16
    gradient, both codes and the f32 master read; master, bf16 parameter
    and codes written; the four row scales read and written."""
    return n * (2 + 1 + 1 + 4) + n * (4 + 2 + 1 + 1) + rows * 4 * 4


def check_adam8(torch, fa8, topt, dev):
    """The fused 8-bit Adam kernel against its plain version at one w_up
    layer's slice (bf16 gradients), then f32 gradients, rows of 100 and of
    33 (no vector loads), a row too long for shared memory (the recompute
    form) and a 1-D leaf; timed at the main shape."""
    g = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(ADAM8_SHAPE, bf16), ((7, 100), f32), ((5, 33), bf16),
             ((2, 30000), bf16), ((2048,), f32)]
    args = adam8_args(torch, dev)
    errs, flips, main = [], [], None
    for shape, gd in cases:
        inp = adam8_inputs(torch, topt, g, dev, shape, gd)
        got = fa8.fused_adam8_leaf(*inp, *args, **ADAM8_KW)
        want = fa8.fused_adam8_leaf_reference(*inp, *args, **ADAM8_KW)
        torch.cuda.synchronize()
        master_ok = bool(((got[0] - want[0]).abs()
                          <= ADAM8_ATOL + ADAM8_RTOL * want[0].abs()).all())
        cast_ok = torch.equal(got[1], got[0].to(torch.bfloat16))
        dcode = [(got[i].int() - want[i].int()).abs() for i in (2, 4)]
        codes_ok = all(int(d.max()) <= 1 for d in dcode)
        share = [float((d > 0).float().mean()) for d in dcode]
        scale_err = max(float(((got[i] - want[i]).abs()
                               / want[i].abs().clamp_min(1e-30)).max())
                        for i in (3, 5))
        e = max_err(got[0], want[0])
        print(f"  fused_adam8 {list(shape)} grads {str(gd)[6:]}: "
              f"max|dmaster|={e:.3e}, cast == cast of master: {cast_ok}, "
              f"codes differing (m, v): {share[0]:.2e}, {share[1]:.2e} "
              f"(max 1: {codes_ok}), max rel scale err {scale_err:.2e}")
        if not (master_ok and cast_ok and codes_ok
                and scale_err <= ADAM8_RTOL):
            fail(f"fused_adam8 disagrees with its plain version at {shape} "
                 f"{gd}: master {e}, cast {cast_ok}, codes {codes_ok}, "
                 f"scales {scale_err}")
        errs.append(e)
        flips.append(max(share))
        if main is None:
            main = inp
    n, rows = main[5].numel(), main[5].shape[0]
    outs = tuple(torch.empty_like(t) for t in (main[5], main[5].to(bf16),
                                               *main[1:5]))
    ms = time_ms(lambda: fa8.fused_adam8_leaf(*main, *args, out=outs,
                                              **ADAM8_KW))
    plain = time_ms(lambda: fa8.fused_adam8_leaf_reference(
        *main, *args, **ADAM8_KW), iters=5, warmup=1)
    bms, by = bound_ms(ADAM8_OPS * n, adam8_bytes(n, rows), H100_F32_FLOPS)
    print(f"  fused_adam8 at {list(ADAM8_SHAPE)}: {ms:.4f} ms (bound "
          f"{bms:.4f} ms, {by}), plain {plain:.4f} ms")
    return dict(name="fused_adam8", route="cuda",
                source="deepspeed_tpu_torch/csrc/fused_adam8.cu",
                replaces="deepspeed_tpu/ops/fused_adam8.py:182",
                shape=f"[{ADAM8_SHAPE[0]},{ADAM8_SHAPE[1]}] f32 master, "
                      f"bf16 grads, int8/uint8 codes, f32 row scales",
                max_abs_err=max(errs), max_code_flip_share=max(flips),
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=None,
                library_note="no single PyTorch call runs an Adam step "
                             "with 8-bit codebook moments")


def sparse_layouts(sa, H):
    """Phase 10's layouts: (name, sparsity config)."""
    return [("fixed16", sa.FixedSparsityConfig(
                num_heads=H, block=16, different_layout_per_head=True,
                num_local_blocks=4, num_global_blocks=1,
                attention="bidirectional", num_different_global_patterns=4)),
            ("bigbird64", sa.BigBirdSparsityConfig(num_heads=H, block=64)),
            ("fixed64_causal", sa.FixedSparsityConfig(
                num_heads=H, block=64, num_local_blocks=4,
                attention="unidirectional"))]


def sparse_pairs(np, layout, block, causal):
    """(query, key) pairs one batch row's attention visits under `layout`
    (per head summed): block^2 per visited block, the lower triangle with
    the diagonal on diagonal blocks and nothing above them when causal."""
    if not causal:
        return int(layout.sum()) * block * block
    H, nb, _ = layout.shape
    i, j = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    per = np.where(j < i, block * block,
                   np.where(j == i, block * (block + 1) // 2, 0))
    return int((layout * per[None]).sum())


def sparse_work(np, layout, block, causal, B, S, H, D, elem=2):
    """(FLOPs, bytes) of the forward, dq and dk/dv kernels: 2, 3 and 4
    products of 2 D FLOPs per visited pair; q, k, v (and out, dO, lse in
    the backward) read once, outputs written once."""
    pairs = B * sparse_pairs(np, layout, block, causal)
    t = B * S * H * D * elem
    lse = B * H * S * 4
    return {"fwd": (4 * D * pairs, 3 * t + t + lse),
            "dq": (6 * D * pairs, 5 * t + lse + t),
            "dkv": (8 * D * pairs, 5 * t + lse + 2 * t),
            "bwd": (14 * D * pairs, 5 * t + lse + 3 * t)}


def walk_text(plan):
    """The wgmma kernels' walks of a plan: owners a CTA, grouping, padding
    factor (tile work over visited work), per kernel."""
    if plan.dq is None:
        return "no gathered walk at this block"
    return ", ".join(f"{n} {w.owners} owner{'s' if w.owners > 1 else ''} "
                     f"{w.grouping} padding {w.padding:.4f}"
                     for n, w in (("fwd", plan.fwd), ("dq", plan.dq),
                                  ("dk/dv", plan.dkv)) if w is not None)


def fwd_walk_plans(torch, sf, kidx, block, plan):
    """`plan` with its forward walk replaced by each grouping's (the
    walks the forward kernel can take)."""
    import dataclasses
    out = []
    for grp in sf.WALK_GROUPINGS:
        w = sf.tile_walk(kidx, block, sf.GATHER_ROWS // block, grp,
                         ragged=True)
        dev = plan.fwd_device[0].device
        out.append(dataclasses.replace(plan, fwd=w, fwd_device=(
            torch.from_numpy(w.sched).to(dev),
            torch.from_numpy(w.ents).to(dev))))
    return out


def check_sparse_forward(torch, sf, q, k, v, kidx, layout, idx, plan, block,
                         causal, out, lse, ref, ref_lse, every_walk):
    """The forward on the kernel `fwd_variant` names (given its output
    `out`, `lse`): a rerun bit for bit; NaN written into the key and
    value blocks no query block of a head visits changes no bit; on the
    wgmma kernel, the mma.sync kernel's output within the forward
    tolerance and (with `every_walk`) both groupings' walks within it of
    the plain version, each rerun bit for bit.  Returns (max abs error
    against the plain version and the mma.sync kernel, problems)."""
    fwd = sf.block_sparse_flash_attention
    D = q.shape[-1]
    variant = sf.fwd_variant(q.dtype, D, block)
    problems = []
    again, lse2 = fwd(q, k, v, idx, block, causal, return_lse=True,
                      plan=plan)
    if not (torch.equal(out, again) and torch.equal(lse, lse2)):
        problems.append("rerun differs")
    unvisited = ~layout.any(1)                         # [h, key block]
    if unvisited.any():
        kn, vn = k.clone(), v.clone()
        for h, kb in zip(*unvisited.nonzero()):
            kn[:, kb * block:(kb + 1) * block, h] = float("nan")
            vn[:, kb * block:(kb + 1) * block, h] = float("nan")
        nan_out, nan_lse = fwd(q, kn, vn, idx, block, causal,
                               return_lse=True, plan=plan)
        if not (torch.equal(out, nan_out) and torch.equal(lse, nan_lse)):
            problems.append("NaN in unvisited key/value blocks moved the "
                            "output")
        del kn, vn, nan_out, nan_lse
    err = 0.0
    if variant == "wgmma":
        mma, mma_lse = fwd(q, k, v, idx, block, causal, return_lse=True,
                           variant="mma")
        err = max(max_err(out, mma), max_err(lse, mma_lse))
        if not (kernel_close(out, mma)
                and max_err(lse, mma_lse) <= LSE_ATOL):
            problems.append(f"the mma.sync kernel differs by {err}")
        for p in (fwd_walk_plans(torch, sf, kidx, block, plan)
                  if every_walk else []):
            got, glse = fwd(q, k, v, idx, block, causal, return_lse=True,
                            plan=p)
            got2, _ = fwd(q, k, v, idx, block, causal, return_lse=True,
                          plan=p)
            err = max(err, max_err(got, ref), max_err(glse, ref_lse))
            if not (kernel_close(got, ref) and torch.equal(got, got2)
                    and max_err(glse, ref_lse) <= LSE_ATOL):
                problems.append(f"the {p.fwd.grouping} walk disagrees or "
                                f"reruns differ")
    return err, problems


def sparse_check_one(torch, sa, sf, q, k, v, do, layout, block, causal,
                     every_walk=False):
    """Forward, delta, dq and dk/dv kernels against their plain versions
    on one input, the backward on the pair `bwd_variant` names (with
    `every_walk`, on the wgmma pair over every walk the plan can take
    too), each backward rerun bit for bit: ({"fwd"|"dq"|"dkv"|"delta":
    max abs err}, the kernel outputs, the variant)."""
    B, S, H, D = q.shape
    kidx = sa._layout_to_gather(layout)
    idx, rev, plan = sa._device_tables(kidx, q.device, block)
    fcount = dict(sf.block_sparse_flash_attention.launches_by_variant)
    out, lse = sf.block_sparse_flash_attention(q, k, v, idx, block, causal,
                                               return_lse=True, plan=plan)
    fran = {v_: n - fcount[v_] for v_, n in
            sf.block_sparse_flash_attention.launches_by_variant.items()}
    ref, ref_lse = sf.block_sparse_flash_attention_reference(
        q, k, v, idx, block, causal)
    fvariant = sf.fwd_variant(q.dtype, D, block)
    if fran != {v_: int(v_ == fvariant) for v_ in sf.FWD_VARIANTS}:
        fail(f"the block-sparse forward ran {fran}, want one {fvariant}")
    fwd_err, fwd_problems = check_sparse_forward(
        torch, sf, q, k, v, kidx, layout, idx, plan, block, causal, out,
        lse, ref, ref_lse, every_walk)
    variant = sf.bwd_variant(q.dtype, D, block)
    counters = (sf.block_sparse_flash_dq, sf.block_sparse_flash_dkv)
    plans = [plan]
    if every_walk and variant == "wgmma":
        plans += [sf.bwd_plan(kidx, block, q.device, r, g)
                  for r in sf.OWNER_GROUPS[block] for g in sf.WALK_GROUPINGS
                  if (r > 1 or g == "adjacent") and layout.shape[1] % r == 0]
    rdq, rdk, rdv = sf.block_sparse_flash_backward_reference(
        q, k, v, idx, out, do, lse, block, causal)
    rdelta = sf.block_sparse_flash_bwd_delta_reference(out, do)
    bf = q.dtype == torch.bfloat16
    rtol, arel = (BWD_RTOL, BWD_ATOL_REL) if bf else (0.0, BWD_F32_REL)
    desc = (f"B={B} S={S} H={H} D={D} block={block} "
            f"{'causal' if causal else 'full'} {str(q.dtype)[6:]}")
    errs = {"fwd": max(max_err(out, ref), max_err(lse, ref_lse), fwd_err),
            "dq": 0.0, "dkv": 0.0, "delta": 0.0}
    print(f"  sparse {desc}: forward on {fvariant}, max|dout| "
          f"{max_err(out, ref):.3e}, max|dlse| {max_err(lse, ref_lse):.3e}"
          + (f", against mma.sync and every walk {fwd_err:.3e}"
             if fvariant == "wgmma" else "")
          + f"; rerun equal, NaN in unvisited blocks ignored: "
          f"{not fwd_problems}")
    if fwd_problems:
        fail(f"block-sparse forward at {desc}: {fwd_problems}")
    for p in plans:
        kw = {"plan": p, "variant": variant} if variant == "wgmma" else {}
        reset_counts(counters)
        got = sf.block_sparse_flash_backward(q, k, v, idx, rev, out, do, lse,
                                             block, causal, **kw)
        again = sf.block_sparse_flash_backward(q, k, v, idx, rev, out, do,
                                               lse, block, causal, **kw)
        variants = by_variant(counters)
        torch.cuda.synchronize()
        res = {n: bwd_close(a, b, rtol, arel)
               for n, a, b in zip(("dq", "dk", "dv"), got, (rdq, rdk, rdv))}
        if variant == "wgmma":
            delta = sf.block_sparse_flash_bwd_delta(out, do)
            res["delta"] = bwd_close(delta, rdelta, 0.0, DELTA_REL)
            errs["delta"] = max(errs["delta"], max_err(delta, rdelta))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  sparse {desc}: {variant} ({walk_text(p)}); "
              f"max|dout|={max_err(out, ref):.3e} "
              f"max|dlse|={max_err(lse, ref_lse):.3e}; max|d| / max|plain| "
              + ", ".join(f"{n} {r[1]:.3e}" for n, r in res.items())
              + f"; rerun equal {same}; kernels {variants}")
        fwd_ok = (kernel_close(out, ref) if bf else
                  max_err(out, ref) <= BWD_F32_REL * max(
                      float(ref.abs().max()), 1.0))
        if not (fwd_ok and max_err(lse, ref_lse) <= LSE_ATOL
                and all(r[0] for r in res.values())):
            fail(f"block-sparse kernels disagree with their plain versions "
                 f"at {desc} ({walk_text(p)}): out {max_err(out, ref)} "
                 f"(tol {TOL_TEXT}), lse {max_err(lse, ref_lse)}, backward "
                 f"{res} (tol {BWD_TOL_TEXT}; delta {DELTA_REL})")
        if not same:
            fail(f"block-sparse backward rerun differs at {desc}")
        if any(v_[variant] != 2 for v_ in variants.values()):
            fail(f"block-sparse backward at {desc} ran {variants}, want "
                 f"two {variant} launches each")
        errs["dq"] = max(errs["dq"], max_err(got[0], rdq))
        errs["dkv"] = max(errs["dkv"], max_err(got[1], rdk),
                          max_err(got[2], rdv))
    return errs, (out, lse, *got, idx, rev, plan), variant


def dense_mask(torch, np, layout, block, causal, dev):
    """The layout expanded to a boolean [H, S, S] token mask."""
    m = np.kron(layout, np.ones((block, block), bool))
    if causal:
        m &= np.tril(np.ones(m.shape[1:], bool))[None]
    return torch.from_numpy(m).to(dev)


def sdpa_times(torch, q, k, v, do, mask, timer=time_ms):
    """SDPA with the dense mask: (forward ms, backward ms as forward +
    backward less forward), each from `timer`."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    f = timer(fwd, iters=5, warmup=1)
    return f, timing_less(timer(fwd_bwd, iters=5, warmup=1), f)


def masked_layout(np, nb):
    """Two heads of one block a row on the diagonal; head 0's q-block 2
    sees only key block 5 (under causal, nothing: a fully-masked row)."""
    layout = np.eye(nb, dtype=bool)[None].repeat(2, 0)
    layout[0, 2] = False
    layout[0, 2, 5] = True
    return layout


def scattered_layout(np, H, nb, per_row, seed=11):
    """The diagonal and `per_row` - 1 random blocks a row, per head: the
    visitor lists of neighbouring blocks share little."""
    rng = np.random.RandomState(seed)
    layout = np.zeros((H, nb, nb), bool)
    for h in range(H):
        for i in range(nb):
            layout[h, i, i] = True
            layout[h, i, rng.choice(nb, per_row - 1, replace=False)] = True
    return layout


def check_sparse(torch, np, sa, sf, dev):
    """The block-sparse forward, delta, dq and dk/dv kernels against their
    plain versions at phase 10's first layout and shape, then the wgmma
    pair's edges (blocks 16, 32, 64, D 64 and 128, causal and not, a
    fully-masked row, lists that end mid-step, every walk the plan can
    take) and the other pairs' (block 8 and 128, D 192 and 256, f32);
    timed at the main shape beside the mma.sync pair and SDPA with the
    dense mask."""
    g = torch.Generator(device=dev).manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, D = SPARSE_SHAPE
    name, cfg = sparse_layouts(sa, H)[0]
    block = cfg.block
    main_layout = cfg.make_layout(S)
    bigbird = sa.BigBirdSparsityConfig(num_heads=2, block=64,
                                       different_layout_per_head=True)
    masked = masked_layout(np, 8)
    # (B, S, H, D, dtype, layout, block, causal): the timed shape first
    cases = [(B, S, H, D, bf16, main_layout, block, False),
             (2, 128, 2, 64, bf16, masked, 16, True),
             (2, 384, 2, 128, bf16, scattered_layout(np, 2, 12, 5), 32,
              True),
             (2, 768, 2, 64, bf16, scattered_layout(np, 2, 12, 3), 64,
              True),
             (1, 1024, 2, 128, bf16, sa.FixedSparsityConfig(
                 num_heads=2, block=64, num_local_blocks=2,
                 attention="unidirectional").make_layout(1024), 64, True),
             (2, 480, 2, 64, bf16, sa.BSLongformerSparsityConfig(
                 num_heads=2, block=16).make_layout(480), 16, False),
             (1, 288, 2, 128, bf16, scattered_layout(np, 2, 9, 2), 32,
              False),
             (2, 512, 2, 64, f32, bigbird.make_layout(512), 64, False),
             (2, 64, 2, 128, bf16, sa.BigBirdSparsityConfig(
                 num_heads=2, block=8).make_layout(64), 8, True),
             (1, 1024, 2, 128, bf16, sa.BigBirdSparsityConfig(
                 num_heads=2, block=128).make_layout(1024), 128, False),
             (1, 1024, 4, 128, f32, sa.FixedSparsityConfig(
                 num_heads=4, block=32, num_local_blocks=2,
                 attention="unidirectional").make_layout(1024), 32, True),
             # head dims 192 and 256 (the JAX gate's D % 64 == 0); block
             # 128 at D 256 takes the backward kernels' split tile
             (1, 512, 2, 192, bf16, sa.BigBirdSparsityConfig(
                 num_heads=2, block=64).make_layout(512), 64, False),
             (1, 1024, 2, 256, bf16, sa.FixedSparsityConfig(
                 num_heads=2, block=128, num_local_blocks=2,
                 attention="unidirectional").make_layout(1024), 128, True),
             (1, 256, 2, 256, f32, sa.FixedSparsityConfig(
                 num_heads=2, block=32, num_local_blocks=2).make_layout(256),
              32, False)]
    errs = {"fwd": [], "dq": [], "dkv": [], "delta": []}
    main = None
    for n_, (b_, s_, h_, d_, dt_, lay, bl, causal) in enumerate(cases):
        q, k, v, do = (torch.randn(b_, s_, h_, d_, generator=g, device=dev,
                                   dtype=dt_) for _ in range(4))
        e, outs, variant = sparse_check_one(torch, sa, sf, q, k, v, do, lay,
                                            bl, causal, every_walk=n_ > 0)
        if lay is masked:
            rows = slice(2 * bl, 3 * bl)
            if not (bool((outs[0][:, rows, 0] == 0).all())
                    and bool(torch.isfinite(outs[1]).all())
                    and all(bool(torch.isfinite(t).all())
                            for t in outs[2:5])
                    and bool((outs[2][:, rows, 0] == 0).all())):
                fail("a fully-masked row did not give out 0, a finite lse, "
                     "finite gradients and dq 0")
        for n in errs:
            errs[n].append(e[n])
        if main is None:
            main = (q, k, v, do, outs, variant)
        else:
            del q, k, v, do, outs
    q, k, v, do, (out, lse, dq, dk, dv, idx, rev, plan), variant = main
    torch.cuda.empty_cache()
    kw = dict(plan=plan, variant=variant)
    delta = sf.block_sparse_flash_bwd_delta(out, do)
    if variant == "wgmma":
        kw["delta"] = delta
    ms = {"fwd": time_ms(lambda: sf.block_sparse_flash_attention(
              q, k, v, idx, block, False, return_lse=True, plan=plan)),
          "delta": time_ms(lambda: sf.block_sparse_flash_bwd_delta(out, do)),
          "dq": time_ms(lambda: sf.block_sparse_flash_dq(
              q, k, v, idx, out, do, lse, block, False, **kw)),
          "dkv": time_ms(lambda: sf.block_sparse_flash_dkv(
              q, k, v, idx, rev, out, do, lse, block, False, **kw))}
    mma = {"fwd": time_ms(lambda: sf.block_sparse_flash_attention(
               q, k, v, idx, block, False, return_lse=True, variant="mma")),
           "dq": time_ms(lambda: sf.block_sparse_flash_dq(
               q, k, v, idx, out, do, lse, block, False, variant="mma")),
           "dkv": time_ms(lambda: sf.block_sparse_flash_dkv(
               q, k, v, idx, rev, out, do, lse, block, False,
               variant="mma"))}
    plain = {"fwd": time_ms(lambda: sf.block_sparse_flash_attention_reference(
                 q, k, v, idx, block, False), iters=3, warmup=1),
             "delta": time_ms(
                 lambda: sf.block_sparse_flash_bwd_delta_reference(out, do),
                 iters=3, warmup=1),
             "dq": time_ms(lambda: sf.block_sparse_flash_dq_reference(
                 q, k, v, idx, out, do, lse, block, False), iters=3,
                 warmup=1),
             "dkv": time_ms(lambda: sf.block_sparse_flash_dkv_reference(
                 q, k, v, idx, out, do, lse, block, False), iters=3,
                 warmup=1)}
    mask = dense_mask(torch, np, main_layout, block, False, dev)
    lib_fwd, lib_bwd = sdpa_times(torch, q, k, v, do, mask)
    del mask
    lib_delta = time_ms(lambda: torch.einsum("bshd,bshd->bhs", out.float(),
                                             do.float()))
    work = sparse_work(np, main_layout, block, False, B, S, H, D)
    shape = (f"q/k/v [{B},{S},{H},{D}] bf16, layout {name} (block {block}, "
             f"density {main_layout.mean():.4f})")
    bwd = ms["dq"] + ms["dkv"] + (ms["delta"] if variant == "wgmma" else 0)
    print(f"  block-sparse backward at the main shape on {variant} "
          f"({walk_text(plan)}): delta {ms['delta']:.4f}, dq "
          f"{ms['dq']:.4f}, dk/dv {ms['dkv']:.4f} ms, together "
          f"{bwd:.4f} ms ({bwd / lib_bwd:.3f}x SDPA's backward "
          f"{lib_bwd:.4f} ms); the mma.sync pair here: dq {mma['dq']:.4f}, "
          f"dk/dv {mma['dkv']:.4f} ms; forward on "
          f"{sf.fwd_variant(q.dtype, D, block)} {ms['fwd']:.4f} ms, the "
          f"mma.sync forward {mma['fwd']:.4f} ms")
    rows = []
    for kname, line in (("fwd", "sparse_flash.py:149"),
                        ("dq", "sparse_flash.py:299"),
                        ("dkv", "sparse_flash.py:329")):
        bms, by = bound_ms(*work[kname])
        rows.append(dict(
            name=f"sparse_{kname}", route="cuda",
            source="deepspeed_tpu_torch/csrc/sparse_flash.cu",
            replaces=f"deepspeed_tpu/ops/{line}", shape=shape,
            max_abs_err=max(errs[kname]), ms=ms[kname],
            plain_ms=plain[kname], bound_ms=bms, bound_by=by,
            library_ms=lib_fwd if kname == "fwd" else lib_bwd,
            library_note="SDPA with the layout as a dense boolean mask"
                         + ("" if kname == "fwd" else
                            ": backward (fwd+bwd less fwd), dq, dk and dv "
                            "in one call")))
        walk = {"fwd": plan.fwd, "dq": plan.dq, "dkv": plan.dkv}[kname]
        rows[-1].update(variant=sf.fwd_variant(q.dtype, D, block)
                        if kname == "fwd" else variant,
                        mma_sync_ms=mma[kname], owners=walk.owners,
                        grouping=walk.grouping, padding=walk.padding)
        print(f"  sparse_{kname} at the main shape: {ms[kname]:.4f} ms "
              f"(bound {bms:.4f} ms, {by}), plain {plain[kname]:.4f} ms, "
              f"SDPA {rows[-1]['library_ms']:.4f} ms")
    # out and dO read, delta written: one f32 per row
    q_like = B * S * H * D
    bms, by = bound_ms(2 * q_like, 2 * 2 * q_like + 4 * B * H * S)
    rows.append(dict(
        name="sparse_bwd_delta", route="cuda",
        source="deepspeed_tpu_torch/csrc/sparse_flash.cu",
        replaces="deepspeed_tpu/ops/sparse_flash.py:293",
        replaces_note="delta = rowsum(dO * O), computed once in the TPU's "
                      "block_sparse_flash_backward (:293) for both kernels: "
                      "part of rows 12 and 13",
        shape=shape, max_abs_err=max(errs["delta"]), ms=ms["delta"],
        plain_ms=plain["delta"], bound_ms=bms, bound_by=by,
        library_ms=lib_delta,
        library_note="torch.einsum('bshd,bshd->bhs') over f32 copies"))
    print(f"  sparse_bwd_delta at the main shape: {ms['delta']:.4f} ms "
          f"(bound {bms:.4f} ms, {by}), plain {plain['delta']:.4f} ms, "
          f"einsum {lib_delta:.4f} ms")
    return rows


# ----------------------------------------------------------------------
# phase 10: block-sparse attention through SparseSelfAttention
# ----------------------------------------------------------------------
def sparse_path(torch, np, sa, sf, fa, counters, shape=SPARSE_SHAPE,
                dev="cuda"):
    """Phase 10 (see the module docstring)."""
    B, S, H, D = shape
    g = torch.Generator(device=dev).manual_seed(10)
    base = [torch.randn(B, S, H, D, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(3)]
    total = {c.__name__: 0 for c in counters}
    total_by = {fn_: dict.fromkeys(by, 0)
                for fn_, by in by_variant(counters).items()}
    results = []
    for name, cfg in sparse_layouts(sa, H):
        attn = sa.SparseSelfAttention(cfg)
        block, causal = cfg.block, attn.causal
        layout = attn.layout(S)
        qkv = [t.clone().requires_grad_() for t in base]
        # the first call builds and caches the tables; time the host side
        # of the second (no sync: the launches only)
        with torch.no_grad():
            attn(*qkv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            attn(*qkv)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        _, (idx, rev, plan) = attn.tables(S, dev)
        variant = sf.bwd_variant(torch.bfloat16, D, block)
        reset_counts(counters)
        out = attn(*qkv)
        (out.float() ** 2).sum().backward()
        out = out.detach()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        variants = by_variant(counters)
        for k_, n in launches.items():
            total[k_] += n
        for fn_, by in variants.items():
            for v_, n in by.items():
                total_by[fn_][v_] += n
        # the plain versions on the same inputs and residuals
        q, k, v = (t.detach() for t in qkv)
        with torch.no_grad():
            out2, lse = sf.block_sparse_flash_attention(
                q, k, v, idx, block, causal, return_lse=True, plan=plan)
            ref, ref_lse = sf.block_sparse_flash_attention_reference(
                q, k, v, idx, block, causal)
            do = (2 * out2.float()).to(out2.dtype)   # d(sum out^2)/d out
            rdq, rdk, rdv = sf.block_sparse_flash_backward_reference(
                q, k, v, idx, out2, do, lse, block, causal)
        same = torch.equal(out, out2)
        res = {n: bwd_close(t.grad, r, BWD_RTOL, BWD_ATOL_REL)
               for n, t, r in zip(("dq", "dk", "dv"), qkv, (rdq, rdk, rdv))}
        el = max_err(lse, ref_lse)
        finite = all(bool(torch.isfinite(t.grad).all()) for t in qkv)
        del rdq, rdk, rdv, ref_lse
        # the caching allocator releases what the plain versions held;
        # every time of this phase is from CUDA events (`event_time_ms`)
        torch.cuda.empty_cache()
        fwd_ms = event_time_ms(lambda: sf.block_sparse_flash_attention(
            q, k, v, idx, block, causal, return_lse=True, plan=plan))
        bwd_ms = event_time_ms(lambda: sf.block_sparse_flash_backward(
            q, k, v, idx, rev, out2, do, lse, block, causal, plan=plan))
        work = sparse_work(np, layout, block, causal, B, S, H, D)
        fwd_bound = bound_ms(*work["fwd"])
        bwd_bound = bound_ms(*work["bwd"])
        mask = dense_mask(torch, np, layout, block, causal, dev)
        sdpa_fwd, sdpa_bwd = sdpa_times(torch, q, k, v, do, mask,
                                        event_time_ms)
        del mask
        row = dict(layout=name, clock="cuda_events", block=block, causal=causal,
                   density=float(layout.mean()),
                   max_active_blocks=int(layout.sum(-1).max()),
                   launches=launches, launches_by_variant=variants,
                   variant=variant, walks=walk_text(plan), host_ms=host_ms,
                   max_abs_dout=max_err(out, ref), max_abs_dlse=el,
                   rel_grad_err={n: r[1] for n, r in res.items()},
                   fwd_ms=fwd_ms, fwd_bwd_ms=fwd_ms + bwd_ms,
                   fwd_bound_ms=fwd_bound[0],
                   fwd_bound_by=fwd_bound[1], bwd_ms=bwd_ms,
                   bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
                   sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd)
        if causal:
            # the port's dense causal flash kernels at the same shape
            dout, dlse = fa.flash_attention_fwd(q, k, v, causal=True)
            row["dense_flash_fwd_ms"] = event_time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal=True))
            row["dense_flash_bwd_ms"] = sum(time_flash_bwd(
                fa, q, k, v, dout, dlse, do, event_time_ms).values())
            del dout, dlse
        print(f"phase 10: {name} (block {block}, "
              f"{'causal' if causal else 'bidirectional'}): density "
              f"{row['density']:.4f} (max {row['max_active_blocks']} of "
              f"{S // block} blocks a row); launches {launches}, by "
              f"variant {variants} ({variant}: {walk_text(plan)}); host side "
              f"of one call {host_ms:.2f} ms; out == kernel rerun: {same}, "
              f"max|dout| vs plain {row['max_abs_dout']:.3e}, max|dlse| "
              f"{el:.3e}; grads max|d| / max|plain| " + ", ".join(
                  f"{n} {r[1]:.3e}" for n, r in res.items())
              + f"; CUDA-event times: forward ({variant}) {fwd_ms:.3f} ms "
              f"(bound {fwd_bound[0]:.4f}, "
              f"{fwd_bound[1]}), backward {bwd_ms:.3f} ms, together "
              f"{fwd_ms + bwd_ms:.3f} ms (bound "
              f"{bwd_bound[0]:.4f}, {bwd_bound[1]}); SDPA with the dense "
              f"mask {sdpa_fwd:.3f} / {sdpa_bwd:.3f} ms" + (
                  f"; dense flash kernels {row['dense_flash_fwd_ms']:.3f} / "
                  f"{row['dense_flash_bwd_ms']:.3f} ms" if causal else ""))
        want = {c.__name__: 1 for c in counters}
        want["block_sparse_flash_bwd_delta"] = int(variant == "wgmma")
        if launches != want or any(by[variant] != 1
                                   for by in variants.values()):
            fail(f"{name}: launches {launches}, by variant {variants}; want "
                 f"{want}, dq and dk/dv on {variant}")
        if not (same and kernel_close(out, ref) and el <= LSE_ATOL
                and finite and all(r[0] for r in res.values())):
            fail(f"{name}: SparseSelfAttention disagrees with the plain "
                 f"versions: out equal {same}, out {row['max_abs_dout']} "
                 f"(tol {TOL_TEXT}), lse {el}, grads {res} (tol "
                 f"{BWD_TOL_TEXT}), finite {finite}")
        results.append(row)
        del out, out2, ref, lse, do, qkv, q, k, v
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    gate = pair_gate(torch, np, sa, sf, shape, dev)
    return dict(layouts=results, launches=total, launches_by_variant=total_by,
                shape=list(shape), pair_gate=gate)


def sweep_layouts(np, sa, H, S):
    """Phase 10's pair-gate sweep at blocks 16 and 32: (name, layout,
    block, causal) from the port's sparsity configs (their causal rule as
    SparseSelfAttention takes it) and layouts whose visitor lists
    scatter."""
    cfgs = [("fixed16", sparse_layouts(sa, H)[0][1]),
            ("fixed16_causal", sa.FixedSparsityConfig(
                num_heads=H, block=16, num_local_blocks=4,
                attention="unidirectional")),
            ("bigbird16", sa.BigBirdSparsityConfig(num_heads=H, block=16)),
            ("longformer16", sa.BSLongformerSparsityConfig(num_heads=H,
                                                           block=16)),
            ("variable16", sa.VariableSparsityConfig(num_heads=H, block=16)),
            ("diagonal16_causal", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=16, num_sliding_window_blocks=1)),
            ("sliding16_causal", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=16)),
            ("sliding16_w7_causal", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=16, num_sliding_window_blocks=7)),
            ("sliding16_w16_causal", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=16, num_sliding_window_blocks=16)),
            ("bigbird32", sa.BigBirdSparsityConfig(num_heads=H, block=32)),
            ("fixed32_causal", sa.FixedSparsityConfig(
                num_heads=H, block=32, num_local_blocks=4,
                attention="unidirectional")),
            ("sliding32_causal", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=32))]
    out = [(n, c.make_layout(S), c.block, sa.SparseSelfAttention(c).causal)
           for n, c in cfgs]
    return out + [(f"random{b}_x{r}", scattered_layout(np, H, S // b, r), b,
                   False) for b, r in ((16, 2), (16, 5), (16, 16), (32, 2))]


# the routed pair may be this much slower than the other pair before the
# gate calls the rule wrong (timing noise is a few percent)
PAIR_GATE = 1.25


def pair_gate(torch, np, sa, sf, shape, dev="cuda"):
    """Per sweep layout: the pair `bwd_variant` routes to and the other
    bf16 pair (the wgmma pair with its delta launch, the mma.sync pair
    computing delta inside), each backward's device time from a CUDA graph
    of 20 calls (`graph_time_ms`) in the same call, and their gradients
    against each other; the same for the forward kernel `fwd_variant`
    routes to and the other (outputs within the forward tolerance of each
    other); fails where a routed kernel is more than PAIR_GATE slower."""
    B, S, H, D = shape
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    rows = []
    for name, layout, block, causal in sweep_layouts(np, sa, H, S):
        kidx = sa._layout_to_gather(layout)
        idx, rev, plan = sa._device_tables(kidx, dev, block)
        routed = sf.bwd_variant(q.dtype, D, block)
        other = "mma" if routed == "wgmma" else "wgmma"
        out, lse = sf.block_sparse_flash_attention(q, k, v, idx, block,
                                                   causal, return_lse=True)

        def run(variant):
            return sf.block_sparse_flash_backward(
                q, k, v, idx, rev, out, do, lse, block, causal, plan=plan,
                variant=variant)

        def fwd(variant):
            return sf.block_sparse_flash_attention(
                q, k, v, idx, block, causal, return_lse=True, plan=plan,
                variant=variant)

        fms = {p: graph_time_ms(lambda: fwd(p)) for p in (routed, other)}
        outs = {p: fwd(p) for p in (routed, other)}
        fwd_err = max(max_err(outs["wgmma"][0], outs["mma"][0]),
                      max_err(outs["wgmma"][1], outs["mma"][1]))
        fwd_ok = (kernel_close(outs["wgmma"][0], outs["mma"][0])
                  and max_err(outs["wgmma"][1], outs["mma"][1]) <= LSE_ATOL)
        del outs
        ms = {p: graph_time_ms(lambda: run(p)) for p in (routed, other)}
        grads = {p: run(p) for p in (routed, other)}
        rel = {n: bwd_close(a, b, BWD_RTOL, BWD_ATOL_REL)[1]
               for n, a, b in zip(("dq", "dk", "dv"), grads["wgmma"],
                                  grads["mma"])}
        row = dict(layout=name, block=block, causal=causal,
                   density=float(layout.mean()),
                   mean_visits=float(layout.sum(-1).mean()), routed=routed,
                   ms={p: float(t) for p, t in ms.items()},
                   ratio=float(ms[other] / ms[routed]),
                   fwd_routed=sf.fwd_variant(q.dtype, D, block),
                   fwd_ms={p: float(t) for p, t in fms.items()},
                   fwd_ratio=float(fms[other] / fms[routed]),
                   fwd_max_abs_wgmma_vs_mma=fwd_err,
                   walks=walk_text(plan), rel_wgmma_vs_mma=rel,
                   clock="cuda_graph")
        rows.append(row)
        print(f"phase 10: pair gate at {name} (block {block}, "
              f"{'causal' if causal else 'bidirectional'}, density "
              f"{row['density']:.4f}, {row['mean_visits']:.2f} blocks a row; "
              f"{walk_text(plan)}): routed to {routed}; wgmma (delta + dq "
              f"+ dk/dv) {ms['wgmma']:.4f} ms, mma.sync (dq + dk/dv) "
              f"{ms['mma']:.4f} ms: routed {row['ratio']:.2f}x as fast; "
              f"grads max|wgmma - mma| / max|mma| " + ", ".join(
                  f"{n} {r:.3e}" for n, r in rel.items())
              + f"; forward wgmma {fms['wgmma']:.4f} ms, mma.sync "
              f"{fms['mma']:.4f} ms: routed {row['fwd_ratio']:.2f}x as fast, "
              f"max|wgmma - mma| {fwd_err:.3e}")
        if row["fwd_routed"] != routed:
            fail(f"forward gate at {name}: the forward routes to "
                 f"{row['fwd_routed']}, the backward to {routed}")
        if fms[routed] > PAIR_GATE * fms[other]:
            fail(f"forward gate at {name}: the routed {routed} forward takes "
                 f"{fms[routed]:.4f} ms, the {other} one {fms[other]:.4f} ms "
                 f"(more than {PAIR_GATE}x): the forward's rule is wrong here")
        if not fwd_ok:
            fail(f"forward gate at {name}: the two forward kernels differ by "
                 f"{fwd_err} (tol {TOL_TEXT}, lse {LSE_ATOL})")
        if ms[routed] > PAIR_GATE * ms[other]:
            fail(f"pair gate at {name}: the routed {routed} pair takes "
                 f"{ms[routed]:.4f} ms, the {other} pair {ms[other]:.4f} ms "
                 f"(more than {PAIR_GATE}x): the variant rule is wrong here")
        if max(rel.values()) > 2 * BWD_ATOL_REL:
            fail(f"pair gate at {name}: the two pairs' gradients differ by "
                 f"{rel} of max|mma|")
        del out, lse, grads
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# phase 1: the Evoformer kernels
# ----------------------------------------------------------------------
def evo_inputs(torch, g, dev, B, N, L, H, D, dtype, which="both",
               mask_row=False):
    """q, k, v in `dtype`, a f32 mask bias with EVO_MASKED of its keys at
    -1e9 (with `mask_row`, row 0 at -1e30 on every key) and a bf16 pair
    bias; `which` keeps "b1", "b2", "both" or "none" of the biases."""
    q, k, v = (torch.randn(B, N, L, H, D, generator=g, device=dev,
                           dtype=dtype) for _ in range(3))
    b1 = torch.where(torch.rand(B, N, 1, 1, L, generator=g, device=dev)
                     < EVO_MASKED, -1e9, 0.0)
    if mask_row:
        b1[0, 0] = -1e30
    b2 = torch.randn(B, 1, H, L, L, generator=g, device=dev,
                     dtype=torch.bfloat16)
    return (q, k, v, b1 if which in ("b1", "both") else None,
            b2 if which in ("b2", "both") else None)


def evo_work(q, b1, b2, need_db1):
    """(FLOPs, bytes) of each Evoformer kernel and of the whole backward:
    2 D FLOPs per product element over the B*N*H*L*L scores, 2 products in
    the forward, 3 in dq, 4 in dk/dv, 2 in db2 and 5 in the backward
    (dq, dk, dv need S and dP); every input read once, every output
    written once, delta [B*N, H, L] f32 an output of dq and an input of
    dk/dv and db2."""
    B, N, L, H, D = q.shape
    t = q.numel() * q.element_size()
    rows = B * N * H * L * 4
    bias = sum(b.numel() * b.element_size() for b in (b1, b2)
               if b is not None)
    db1 = b1.numel() * b1.element_size() if need_db1 else 0
    db2 = b2.numel() * b2.element_size() if b2 is not None else 0
    f = 2 * D * B * N * H * L * L
    return {"fwd": (2 * f, 3 * t + bias + t + rows),
            "dq": (3 * f, 5 * t + rows + bias + t + rows),
            "dkv": (4 * f, 4 * t + 2 * rows + bias + 2 * t + db1),
            "db2": (2 * f, 4 * t + 2 * rows + bias + db2),
            "bwd": (5 * f, 5 * t + rows + bias + 3 * t + db1 + db2)}


def evo_close(got, ref):
    """The backward limit for a gradient, by its dtype: (ok, max|d| /
    max|plain|)."""
    import torch
    bf = got.dtype == torch.bfloat16
    return bwd_close(got, ref, BWD_RTOL if bf else 0.0,
                     BWD_ATOL_REL if bf else BWD_F32_REL)


def evo_sdpa_times(torch, q, k, v, b1, b2, do, timer=time_ms):
    """SDPA over [B*N, H, L, D] with b1 + b2 summed into one dense float
    mask [B*N, H, L, L] in q's dtype that requires grad where the backend
    gives its gradient: (forward ms, backward ms as forward + backward
    less forward, the backend, whether the mask's gradient was taken)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, N, L, H, D = q.shape
    qt, kt, vt, dot = (t.reshape(B * N, L, H, D).transpose(1, 2)
                       .contiguous() for t in (q, k, v, do))
    mask = torch.zeros(B, N, H, L, L, device=q.device)
    for b in (b1, b2):
        if b is not None:
            mask = mask + b.float()
    mask = mask.reshape(B * N, H, L, L).to(q.dtype)
    for backend, mask_grad in ((SDPBackend.EFFICIENT_ATTENTION, True),
                               (SDPBackend.MATH, True)):
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        m = mask.detach().requires_grad_(mask_grad)
        wrt = leaves + ([m] if mask_grad else [])

        def fwd():
            with torch.no_grad(), sdpa_kernel([backend]):
                F.scaled_dot_product_attention(*leaves, attn_mask=m)

        def fwd_bwd():
            with sdpa_kernel([backend]):
                o = F.scaled_dot_product_attention(*leaves, attn_mask=m)
            torch.autograd.grad(o, wrt, dot)

        try:
            fwd_bwd()
        except RuntimeError as err:
            print(f"  (SDPA {backend.name} with mask grad {mask_grad}: "
                  f"{str(err).splitlines()[0][:120]})")
            continue
        f = timer(fwd, iters=5, warmup=1)
        b = timing_less(timer(fwd_bwd, iters=5, warmup=1), f)
        return f, b, backend.name, mask_grad
    fail("no SDPA backend runs the Evoformer shapes with a dense mask")


# the routed Evoformer forward and db2 may take this much longer than the
# first kernels (`variant="mma"`), timed in the same call, before the gate
# calls the rule wrong
EVO_GATE = 1.05


def evo_gate(torch, ef, desc, q, k, v, b1, b2, do, lse, delta,
             timer=graph_time_ms):
    """The forward and (with a pair bias) db2 on the kernels their rules
    route to and on the first kernels ("mma"), timed in turns (first,
    routed, routed, first; CUDA graphs of 20 calls: device time without
    host gaps) in this call; fails where a routed kernel takes more than
    EVO_GATE times the first.  Returns {kernel: {variant, ms, first_ms,
    ratio}} (ms None where the rule routes to the first kernel)."""
    B, N, L, H, D = q.shape
    calls = {"fwd": (ef.fwd_variant(q.dtype, D, L, bias_dtype(b2)),
                     lambda vr: ef.evoformer_flash_forward(
                         q, k, v, b1, b2, return_lse=True, variant=vr))}
    if b2 is not None:
        calls["db2"] = (ef.db2_variant(q.dtype, D, L, N),
                        lambda vr: ef.evoformer_flash_db2(
                            q, k, v, b1, b2, do, lse, delta, variant=vr))
    res = {}
    for name, (routed, call) in calls.items():
        if routed == "mma":
            res[name] = dict(variant=routed, ms=None, first_ms=None,
                             ratio=None)
            continue
        t = {"mma": [], routed: []}
        for vr in ("mma", routed, routed, "mma"):
            t[vr].append(float(timer(lambda: call(vr))))
        ms, first = sum(t[routed]) / 2, sum(t["mma"]) / 2
        res[name] = dict(variant=routed, ms=ms, first_ms=first,
                         ratio=ms / first)
        if ms > EVO_GATE * first:
            fail(f"Evoformer gate at {desc}: the routed {name} kernel "
                 f"({routed}) takes {ms:.4f} ms, the first kernel "
                 f"{first:.4f} ms (more than {EVO_GATE}x): route this shape "
                 f"to the first kernel")
    return res


def bias_dtype(b2):
    """The pair bias's dtype as the forward's rule takes it (None: no pair
    bias)."""
    return None if b2 is None else b2.dtype


def gate_text(gate):
    return ", ".join(
        f"{n} {g['variant']}" + ("" if g["ms"] is None else
                                 f" {g['ms']:.4f} ms vs first "
                                 f"{g['first_ms']:.4f} ({g['ratio']:.2f}x)")
        for n, g in gate.items())


# (B, N, L, H, D, dtype, biases, a fully masked row): phase 12's MSA row
# shape first (timed), then D 8 (the extra-MSA width), AlphaFold 2's
# fine-tuning crop (L 384) at the MSA row's and the extra-MSA row's widths
# with N cut to 32 and 64, D 64 with the mask bias only, D 128 with the
# pair bias only, f32, a tail (L 100) with a fully masked row, no bias at
# D 16
def evo_cases(torch):
    bf16, f32 = torch.bfloat16, torch.float32
    return [EVO_SHAPES[0][1] + (bf16, "both", False),
            (1, 16, 256, 8, 8, bf16, "both", False),
            (1, 32, 384, 8, 32, bf16, "both", False),
            (1, 64, 384, 8, 8, bf16, "both", False),
            (1, 8, 128, 4, 64, bf16, "b1", False),
            (1, 4, 128, 2, 128, bf16, "b2", False),
            (1, 4, 128, 4, 32, f32, "both", False),
            (1, 4, 100, 4, 32, bf16, "both", True),
            (1, 4, 64, 2, 16, bf16, "none", False)]


def evo_first_errors(torch, ef, q, k, v, b1, b2, do, lse, delta, ref,
                     ref_lse, want_db2, mask_row):
    """The first forward and (with a pair bias) db2 kernels (`variant=
    "mma"`) against the plain versions' out, lse and db2, with the limits
    the routed kernels are held to (and, with a fully masked row, its out
    0 and lse at the mask level).  Returns {out, lse, db2 (evo_close's
    pair or None), db2_abs, ok}."""
    out, lse1 = ef.evoformer_flash_forward(q, k, v, b1, b2, return_lse=True,
                                           variant="mma")
    db2 = (ef.evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta,
                                  variant="mma") if b2 is not None else None)
    torch.cuda.synchronize()
    B, N, L, H, _ = q.shape
    el = max_err(lse1, ref_lse)
    res = evo_close(db2, want_db2) if db2 is not None else None
    ok = kernel_close(out, ref) and el <= LSE_ATOL and (res is None
                                                        or res[0])
    if mask_row:
        ok = ok and bool((out[0, 0] == 0).all()) and float(
            lse1.view(B, N, H, L)[0, 0].max()) <= -1e29
    return dict(out=max_err(out, ref), lse=el, db2=res,
                db2_abs=max_err(db2, want_db2) if db2 is not None else 0.0,
                ok=ok)


def check_evoformer(torch, ef, dev):
    """The forward, dq, dk/dv (+db1) and db2 kernels against their plain
    versions at `evo_cases`; the backward run twice (bit-identical);
    timed at phase 12's MSA row shape beside SDPA with the summed bias as
    a dense mask."""
    g = torch.Generator(device=dev).manual_seed(12)
    errs = {n: [] for n in ("fwd", "dq", "dkv", "db2", "db1")}
    rel = {n: 0.0 for n in ("dq", "dk", "dv", "db1", "db2")}
    pair = [ef.evoformer_flash_dq, ef.evoformer_flash_dkv]
    fwd_db2 = [ef.evoformer_flash_forward, ef.evoformer_flash_db2]
    main, gates = None, {}
    for B, N, L, H, D, dt, which, mask_row in evo_cases(torch):
        q, k, v, b1, b2 = evo_inputs(torch, g, dev, B, N, L, H, D, dt,
                                     which, mask_row)
        do = torch.randn(B, N, L, H, D, generator=g, device=dev, dtype=dt)
        reset_counts(pair + fwd_db2)
        out, lse = ef.evoformer_flash_forward(q, k, v, b1, b2,
                                              return_lse=True)
        ref, ref_lse = ef.evoformer_flash_forward_reference(q, k, v, b1, b2)
        dq, delta = ef.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
        dk, dv, db1 = ef.evoformer_flash_dkv(q, k, v, b1, b2, do, lse,
                                             delta)
        db2 = (ef.evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta)
               if b2 is not None else None)
        again = ef.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
        want = ef.evoformer_flash_backward_reference(q, k, v, b1, b2, out,
                                                     do, lse)
        torch.cuda.synchronize()
        got = (dq, dk, dv, db1, db2)
        bf = dt == torch.bfloat16
        fwd_ok = (kernel_close(out, ref) if bf else
                  max_err(out, ref) <= BWD_F32_REL * max(
                      float(ref.abs().max()), 1.0))
        el = max_err(lse, ref_lse)
        ed = max_err(delta, ef._delta(out, do))
        res = {n: evo_close(a, b) for n, a, b in zip(
            ("dq", "dk", "dv", "db1", "db2"), got, want) if b is not None}
        same = all(a is None or torch.equal(a, b)
                   for a, b in zip(got, again))
        desc = (f"B={B} N={N} L={L} H={H} D={D} {str(dt)[6:]} biases "
                f"{which}" + (" masked row" if mask_row else ""))
        # dq and dk/dv ran twice each, all on the pair bwd_variant names
        # (bf16 at D 32, 64 and 128 on the TMA + wgmma pair); the forward
        # once and db2 twice, on the kernels fwd_variant and db2_variant
        # name
        variant = ef.bwd_variant(dt, D, L)
        fv = ef.fwd_variant(dt, D, L, bias_dtype(b2))
        d2v = ef.db2_variant(dt, D, L, N)
        variants = by_variant(pair + fwd_db2)
        want_v = {c.__name__: {n: 2 if n == variant else 0
                               for n in c.launches_by_variant}
                  for c in pair}
        want_v["evoformer_flash_forward"] = {
            n: int(n == fv) for n in ef.FWD_VARIANTS}
        want_v["evoformer_flash_db2"] = {
            n: 2 * int(n == d2v and b2 is not None) for n in ef.DB2_VARIANTS}
        wgmma_ok = ((variant == "wgmma") == (bf and D in (32, 64, 128))
                    and (fv == "wgmma") == (bf and D in (32, 64, 128)
                                            and ef.fwd_smem(
                                                "wgmma", D, L,
                                                bias_dtype(b2))
                                            <= ef.SMEM_MAX))
        # the first forward and db2 kernels, which still serve bf16 at
        # long L and db2 at few rows, against the same plain versions
        first = evo_first_errors(torch, ef, q, k, v, b1, b2, do, lse,
                                 delta, ref, ref_lse, want[4],
                                 mask_row) if bf else {}
        gate = evo_gate(torch, ef, desc, q, k, v, b1, b2, do, lse,
                        delta) if bf else {}
        gates[desc] = gate
        print(f"  evoformer {desc}: max|dout|={max_err(out, ref):.3e} "
              f"max|dlse|={el:.3e} max|ddelta|={ed:.3e}; max|d| / "
              f"max|plain| " + ", ".join(f"{n} {r[1]:.3e}"
                                         for n, r in res.items())
              + f"; rerun bit-identical: {same}; dq and dk/dv on "
                f"{variant}, forward on {fv}, db2 on {d2v}"
              + (f"; first kernels max|dout|={first['out']:.3e} "
                 f"max|dlse|={first['lse']:.3e}"
                 + ("" if first["db2"] is None else
                    f" db2 max|d| / max|plain| {first['db2'][1]:.3e}")
                 if first else "")
              + (f"; gate (CUDA graphs, same call): {gate_text(gate)}"
                 if gate else ""))
        if variants != want_v or not wgmma_ok:
            fail(f"Evoformer kernels at {desc} ran {variants}, want "
                 f"{want_v} (bf16 at D 32, 64 and 128 on wgmma)")
        masked_ok = True
        if mask_row:
            masked_ok = (bool((out[0, 0] == 0).all())
                         and float(lse.view(B, N, H, L)[0, 0].max()) <= -1e29
                         and all(bool(torch.isfinite(t).all())
                                 for t in got if t is not None)
                         and bool((dq[0, 0] == 0).all()))
        if not (fwd_ok and el <= LSE_ATOL and ed <= 1e-5 * max(
                float(delta.abs().max()), 1.0) and same and masked_ok
                and all(r[0] for r in res.values())
                and (not first or first["ok"])):
            fail(f"Evoformer kernels disagree with their plain versions at "
                 f"{desc}: out {max_err(out, ref)} (tol {TOL_TEXT}), lse "
                 f"{el}, delta {ed}, backward {res} (tol {BWD_TOL_TEXT}), "
                 f"rerun equal {same}, masked row {masked_ok}; the first "
                 f"forward and db2 kernels {first}")
        errs["fwd"].append(max(max_err(out, ref), first.get("out", 0.0)))
        errs["dq"].append(max_err(dq, want[0]))
        errs["dkv"].append(max(max_err(dk, want[1]), max_err(dv, want[2])))
        if db1 is not None:
            errs["db1"].append(max_err(db1, want[3]))
        if db2 is not None:
            errs["db2"].append(max(max_err(db2, want[4]),
                                   first.get("db2_abs", 0.0)))
        for n, r in res.items():
            rel[n] = max(rel[n], r[1])
        if main is None:
            main = (q, k, v, b1, b2, out, lse, do, delta)
        del want, again, got, ref
    q, k, v, b1, b2, out, lse, do, delta = main
    torch.cuda.empty_cache()
    ms = {"fwd": time_ms(lambda: ef.evoformer_flash_forward(
              q, k, v, b1, b2, return_lse=True)),
          "dq": time_ms(lambda: ef.evoformer_flash_dq(
              q, k, v, b1, b2, out, do, lse)),
          "dkv": time_ms(lambda: ef.evoformer_flash_dkv(
              q, k, v, b1, b2, do, lse, delta)),
          "db2": time_ms(lambda: ef.evoformer_flash_db2(
              q, k, v, b1, b2, do, lse, delta))}
    # the first forward and db2 kernels, which the new ones replaced
    first = {"fwd": time_ms(lambda: ef.evoformer_flash_forward(
                 q, k, v, b1, b2, return_lse=True, variant="mma")),
             "db2": time_ms(lambda: ef.evoformer_flash_db2(
                 q, k, v, b1, b2, do, lse, delta, variant="mma"))}
    plain = {"fwd": time_ms(lambda: ef.evoformer_flash_forward_reference(
                 q, k, v, b1, b2), iters=3, warmup=1),
             "dq": time_ms(lambda: ef.evoformer_flash_dq_reference(
                 q, k, v, b1, b2, out, do, lse), iters=3, warmup=1),
             "dkv": time_ms(lambda: ef.evoformer_flash_dkv_reference(
                 q, k, v, b1, b2, do, lse, delta), iters=3, warmup=1),
             "db2": time_ms(lambda: ef.evoformer_flash_db2_reference(
                 q, k, v, b1, b2, do, lse, delta), iters=3, warmup=1)}
    lib_fwd, lib_bwd, backend, mask_grad = evo_sdpa_times(
        torch, q, k, v, b1, b2, do)
    work = evo_work(q, b1, b2, need_db1=True)
    B, N, L, H, D = q.shape
    shape = (f"q/k/v [{B},{N},{L},{H},{D}] bf16, b1 f32 ({EVO_MASKED:.0%} "
             f"of keys at -1e9), b2 bf16 (AlphaFold 2 MSA row attention)")
    note_bwd = (f"SDPA backward ({backend}, fwd+bwd less fwd): dq, dk, dv"
                + (" and the dense mask's gradient" if mask_grad else
                   " (no mask gradient)") + " in one call")
    rows = []
    for name, kname, line, kernel in (
            ("evo_fwd", "fwd", "evoformer_flash.py:156", "fwd"),
            ("evo_fwd_dmajor", "fwd", "evoformer_flash.py:613", "fwd"),
            ("evo_dq", "dq", "evoformer_flash.py:379", "dq"),
            ("evo_dkv", "dkv", "evoformer_flash.py:405", "dkv"),
            ("evo_db2", "db2", "evoformer_flash.py:442", "db2"),
            ("evo_db1", "dkv", "evoformer_flash.py:479", "db1")):
        bms, by = bound_ms(*work[kname])
        row = dict(name=name, route="cuda",
                   source="deepspeed_tpu_torch/csrc/evoformer_flash.cu",
                   replaces=f"deepspeed_tpu/ops/{line}", shape=shape,
                   max_abs_err=max(errs[kernel]), ms=ms[kname],
                   plain_ms=plain[kname], bound_ms=bms, bound_by=by,
                   library_ms=lib_fwd if kname == "fwd" else lib_bwd,
                   library_note=(f"SDPA forward ({backend}) with b1 + b2 as "
                                 f"a dense float mask" if kname == "fwd"
                                 else note_bwd))
        if name == "evo_fwd_dmajor":
            row["note"] = ("the TPU's D-major twin of the forward; the same "
                           "kernel here")
        if name == "evo_db1":
            row["note"] = ("the dk/dv kernel's epilogue (its ms and bound "
                           "are the dk/dv kernel's with db1)")
        if kname in ("dq", "dkv"):
            row["variant"] = ef.bwd_variant(q.dtype, D, L)
        if kname in first:
            row["variant"] = (ef.fwd_variant(q.dtype, D, L, bias_dtype(b2))
                              if kname == "fwd"
                              else ef.db2_variant(q.dtype, D, L, N))
            row["first_ms"] = first[kname]
            row["gate"] = gates[next(iter(gates))][kname]
        rows.append(row)
    print(f"  Evoformer at the MSA row shape: " + ", ".join(
        f"{r['name']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
        f"{r['bound_by']}, plain {r['plain_ms']:.4f}"
        + (f", first kernel {r['first_ms']:.4f}" if "first_ms" in r else "")
        + ")" for r in rows if r["name"] not in ("evo_fwd_dmajor", "evo_db1"))
        + f"; SDPA {backend} {lib_fwd:.4f} / {lib_bwd:.4f} ms (mask grad "
          f"{mask_grad}); highest max|d| / max|plain| " + ", ".join(
              f"{n} {r:.3e}" for n, r in rel.items()))
    return rows


def check_evoformer_edges(torch, evo, ef, dev):
    """Two layouts the reference takes that the kernels' grid and loads
    once refused: a bf16 mask bias sliced at an odd row (its view starts
    200 bytes into the storage, off the 16-byte boundary; the autograd
    Function copies it), forward and backward through
    `evoformer_attention` against its plain path; and B*N = 70000 rows at
    a small L, H and D (past the 65535 grid limit: the kernels walk the
    rows with grid-stride loops), every kernel against its plain
    version.  Returns the largest errors."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf16 = torch.bfloat16
    B, N, L, H, D = 1, 8, 100, 2, 32
    q, k, v = (torch.randn(B, N, L, H, D, generator=g, device=dev,
                           dtype=bf16) for _ in range(3))
    full = torch.randn(B, N + 1, 1, 1, L, generator=g, device=dev,
                       dtype=bf16)
    if full[:, 1:].data_ptr() % 16 == 0:
        fail("the sliced mask bias is not misaligned: the case tests nothing")
    got = {}
    for impl in ("auto", "jnp"):
        t = [x.clone().requires_grad_() for x in (q, k, v)]
        bb = full.clone().requires_grad_()
        out = evo.evoformer_attention(t[0], t[1], t[2], (bb[:, 1:],),
                                      impl=impl)
        (out.float() ** 2).sum().backward()
        got[impl] = [out.detach()] + [x.grad for x in t] + [bb.grad]
    torch.cuda.synchronize()
    out_ok = kernel_close(got["auto"][0], got["jnp"][0])
    grads = [evo_close(a, b) for a, b in zip(got["auto"][1:],
                                              got["jnp"][1:])]
    e_view = max_err(got["auto"][0], got["jnp"][0])
    print(f"  evoformer, mask bias sliced off the 16-byte boundary "
          f"[{B},{N},1,1,{L}] bf16: max|dout|={e_view:.3e}; max|d| / "
          f"max|plain| dq, dk, dv, db1 "
          + ", ".join(f"{r[1]:.3e}" for r in grads))
    if not (out_ok and all(r[0] for r in grads)):
        fail(f"evoformer_attention with a misaligned bias view disagrees "
             f"with its plain path: out {e_view}, grads {grads}")
    errs = [e_view]
    for dt in (bf16, torch.float32):
        q, k, v, b1, b2 = evo_inputs(torch, g, dev, 1, 70000, 16, 1, 8, dt)
        do = torch.randn_like(q)
        out, lse = ef.evoformer_flash_forward(q, k, v, b1, b2,
                                              return_lse=True)
        ref, ref_lse = ef.evoformer_flash_forward_reference(q, k, v, b1, b2)
        back = ef.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
        want = ef.evoformer_flash_backward_reference(q, k, v, b1, b2, out,
                                                     do, lse)
        torch.cuda.synchronize()
        bf = dt == bf16
        fwd_ok = (kernel_close(out, ref) if bf else
                  max_err(out, ref) <= BWD_F32_REL * max(
                      float(ref.abs().max()), 1.0))
        el = max_err(lse, ref_lse)
        res = [evo_close(a, b) for a, b in zip(back, want) if b is not None]
        print(f"  evoformer B*N=70000 L=16 H=1 D=8 {str(dt)[6:]} (grid "
              f"stride): max|dout|={max_err(out, ref):.3e} "
              f"max|dlse|={el:.3e}; max|d| / max|plain| dq, dk, dv, db1, "
              f"db2 " + ", ".join(f"{r[1]:.3e}" for r in res))
        if not (fwd_ok and el <= LSE_ATOL and all(r[0] for r in res)):
            fail(f"the Evoformer kernels disagree with their plain versions "
                 f"at B*N = 70000 ({dt}): out {max_err(out, ref)}, lse "
                 f"{el}, backward {res}")
        errs.append(max_err(out, ref))
        del q, k, v, b1, b2, do, out, lse, ref, ref_lse, back, want
    torch.cuda.empty_cache()
    return max(errs)


# ----------------------------------------------------------------------
# phase 12: Evoformer attention through evoformer_attention
# ----------------------------------------------------------------------
def evoformer_path(torch, evo, ef, counters, shapes=EVO_SHAPES,
                   dev="cuda"):
    """Phase 12 (see the module docstring)."""
    total = {c.__name__: 0 for c in counters}
    total_variants = {}
    results = []
    for name, shape, b1_grad in shapes:
        B, N, L, H, D = shape
        g = torch.Generator(device=dev).manual_seed(13)
        q, k, v, b1, b2 = evo_inputs(torch, g, dev, B, N, L, H, D,
                                     torch.bfloat16)
        b1.requires_grad_(b1_grad)
        leaves = [t.requires_grad_() for t in (q, k, v, b2)] + (
            [b1] if b1_grad else [])

        def run():
            for t in leaves:
                t.grad = None
            out = evo.evoformer_attention(q, k, v, (b1, b2))
            (out.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            return out.detach(), [t.grad for t in leaves]

        reset_counts(counters)
        out, grads = run()
        launches = {c.__name__: c.launches for c in counters}
        variants = by_variant(counters)
        for k_, n in launches.items():
            total[k_] += n
        for fn, counts in variants.items():
            acc = total_variants.setdefault(fn, dict.fromkeys(counts, 0))
            for v_, n in counts.items():
                acc[v_] += n
        out_again, grads_again = run()
        same = torch.equal(out, out_again) and all(
            torch.equal(a, b) for a, b in zip(grads, grads_again))
        del out_again, grads_again
        # the plain versions on the same inputs and residuals
        qd, kd, vd, b1d, b2d = (t.detach() for t in (q, k, v, b1, b2))
        with torch.no_grad():
            out2, lse = ef.evoformer_flash_forward(qd, kd, vd, b1d, b2d,
                                                   return_lse=True)
            ref, ref_lse = ef.evoformer_flash_forward_reference(
                qd, kd, vd, b1d, b2d)
            do = (2 * out2.float()).to(out2.dtype)   # d(sum out^2)/d out
            want = ef.evoformer_flash_backward_reference(
                qd, kd, vd, b1d, b2d, out2, do, lse, need_db1=b1_grad)
        names = ("dq", "dk", "dv", "db2") + (("db1",) if b1_grad else ())
        refs = want[:3] + (want[4],) + ((want[3],) if b1_grad else ())
        res = {n: evo_close(gr, r) for n, gr, r in zip(names, grads, refs)}
        el = max_err(lse, ref_lse)
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        max_dout = max_err(out, ref)
        out_ok = torch.equal(out, out2) and kernel_close(out, ref)
        del want, refs, ref, ref_lse, grads
        torch.cuda.empty_cache()
        fwd_ms = time_ms(lambda: ef.evoformer_flash_forward(
            qd, kd, vd, b1d, b2d, return_lse=True))
        bwd_ms = time_ms(lambda: ef.evoformer_flash_backward(
            qd, kd, vd, b1d, b2d, out2, do, lse, need_db1=b1_grad))
        _, delta = ef.evoformer_flash_dq(qd, kd, vd, b1d, b2d, out2, do, lse)
        kernel_ms = {
            "dq_ms": time_ms(lambda: ef.evoformer_flash_dq(
                qd, kd, vd, b1d, b2d, out2, do, lse)),
            "dkv_ms": time_ms(lambda: ef.evoformer_flash_dkv(
                qd, kd, vd, b1d, b2d, do, lse, delta, need_db1=b1_grad)),
            "db2_ms": time_ms(lambda: ef.evoformer_flash_db2(
                qd, kd, vd, b1d, b2d, do, lse, delta))}
        gate = evo_gate(torch, ef, name, qd, kd, vd, b1d, b2d, do, lse,
                        delta)
        work = evo_work(qd, b1d, b2d, b1_grad)
        fwd_bound, bwd_bound = bound_ms(*work["fwd"]), bound_ms(*work["bwd"])
        sdpa_fwd, sdpa_bwd, backend, mask_grad = evo_sdpa_times(
            torch, qd, kd, vd, b1d, b2d, do)
        row = dict(shape_name=name, shape=list(shape),
                   b1_requires_grad=b1_grad, launches=launches,
                   launches_by_variant=variants,
                   rerun_bit_identical=same,
                   max_abs_dout=max_dout, max_abs_dlse=el,
                   rel_grad_err={n: r[1] for n, r in res.items()},
                   fwd_ms=fwd_ms, fwd_bound_ms=fwd_bound[0],
                   fwd_bound_by=fwd_bound[1], bwd_ms=bwd_ms,
                   bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
                   sdpa_backend=backend, sdpa_mask_grad=mask_grad,
                   sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd, gate=gate,
                   **kernel_ms)
        row["clocks"] = clocks(row)
        print(f"phase 12: {name} q/k/v {list(shape)} (mask bias "
              f"{'requires' if b1_grad else 'without'} grad): launches "
              f"{launches}; rerun bit-identical: {same}; max|dout| vs plain "
              f"{max_dout:.3e}, max|dlse| {el:.3e}; grads max|d| / "
              f"max|plain| " + ", ".join(f"{n} {r[1]:.3e}"
                                        for n, r in res.items())
              + f"; forward {fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f}, "
              f"{fwd_bound[1]}), backward {bwd_ms:.4f} ms (bound "
              f"{bwd_bound[0]:.4f}, {bwd_bound[1]}): dq "
              f"{kernel_ms['dq_ms']:.4f}, dk/dv {kernel_ms['dkv_ms']:.4f}, "
              f"db2 {kernel_ms['db2_ms']:.4f}; launches by variant "
              f"{variants}; gate (CUDA graphs, same call): "
              f"{gate_text(gate)}; SDPA {backend} (mask grad {mask_grad}) "
              f"{sdpa_fwd:.4f} / {sdpa_bwd:.4f} ms; clocks {row['clocks']}")
        want_launches = {c.__name__: 1 for c in counters}
        want_launches["evoformer_flash_db1"] = int(b1_grad)
        if launches != want_launches:
            fail(f"{name}: launches {launches}, want {want_launches}")
        bf16 = torch.bfloat16
        rules = {"evoformer_flash_forward": ef.fwd_variant(bf16, D, L,
                                                           bias_dtype(b2)),
                 "evoformer_flash_dq": ef.bwd_variant(bf16, D, L),
                 "evoformer_flash_dkv": ef.bwd_variant(bf16, D, L),
                 "evoformer_flash_db2": ef.db2_variant(bf16, D, L, N)}
        want_variants = {fn: {v_: int(v_ == rules[fn]) for v_ in counts}
                         for fn, counts in variants.items()}
        if variants != want_variants:
            fail(f"{name}: the Evoformer kernels ran {variants}, want "
                 f"{want_variants}")
        if not (same and out_ok and el <= LSE_ATOL and finite
                and all(r[0] for r in res.values())):
            fail(f"{name}: evoformer_attention disagrees with the plain "
                 f"versions: rerun equal {same}, out {max_dout} (tol "
                 f"{TOL_TEXT}), lse {el}, grads {res} (tol {BWD_TOL_TEXT}),"
                 f" finite {finite}")
        results.append(row)
        del q, k, v, b1, b2, leaves, qd, kd, vd, b1d, b2d, out, out2, lse, do
        del delta
        torch.cuda.empty_cache()
    return dict(shapes=results, launches=total,
                launches_by_variant=total_variants)


# ----------------------------------------------------------------------
# phase 11: the 8-bit Adam training step with the fused update
# ----------------------------------------------------------------------
# phase 11's control runs: a fault planted in the fused engine
INT8_FAULTS = {"stale_params": "the bf16 parameters left stale: the "
                               "update's cast written into a copy",
               "no_bias_correction": "bias correction dropped"}


def int8_differences(got, plain):
    """`_steps` readings of a fused engine against the plain int8
    update's: (relative differences {"loss": [by step], "grad_norm":
    [...]}, the checks they fail: step 1 equal, later INT8_LATER_RTOL)."""
    rel = {key: [abs(a - b) / abs(b) for a, b in zip(got[j], plain[j])]
           for j, key in enumerate(("loss", "grad_norm"))}
    bad = [f"step 1 {key} {r:.3e} != 0" for key in rel
           if rel[key][0] != 0]
    bad += [f"step {i + 1} {key} {r:.3e} > {INT8_LATER_RTOL[key]}"
            for key in rel for i, r in enumerate(rel[key])
            if i > 0 and r > INT8_LATER_RTOL[key]]
    return rel, bad


def int8_fault_run(torch, dt, model, batch, fault):
    """The fused engine from phase 11's initial state with `fault`
    planted (INT8_FAULTS), for the warm-up's steps: `_steps`'s
    readings."""
    import dataclasses
    from deepspeed_tpu_torch.utils import tree as tu
    params = dict(INT8_PARAMS)
    if fault == "no_bias_correction":
        params["bias_correction"] = False
    eng = dt.initialize(model=model, config=bench_config("save_attn",
                                                         params))
    if fault == "stale_params":
        fused = eng.optimizer.update_fused

        def into_copy(grads, state, master, lr, step, params, **kw):
            return fused(grads, state, master, lr, step,
                         tu.tree_map(torch.clone, params), **kw)

        eng.optimizer = dataclasses.replace(eng.optimizer,
                                            update_fused=into_copy)
    if not eng.fused_update:
        fail(f"the control engine ({fault}) does not take update_fused")
    run = _steps(torch, eng, batch, TRAIN_WARMUP)
    del eng
    torch.cuda.empty_cache()
    return run


def train_int8(torch, np, layers, counters, fa8):
    """Phase 11 (see the module docstring; it runs before phase 5, and
    phase 7 prints the two updates side by side); `counters` are the
    flash kernels' and fused_adam8's."""
    import deepspeed_tpu_torch as dt
    model = train_model(torch, layers)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = dt.initialize(model=model,
                        config=bench_config("save_attn", INT8_PARAMS))
    if not eng.fused_update:
        fail("the int8 fused_update engine does not take update_fused")
    leaves = [t for t in eng.master.values() if isinstance(t, torch.Tensor)]
    leaves += list(eng.master["layers"].values())
    n_fused = sum(1 for t in leaves if t.dim() >= 1)
    n = sum(t.numel() for t in leaves)
    rows = sum(t.numel() // t.shape[-1] for t in leaves if t.dim() >= 1)
    gbs = eng.config.train_batch_size
    batch = train_batch_np(np, cfg, gbs)
    warm = _steps(torch, eng, batch, TRAIN_WARMUP)
    reset_counts(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = [eng.train_batch(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    variants = by_variant(counters)
    losses = [float(m["loss"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = gbs * TRAIN_SEQ * TRAIN_STEPS / wall
    mfu = (6 * n + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ) \
        * tok_s / H100_BF16_FLOPS
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"phase 11: AdamW with int8 moments and fused_update ({n_fused} "
          f"leaves of {n} parameters): warm-up losses {warm[0]}, grad norms "
          f"{warm[1]}; {TRAIN_STEPS} steps in {wall:.3f} s: step "
          f"{step_ms:.2f} ms, {tok_s:.1f} tokens/s, mfu {mfu:.4f}, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; losses {losses}; launches per "
          f"step {per_step}; by variant {variants}")
    if not all(np.isfinite(losses + warm[0] + warm[1])):
        fail(f"non-finite int8 training loss or grad norm: {losses}, {warm}")
    want = {c.__name__: cfg.num_layers * TRAIN_STEPS for c in counters}
    want[fa8.fused_adam8_leaf.__name__] = n_fused * TRAIN_STEPS
    if launches != want:
        fail(f"phase 11 launches {launches}, want {want} (one fused_adam8 "
             f"per leaf per step, one of each flash kernel per layer)")
    check_bwd_variants(variants, launches, "phase 11")
    torch.cuda.empty_cache()
    prof = profile_train_step(torch, eng, batch, step_ms, counters,
                              phase=11)
    upd_bound = bound_ms(ADAM8_OPS * n, adam8_bytes(n, rows),
                         H100_F32_FLOPS)
    opt_ms = prof["ms_by_kind"].get("optimizer")
    print(f"phase 11: the update's device time {opt_ms} ms (bound "
          f"{upd_bound[0]:.3f} ms, {upd_bound[1]})")
    del eng, metrics
    torch.cuda.empty_cache()

    # the same initial state through the plain int8 update
    plain = dt.initialize(model=model, config=bench_config(
        "save_attn", dict(INT8_PARAMS, fused_update=False)))
    before = fa8.fused_adam8_leaf.launches
    run = _steps(torch, plain, batch, TRAIN_WARMUP)
    if fa8.fused_adam8_leaf.launches != before or plain.fused_update:
        fail("the fused_update: false engine launched the fused kernel")
    del plain
    torch.cuda.empty_cache()
    rel, bad = int8_differences(warm, run)
    print(f"phase 11: fused vs plain int8 update over {TRAIN_WARMUP} steps: "
          f"losses {warm[0]} vs {run[0]}, grad norms {warm[1]} vs {run[1]}; "
          f"relative differences {rel} (step 1 must be equal, later "
          f"{INT8_LATER_RTOL})")
    if bad:
        fail("fused and plain int8 updates disagree: " + "; ".join(bad))
    controls = {}
    for fault in INT8_FAULTS:
        faulty = int8_fault_run(torch, dt, model, batch, fault)
        rel_f, bad_f = int8_differences(faulty, run)
        print(f"phase 11: control ({INT8_FAULTS[fault]}) vs plain int8 "
              f"update: losses {faulty[0]}, grad norms {faulty[1]}; "
              f"relative differences {rel_f}; refused by: {bad_f}")
        if not bad_f:
            fail(f"phase 11's checks pass a fused engine with "
                 f"{INT8_FAULTS[fault]}")
        controls[fault] = dict(losses=faulty[0], grad_norms=faulty[1],
                               rel_vs_plain=rel_f, refused_by=bad_f)
    return dict(controls=controls, step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
                peak_memory_bytes=peak, losses=losses,
                warmup_losses=warm[0], warmup_grad_norms=warm[1],
                launches=launches, launches_per_step=per_step,
                fused_leaves=n_fused, profile=prof, update_ms=opt_ms,
                update_bound_ms=upd_bound[0], update_bound_by=upd_bound[1],
                plain_int8_losses=run[0], plain_int8_grad_norms=run[1],
                rel_vs_plain=rel)


# ----------------------------------------------------------------------
# phase 1: the tile GEMM of the fused tensor-parallel ring
# ----------------------------------------------------------------------
# phase 13's engines: the wave's 8 requests in one decode batch (a ring
# hop's rows: 8/tp), chunked prefill only (prefill_full is off under tp,
# so the tp 1 reference takes the same path); the other fields are the
# engine's defaults, phase 2's (256 blocks x 64 slots, 256-token chunks,
# a 512-token budget, bursts of 8)
TP_ENGINE = dict(max_seqs=8, full_prompt_prefill=False)
TP_SIZES = (2, 4)
# a prefill call's chunk slots are a power of two: up to 8 for the wave
# (at most 5 live chunks under a 512-token budget); rows per hop C*NC/tp
TP_PREFILL_NC = (1, 2, 4, 8)
# tile GEMM vs its plain version: |kernel - plain| <= TILE_REL max|plain|.
# Both sum the same exact products (bf16 x bf16 is exact in f32) in f32,
# in another order: over K up to 11008 unit-normal terms that is ~1e-6 of
# the outputs' scale; a lost K tile or a misplaced column is O(1)
TILE_REL = 2e-5
# ring GEMMs of a swiglu layer: q, k, v, gate, up (all-gather) and o, down
# (reduce-scatter), each tp launches; the decode head adds tp more
TP_MM_PER_LAYER = 7
# phase 13's strict check: the same comparison at f32 and 2 layers, where
# tp N and tp 1 differ only by the order of f32 sums: tokens identical,
# max |dlogit| within TP_STRICT_ATOL (logits of size ~1 at these random
# weights; the reference's tp parity bound)
TP_STRICT_LAYERS = 2
TP_STRICT_ATOL = 2e-4


def tile_hop_shapes(H=4096, F=11008, V=32000, C=256):
    """{(M, K, N): [labels]} of every per-hop GEMM of phase 13's wave at
    Llama-2-7B widths (NH = NKV = 32 heads of 128, so q, k and v share a
    shape): the decode rows' q/k/v, o, gate/up, down and head hops, the
    prefill rows' (C*NC/tp) q/k/v, o, gate/up and down hops."""
    shapes = {}
    for tp in TP_SIZES:
        rows = [("decode", TP_ENGINE["max_seqs"] // tp)] + [
            (f"prefill NC={nc}", C * nc // tp) for nc in TP_PREFILL_NC]
        for stage, m in rows:
            hops = [("q/k/v", H, H // tp), ("o", H // tp, H),
                    ("gate/up", H, F // tp), ("down", F // tp, H)]
            if stage == "decode":
                hops.append(("head", H, V // tp))
            for proj, k, n in hops:
                shapes.setdefault((m, k, n), []).append(
                    f"tp{tp} {stage} {proj}")
    return shapes


def tile_work(M, K, N, elem):
    """(FLOPs, bytes) of one tile GEMM: x and w read once, out (f32)
    written once."""
    return 2 * M * K * N, (M * K + K * N) * elem + 4 * M * N


def cold_time_ms(torch, fn, iters=20, flush_mb=128):
    """Device time of one call of `fn` with the 50 MB L2 flushed before
    each call (a `flush_mb` MB buffer zeroed between calls, its fill
    kernel left out of the sum), as a ring hop finds its weight shard.
    A session holds when it has `iters` times one call's kernels; after
    PROFILE_TRIES that miss, CUDA events around each call."""
    flush = torch.empty(flush_mb << 18, dtype=torch.float32, device="cuda")
    fill = {e.name for e in profile_session(flush.zero_)}
    per_call = len(profile_session(fn))

    def body():
        for _ in range(iters):
            flush.zero_()
            fn()

    for _ in range(PROFILE_TRIES):
        mine = [e for e in profile_session(body) if e.name not in fill]
        us = sum(e.time_range.elapsed_us() for e in mine)
        if per_call and len(mine) == iters * per_call and us > 0:
            return Timing(us / 1e3 / iters, "profiler")
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return Timing(total / iters, "cuda_events")


def host_us(torch, fn, iters=200):
    """Host time of one call of `fn` (a wrapper's checks, plan, tensor
    maps and launch), at a size where the card keeps up: the wall time of
    `iters` calls with no synchronisation inside, divided by `iters`."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def tile_variant(tm, fn):
    """(result of fn(), the tile GEMM kernel it launched: the one variant
    whose count moved by one)."""
    before = dict(tm.tile_matmul.launches_by_variant)
    out = fn()
    moved = [k for k, n in tm.tile_matmul.launches_by_variant.items()
             if n != before[k]]
    if len(moved) != 1:
        fail(f"tile_matmul launched {moved} for one call")
    return out, moved[0]


def check_tile_matmul(torch, tm, dev):
    """The tile GEMM against its plain version at every per-hop shape of
    phase 13's wave (bf16, the serving dtype; f32, the strict check's, at
    the decode hops and the NC=2 prefill hops), and at the edges: M 1,
    K 2752, N 1001, ragged shapes, a view off the 16-byte boundary (the
    element loads), and M tiles past the 65535 grid limit.  Each case
    prints the kernel it ran (`tp_matmul.tile_plan`'s variant, read from
    the per-variant launch counts); a bf16 hop shape that did not run the
    split-K stream (M <= 16) or the wgmma kernel fails the phase, and an
    edge runs the kernel the plan names.  A rerun is bit-identical.
    Times every decode hop (and the NC=2 prefill hops) beside its bound,
    the plain version and cuBLAS's torch.mm(out_dtype=float32), warm and
    (decode hops) with the L2 flushed before each call."""
    g = torch.Generator(device=dev).manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    hops = tile_hop_shapes()
    cases = []                    # (M, K, N, dtype, label, element loads)
    for (M, K, N), labels in hops.items():
        cases.append((M, K, N, bf16, ", ".join(labels), False))
        if any("decode" in lb or "NC=2" in lb for lb in labels):
            cases.append((M, K, N, f32, ", ".join(labels), False))
    for dt in (bf16, f32):
        cases += [(1, 2752, 1001, dt, "edge: M 1, K 2752, N 1001", False),
                  (37, 100, 60, dt, "edge: ragged M, K, N", False),
                  (17, 4096, 2048, dt, "edge: x off the 16-byte boundary",
                   True),
                  (3, 7, 5, dt, "edge: tiny", False)]
    cases += [(64 * 65535 + 37, 8, 8, bf16,
               "edge: 65537 M tiles (grid stride)", False),
              (32 * 65535 + 5, 8, 8, f32,
               "edge: 65536 M tiles (grid stride)", False)]
    errs, rels, ran = [], [], {}
    for M, K, N, dt, label, off in cases:
        if off:   # a contiguous view one element past an aligned start
            x = torch.randn(M * K + 1, generator=g, device=dev,
                            dtype=dt)[1:].view(M, K)
        else:
            x = torch.randn(M, K, generator=g, device=dev, dtype=dt)
        w = torch.randn(K, N, generator=g, device=dev, dtype=dt)
        out, variant = tile_variant(tm, lambda: tm.tile_matmul(x, w))
        ref = tm.tile_matmul_reference(x, w)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        rel = e / max(float(ref.abs().max()), 1.0)
        print(f"  tile_matmul [{M},{K}] @ [{K},{N}] {str(dt)[6:]} ({label}): "
              f"{variant}, max|d| / max|plain| = {rel:.3e}")
        if out.dtype != f32 or rel > TILE_REL:
            fail(f"tile_matmul disagrees with its plain version at "
                 f"{(M, K, N, dt)}: {rel} of max|plain| (tol {TILE_REL})")
        aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
        want = tm.tile_plan(M, K, N, dt, aligned).variant
        if dt == bf16 and not label.startswith("edge"):
            if want != ("stream" if M <= tm.STREAM_MAX_M else "wgmma"):
                fail(f"the plan gives hop shape {(M, K, N)} the {want} "
                     f"kernel, not a TMA one")
        if variant != want:
            fail(f"tile_matmul ran {variant} at {(M, K, N, dt)}, its plan "
                 f"says {want}")
        ran[variant] = ran.get(variant, 0) + 1
        errs.append(e)
        rels.append(rel)
        del x, w, out, ref
    print(f"  tile_matmul cases by kernel: {ran}")
    torch.cuda.empty_cache()
    timed = []
    for (M, K, N), labels in hops.items():
        if not any("decode" in lb or "NC=2" in lb for lb in labels):
            continue
        x = torch.randn(M, K, generator=g, device=dev, dtype=bf16)
        w = torch.randn(K, N, generator=g, device=dev, dtype=bf16)
        first, variant = tile_variant(tm, lambda: tm.tile_matmul(x, w))
        if not torch.equal(first, tm.tile_matmul(x, w)):
            fail(f"tile_matmul reruns differ at {(M, K, N)}")
        plan = tm.tile_plan(M, K, N, bf16)
        row = dict(shape=f"x [{M},{K}] @ w [{K},{N}] bf16",
                   hops=", ".join(labels), variant=variant,
                   splits=plan.splits, ctas=plan.ctas,
                   ms=time_ms(lambda: tm.tile_matmul(x, w)),
                   plain_ms=time_ms(lambda: tm.tile_matmul_reference(x, w)),
                   library_ms=time_ms(lambda: torch.mm(
                       x, w, out_dtype=torch.float32)))
        row["bound_ms"], row["bound_by"] = bound_ms(*tile_work(M, K, N, 2))
        if M <= tm.STREAM_MAX_M:
            row["cold_ms"] = cold_time_ms(
                torch, lambda: tm.tile_matmul(x, w))
            row["library_cold_ms"] = cold_time_ms(
                torch, lambda: torch.mm(x, w, out_dtype=torch.float32))
        timed.append(row)
        cold = (f", L2 flushed {row['cold_ms']:.4f} (cuBLAS "
                f"{row['library_cold_ms']:.4f})" if "cold_ms" in row else "")
        print(f"  tile_matmul {row['shape']} ({row['hops']}): {variant} x "
              f"{plan.ctas} CTAs, {row['ms']:.4f} ms{cold} (bound "
              f"{row['bound_ms']:.4f} {row['bound_by']}, plain "
              f"{row['plain_ms']:.4f}, cuBLAS {row['library_ms']:.4f})")
        del x, w
    main = next(r for r in timed if "tp4 decode gate/up" in r["hops"])
    return dict(name="tile_matmul", route="cuda",
                source="deepspeed_tpu_torch/csrc/tile_matmul.cu",
                replaces="deepspeed_tpu/ops/tp_matmul.py:118",
                shape=main["shape"] + f" ({main['hops']})",
                max_abs_err=max(errs), max_rel_err=max(rels),
                max_rel_err_note="max|kernel - plain| / max|plain|",
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], cold_ms=main["cold_ms"],
                library_cold_ms=main["library_cold_ms"],
                library_note="torch.mm(x, w, out_dtype=torch.float32) "
                             "(cuBLAS)",
                cases_by_kernel=ran, hops=timed)


# ----------------------------------------------------------------------
# phase 13: tensor-parallel serving over the fused ring (--tp N)
# ----------------------------------------------------------------------
def tp_engine_config(tp):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
    kw = dict(TP_ENGINE)
    if tp > 1:
        kw.update(tensor_parallel_size=tp, tp_collectives="fused")
    return RaggedInferenceEngineConfig(**kw)


def matmul_flags(torch):
    """f32 products in full f32, bf16 products summed in f32 and rounded
    once (the JAX `_dense`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def tp_wave(torch, np, eng, prompts, counters):
    """Phase 2's wave on `eng` (any tp) with the counters set to 0 just
    before it and read just after: tokens, prefill tokens/s, decode ms per
    step, the launches, and the serving calls (prefill calls, decode
    steps) the launches are counted against."""
    acc = {"prefill": 0.0, "prefill_calls": 0, "decode": 0.0,
           "decode_calls": 0}
    finite = []
    calls = {"prefill_chunks": 0, "decode_steps": 0}
    progs = eng._programs
    real = {k: getattr(progs, k) for k in ("prefill_chunks", "decode_step",
                                           "decode_tokens")}

    def prefill(*a, **kw):
        calls["prefill_chunks"] += 1
        return real["prefill_chunks"](*a, **kw)

    def step(*a, **kw):
        calls["decode_steps"] += 1
        return real["decode_step"](*a, **kw)

    def burst(*a, **kw):
        calls["decode_steps"] += kw["n_steps"]
        return real["decode_tokens"](*a, **kw)

    progs.prefill_chunks, progs.decode_step = prefill, step
    progs.decode_tokens = burst
    eng.step = _timed(torch, np, eng.step, acc, "prefill", finite,
                      eng.device)
    eng.decode_burst_step = _timed(torch, np, eng.decode_burst_step, acc,
                                   "decode", finite, eng.device)
    reset_counts(counters)
    sync(torch, eng.device)
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
    sync(torch, eng.device)
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    by_variant = {c.__name__: dict(c.launches_by_variant) for c in counters
                  if hasattr(c, "launches_by_variant")}
    del eng.step, eng.decode_burst_step
    for k, fn in real.items():
        setattr(progs, k, fn)
    if len(finite) != len(prompts) or not all(finite):
        fail(f"prefill logits not finite for every request ({finite})")
    return dict(tokens=np.stack(outs), wall_s=wall, launches=launches,
                launches_by_variant=by_variant, calls=calls,
                prefill_tok_s=sum(len(p) for p in prompts) / acc["prefill"],
                decode_ms_per_step=1e3 * acc["decode"]
                / max(calls["decode_steps"], 1))


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _overlap_us(intervals, cover):
    """Length of `intervals` covered by the union of `cover`."""
    cover = sorted(cover)
    total = 0.0
    for a, b in intervals:
        for c, d in cover:
            if c >= b:
                break
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                total += hi - lo
    return total


def tp_profile_decode(torch, np, eng, prompts, outs, profile):
    """One decode step of the wave (after its prefill), its wall time,
    then the next step under torch.profiler on this rank when `profile`:
    device ms by kind (tile GEMM, NCCL, attention, other), the idle share
    against the unprofiled step's wall time, and the share of NCCL
    send/recv time that a tile-GEMM kernel overlaps on the timeline.  The
    ranks agree by an all-reduce whether a session held every launch (a
    session that dropped device events is repeated, the same step on
    every rank, as collectives need)."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import tp_matmul as tm
    uids = list(range(len(prompts)))
    eng.put(uids, [p.copy() for p in prompts])
    while any(eng.query(u) is None for u in uids):
        eng.step()

    def feed(j):
        eng.put(uids, [np.asarray([int(o[j])], np.int32) for o in outs])

    comm.barrier()
    sync(torch, eng.device)
    t0 = time.perf_counter()
    feed(0)
    sync(torch, eng.device)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    res = None
    for j in range(1, PROFILE_TRIES + 1):
        comm.barrier()
        launches = {}
        body = counted([tm.tile_matmul, pa.paged_decode_attention],
                       lambda: feed(j), launches)
        if profile:
            events = profile_session(body)
            ok = holds_launches(launches)(events)
        else:
            body()
            sync(torch, eng.device)
            ok = True
        flag = torch.tensor([0.0 if ok else 1.0], device=eng.device)
        comm.all_reduce(flag, op="max")
        if float(flag) == 0.0:
            break
        print(f"  (rank profiler session {j} missed device events: "
              f"repeated on every rank)")
    else:
        fail(f"the profiler missed device events in {PROFILE_TRIES} "
             f"decode-step sessions")
    if profile:
        by_kind = {}
        spans = {"all": [], "tile_matmul": [], "sendrecv": []}
        for e in events:
            kind = _kind(e.name)
            kind = "attention" if kind in ("paged_decode",
                                           "paged_prefill") else kind
            us = e.time_range.elapsed_us()
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
            iv = (e.time_range.start, e.time_range.end)
            spans["all"].append(iv)
            if kind == "tile_matmul":
                spans["tile_matmul"].append(iv)
            low = e.name.lower()
            if "nccl" in low and ("sendrecv" in low or "send" in low
                                  or "recv" in low):
                spans["sendrecv"].append(iv)
        busy = _union_us(spans["all"]) / 1e3
        sr = sum(b - a for a, b in spans["sendrecv"])
        res = dict(device_ms=busy, step_wall_ms=wall_ms,
                   idle_share=max(0.0, 1 - busy / wall_ms),
                   ms_by_kind=by_kind, launches=launches,
                   sendrecv_ms=sr / 1e3,
                   sendrecv_overlapped_by_tile_share=(
                       _overlap_us(spans["sendrecv"], spans["tile_matmul"])
                       / sr if sr > 0 else None))
    for u in uids:
        eng.flush(u)
    return res, wall_ms


def free(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def tp_rank(rank, world, init, layers, prompts, outs1, strict_outs1, dev,
            profile, model_kw):
    """Phase 13 on one rank of `world` (see `tensor_parallel`)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.inference.v2 import build_engine, ragged_ops
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    from deepspeed_tpu_torch.ops import tp_matmul as tm
    comm.init_distributed(init, rank, world, device=dev)
    matmul_flags(torch)
    # no rank may take a plain version: count every call of one
    plain = {"tile_matmul_reference": 0, "paged_decode_reference": 0,
             "paged_prefill_reference": 0}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            plain[name] += 1
            return fn(*a, **kw)
        setattr(mod, name, wrapped)
    counting(tm, "tile_matmul_reference")
    counting(ragged_ops, "paged_decode_reference")
    counting(ragged_ops, "paged_prefill_reference")
    counters = [tm.tile_matmul, pa.paged_decode_attention,
                pp.paged_prefill_attention, fa.flash_attention_fwd]
    t0 = time.perf_counter()
    eng = build_engine("llama", "7b", dtype=torch.bfloat16, device=dev,
                       num_layers=layers,
                       engine_config=tp_engine_config(world), **model_kw)
    sync(torch, eng.device)
    build_s = time.perf_counter() - t0
    wave = tp_wave(torch, np, eng, prompts, counters)
    logits = prefill_and_step(np, eng, prompts, outs1)
    prof, step_ms = tp_profile_decode(torch, np, eng, prompts, outs1,
                                      profile and rank == 0)
    arena = tuple(eng.arena["k"].shape)
    del eng
    free(torch, dev)
    strict = build_engine("llama", "7b", dtype=torch.float32, device=dev,
                          num_layers=TP_STRICT_LAYERS,
                          engine_config=tp_engine_config(world), **model_kw)
    strict_tokens = np.stack(strict.generate_batch(prompts,
                                                   max_new_tokens=MAX_NEW))
    strict_logits = prefill_and_step(np, strict, prompts, strict_outs1)
    del strict
    free(torch, dev)
    return dict(build_s=build_s, wave=wave, logits=logits, profile=prof,
                decode_step_wall_ms=step_ms, arena=arena, plain_calls=plain,
                strict_tokens=strict_tokens, strict_logits=strict_logits)


def tensor_parallel(torch, np, layers, sizes, store_dir, dev="cuda",
                    profile=True, model_kw=None):
    """Phase 13 (`--tp N`): Llama-2-7B widths (`layers` deep) served by
    the fused-ring tensor-parallel engine at each tp in `sizes`, one NCCL
    rank per card, against the same engine at tp 1.
      1. tp 1 on this process's card: phase 2's seeded weights and wave
         (chunked prefill, 8 sequences a decode batch): tokens, prefill
         logits and one decode step's logits; the same at f32 and 2
         layers; then the card is freed.
      2. for each tp: tp ranks (`comm.spawn_ranks`), each building
         `build_engine("llama", "7b", engine_config=...(tensor_parallel_
         size=tp, tp_collectives="fused"))` from the same seed, serve the
         wave with every counter set to 0 just before and read just
         after: tile GEMM launches (7L·prefill calls + (7L+1)·decode
         steps)·tp, the paged kernels' launches as at tp 1, no plain
         version called;
      3. logits within phase 3's limit of tp 1's, greedy tokens reported;
      4. the strict check at f32 and 2 layers: tokens identical, logits
         within TP_STRICT_ATOL;
      5. rank 0 profiles one decode step (device ms by kind, idle share,
         the NCCL send/recv time a tile GEMM overlaps);
      6. prefill tokens/s and decode ms per step beside tp 1's.
    `model_kw` overrides the model's widths (a rehearsal on the CPU, with
    dev="cpu" and profile=False, runs gloo ranks at a small size)."""
    model_kw = dict(model_kw or {})
    from deepspeed_tpu_torch.comm import spawn_ranks
    from deepspeed_tpu_torch.inference.v2 import build_engine
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    from deepspeed_tpu_torch.ops import tp_matmul as tm
    rng = np.random.RandomState(0)
    eng = build_engine("llama", "7b", dtype=torch.bfloat16, device=dev,
                       num_layers=layers, engine_config=tp_engine_config(1),
                       **model_kw)
    cfg = eng.cfg
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    print(f"phase 13: Llama-2-7B widths (H={cfg.hidden_size}, "
          f"L={cfg.num_layers}, NH=NKV={cfg.num_heads}, D={cfg.head_dim}, "
          f"ffn {cfg.ffn_dim}, V={cfg.vocab_size}) bf16, random weights "
          f"(seed 0); engine {TP_ENGINE}, the rest default; tp 1 on "
          f"{eng.device}")
    counters = [tm.tile_matmul, pa.paged_decode_attention,
                pp.paged_prefill_attention, fa.flash_attention_fwd]
    base = tp_wave(torch, np, eng, prompts, counters)
    paged_on_tma(counters, "phase 13, tp 1")
    outs1 = base["tokens"]
    logits1 = prefill_and_step(np, eng, prompts, outs1)
    del eng
    free(torch, dev)
    strict = build_engine("llama", "7b", dtype=torch.float32, device=dev,
                          num_layers=TP_STRICT_LAYERS,
                          engine_config=tp_engine_config(1), **model_kw)
    strict_outs1 = np.stack(strict.generate_batch(prompts,
                                                  max_new_tokens=MAX_NEW))
    strict_logits1 = prefill_and_step(np, strict, prompts, strict_outs1)
    del strict
    free(torch, dev)
    print(f"phase 13: tp 1: prefill {base['prefill_tok_s']:.0f} tok/s, "
          f"decode {base['decode_ms_per_step']:.2f} ms/step; calls "
          f"{base['calls']}; launches {base['launches']}")
    L = cfg.num_layers
    results = {"tp1": dict(prefill_tok_s=base["prefill_tok_s"],
                           decode_ms_per_step=base["decode_ms_per_step"],
                           calls=base["calls"], launches=base["launches"])}
    for tp in sizes:
        t0 = time.perf_counter()
        ranks = spawn_ranks(tp_rank, tp,
                            os.path.join(store_dir, f"store_tp{tp}"),
                            args=(layers, prompts, outs1, strict_outs1, dev,
                                  profile, model_kw), timeout_s=900,
                            threads=4)
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        w = r0["wave"]
        for r in ranks[1:]:
            if not (np.array_equal(r["wave"]["tokens"], w["tokens"])
                    and np.array_equal(r["strict_tokens"],
                                       r0["strict_tokens"])):
                fail(f"tp {tp}: the ranks sampled different tokens")
        calls = w["calls"]
        want_tile = tp * (TP_MM_PER_LAYER * L * calls["prefill_chunks"]
                          + (TP_MM_PER_LAYER * L + 1)
                          * calls["decode_steps"])
        lt = {n: [r["wave"]["launches"][n] for r in ranks]
              for n in w["launches"]}
        backend = "NCCL" if torch.device(dev).type == "cuda" else "gloo"
        print(f"phase 13: tp {tp}: {tp} {backend} ranks in {wall:.1f} s "
              f"(engine build {r0['build_s']:.1f} s, local arena {r0['arena']}); "
              f"calls {calls}; launches by rank {lt} (tile GEMM want "
              f"{want_tile}); plain-version calls "
              f"{[r['plain_calls'] for r in ranks]}")
        if calls != base["calls"]:
            fail(f"tp {tp} scheduled other serving calls than tp 1: "
                 f"{calls} vs {base['calls']}")
        variants = [r["wave"]["launches_by_variant"]["tile_matmul"]
                    for r in ranks]
        print(f"  tile GEMM launches by kernel, by rank: {variants}")
        for r, v in zip(ranks, variants):
            got = r["wave"]["launches"]
            if got["tile_matmul"] != want_tile:
                fail(f"tp {tp}: {got['tile_matmul']} tile GEMM launches, "
                     f"want {want_tile}")
            # bf16 hops have K and N multiples of 8: TMA kernels only
            if v["cp_async"] or v["f32"]:
                fail(f"tp {tp}: a bf16 hop ran an old tile kernel: {v}")
            # bf16 paged calls at D 128, bs 64: the TMA kernels only
            for n in ("paged_decode_attention", "paged_prefill_attention"):
                pv = r["wave"]["launches_by_variant"][n]
                if pv["tma"] != got[n]:
                    fail(f"tp {tp}: {n} launched {pv} of {got[n]} calls: "
                         f"every bf16 paged call must take the TMA kernel")
            for n in ("paged_decode_attention", "paged_prefill_attention",
                      "flash_attention_fwd"):
                if got[n] != base["launches"][n]:
                    fail(f"tp {tp}: {n} launched {got[n]} times, tp 1 "
                         f"{base['launches'][n]}")
            if got["paged_decode_attention"] <= 0 or any(
                    r["plain_calls"].values()):
                fail(f"tp {tp}: a rank served through a plain version "
                     f"({r['plain_calls']}) or without the paged kernels")
        rels = logit_differences(np, r0["logits"], logits1)
        worst = max(max(rels[0]), max(rels[1]))
        same = float((w["tokens"] == outs1).mean())
        first_same = int((w["tokens"][:, 0] == outs1[:, 0]).sum())
        print(f"  bf16 logits vs tp 1: max |dlogit| / max |logit| first "
              f"token {[float(f'{x:.3e}') for x in rels[0]]}, second "
              f"{[float(f'{x:.3e}') for x in rels[1]]} (tol {E2E_REL_TOL}); "
              f"greedy tokens equal to tp 1's: {same:.3f} of "
              f"{w['tokens'].size}, first tokens {first_same}/"
              f"{len(prompts)}")
        if worst > E2E_REL_TOL:
            fail(f"tp {tp} logits differ from tp 1's by {worst} relative "
                 f"(tol {E2E_REL_TOL})")
        sd = max(float(np.abs(r0["strict_logits"][i][u]
                              - strict_logits1[i][u]).max())
                 for i in (0, 1) for u in strict_logits1[i])
        strict_same = bool(np.array_equal(r0["strict_tokens"],
                                          strict_outs1))
        print(f"  strict (f32, {TP_STRICT_LAYERS} layers): max |dlogit| "
              f"{sd:.3e} (tol {TP_STRICT_ATOL}); tokens identical: "
              f"{strict_same}")
        if sd > TP_STRICT_ATOL or not strict_same:
            fail(f"tp {tp} strict check: max |dlogit| {sd}, tokens "
                 f"identical {strict_same}")
        p0 = r0["profile"]
        if p0 is not None:
            print(f"  rank 0 decode step: device {p0['device_ms']:.3f} ms "
                  f"of {p0['step_wall_ms']:.2f} ms wall (idle share "
                  f"{p0['idle_share']:.3f}); by kind (ms) " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(
                          p0["ms_by_kind"].items(), key=lambda kv: -kv[1]))
                  + f"; NCCL send/recv {p0['sendrecv_ms']:.3f} ms, share "
                    f"overlapped by a tile GEMM "
                    f"{p0['sendrecv_overlapped_by_tile_share']}")
        print(f"  tp {tp}: prefill {w['prefill_tok_s']:.0f} tok/s, decode "
              f"{w['decode_ms_per_step']:.2f} ms/step (tp 1: "
              f"{base['prefill_tok_s']:.0f} tok/s, "
              f"{base['decode_ms_per_step']:.2f} ms/step)")
        results[f"tp{tp}"] = dict(
            ranks_s=wall, build_s=r0["build_s"], arena=r0["arena"],
            calls=calls, launches_by_rank=lt, tile_launches_want=want_tile,
            tile_launches_by_kernel=variants,
            e2e_max_rel_dlogit=worst, token_agreement=same,
            first_token_agreement=first_same / len(prompts),
            strict_max_abs_dlogit=sd, strict_tokens_identical=strict_same,
            prefill_tok_s=w["prefill_tok_s"],
            decode_ms_per_step=w["decode_ms_per_step"],
            decode_step_wall_ms=r0["decode_step_wall_ms"], profile=p0)
    return results


def tp_main(torch, np, tm, args, kind, smi, out_dir):
    """`--tp N`: phase 1's tile GEMM checks, then phase 13 at tp 2 (and 4
    with --tp 4).  The kernels were built in this process (phase 0), so
    the ranks load them and build nothing."""
    print(f"phase 1: the tile GEMM against its plain version (tol "
          f"{TILE_REL} max|plain|)")
    row = check_tile_matmul(torch, tm, "cuda")
    row["clocks"] = clocks(row)
    torch.cuda.empty_cache()
    sizes = [t for t in TP_SIZES if t <= args.tp]
    # the ranks meet at file stores beside the kernels' build
    store_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "tp_store")
    os.makedirs(store_dir, exist_ok=True)
    for t in sizes:
        store = os.path.join(store_dir, f"store_tp{t}")
        if os.path.exists(store):
            os.remove(store)
    res = tensor_parallel(torch, np, args.layers, sizes, store_dir)
    top = res[f"tp{sizes[-1]}"]
    row["launches"] = top["launches_by_rank"]["tile_matmul"][0]
    row["launches_by_path"] = {f"tp{t}_rank0": res[f"tp{t}"][
        "launches_by_rank"]["tile_matmul"][0] for t in sizes}
    with open(os.path.join(out_dir, "chip_smoke_tp.json"), "w") as f:
        json.dump(dict(kernels=[row], tensor_parallel=res,
                       device=dict(kind=kind, nvidia_smi=smi,
                                   count=torch.cuda.device_count(),
                                   layers=args.layers)), f, indent=1,
                  default=lambda o: o.tolist() if hasattr(o, "tolist")
                  else str(o))
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="serving model depth (Llama-2-7B has 32)")
    ap.add_argument("--train-layers", type=int, default=24,
                    help="training model depth (GPT-2-1.3B has 24)")
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory for the run's JSON record, relative to "
                         "this script's directory")
    ap.add_argument("--tp", type=int, default=0, choices=(0, 2, 4),
                    help="run phase 13 instead: tensor-parallel serving at "
                         "tp 2 (and tp 4 with --tp 4) on that many cards, "
                         "after phase 0 and phase 1's tile GEMM checks")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on the card)")
    if torch.cuda.device_count() < args.tp:
        fail(f"--tp {args.tp} needs {args.tp} CUDA devices, "
             f"{torch.cuda.device_count()} visible")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deepspeed_tpu_torch")):
        fail(f"no deepspeed_tpu_torch package beside {__file__}")
    sys.path.insert(0, root)
    import numpy as np
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import evoformer as evo
    from deepspeed_tpu_torch.ops import evoformer_flash as ef
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam8 as fa8
    from deepspeed_tpu_torch.ops import lora_matmul as lm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_merged as pm
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import sparse_flash as sf
    from deepspeed_tpu_torch.ops import tp_matmul as tm
    from deepspeed_tpu_torch.runtime import optimizers as topt
    matmul_flags(torch)
    out_dir = os.path.join(root, args.out)
    os.makedirs(out_dir, exist_ok=True)

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

    if args.tp:
        return tp_main(torch, np, tm, args, kind, smi, out_dir)

    # phase 1
    print(f"phase 1: kernels against their plain versions (forward bf16 "
          f"tol {TOL_TEXT}; backward tol {BWD_TOL_TEXT}; LoRA tol "
          f"{LORA_REL} max|plain|; fused 8-bit Adam master {ADAM8_RTOL} "
          f"|plain| + {ADAM8_ATOL}, codes within 1, scales {ADAM8_RTOL}; "
          f"tile GEMM {TILE_REL} max|plain|)")
    evo_edges = check_evoformer_edges(torch, evo, ef, "cuda")
    kernels = [check_flash(torch, fa, "cuda"),
               *check_flash_bwd(torch, fa, "cuda"),
               check_decode(torch, np, pa, "cuda"),
               check_prefill(torch, np, pp, "cuda"),
               check_lora(torch, np, lm, "cuda"),
               *check_merged(torch, np, pa, pp, pm, "cuda"),
               check_adam8(torch, fa8, topt, "cuda"),
               *check_sparse(torch, np, sa, sf, "cuda"),
               *check_evoformer(torch, ef, "cuda"),
               check_tile_matmul(torch, tm, "cuda")]
    for k in kernels:
        k["clocks"] = clocks(k)
    other = {k["name"]: {t: c for t, c in k["clocks"].items()
                         if c != "profiler"} for k in kernels}
    other = {n: c for n, c in other.items() if c}
    print(f"phase 1: clocks: every time from the profiler but {other}")
    torch.cuda.empty_cache()

    # phase 2
    serve_counters = [fa.flash_attention_fwd, pa.paged_decode_attention,
                      pp.paged_prefill_attention]
    eng, prompts, outs, served = serve(torch, np, args.layers,
                                       serve_counters)

    # phase 3
    reset_counts(serve_counters)
    e2e, kernel_logits = compare_plain(torch, np, eng, prompts, outs)
    paged_on_tma(serve_counters, "phase 3")

    # phase 4
    prof = profile_wave(torch, eng, prompts, served["wall_s"],
                        serve_counters)
    paged_on_tma(serve_counters, "phase 4")
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

    # phase 10 (before the training phases: run after phase 6, most of its
    # profiler sessions came back without device events on the H100
    # machine, for a reason not known)
    sparse = sparse_path(torch, np, sa, sf, fa, [
        sf.block_sparse_flash_attention, sf.block_sparse_flash_dq,
        sf.block_sparse_flash_dkv, sf.block_sparse_flash_bwd_delta])

    # phase 12
    evoformer = evoformer_path(torch, evo, ef, [
        ef.evoformer_flash_forward, ef.evoformer_flash_dq,
        ef.evoformer_flash_dkv, ef.evoformer_flash_db2,
        ef.evoformer_flash_db1])
    torch.cuda.empty_cache()

    # phase 11 (before the other training phases)
    int8 = train_int8(torch, np, args.train_layers,
                      [fa.flash_attention_fwd, fa.flash_attention_bwd_delta,
                       fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                       fa8.fused_adam8_leaf], fa8)

    # phase 5
    train_counters = [fa.flash_attention_fwd, fa.flash_attention_bwd_delta,
                      fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]
    teng, batch, trained = train(torch, np, args.train_layers,
                                 train_counters)

    # phase 7 (on phase 5's engine, before it is freed)
    tprof = profile_train_step(torch, teng, batch, trained["step_ms"],
                               train_counters)
    print(f"phase 7: the optimizer update's device time, plain int8f "
          f"{tprof['ms_by_kind'].get('optimizer')} ms vs phase 11's fused "
          f"int8 {int8['update_ms']} ms (bound {int8['update_bound_ms']:.3f}"
          f" ms)")
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

    print("phase 13: tensor-parallel serving over the fused ring runs only "
          "with --tp N (N in 2, 4, on N cards); not run in this one-card run")

    # each path's run: the serving wave (phase 2), the training steps
    # (phase 5), arm B of the multi-tenant wave (phase 8), the merged
    # wave (phase 9), the three layouts' forward and backward (phase 10),
    # the int8 fused-update training steps (phase 11), the three
    # Evoformer shapes' forward and backward (phase 12)
    paths = (("serve", served["launches"]), ("train", trained["launches"]),
             ("tenants", tenants["launches"]), ("merged", merged["launches"]),
             ("sparse", sparse["launches"]), ("train_int8", int8["launches"]),
             ("evoformer", evoformer["launches"]))
    for k in kernels:
        fn = WRAPPERS[k["name"]]
        by_path = {path: launches[fn] for path, launches in paths
                   if fn in launches}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if fn in evoformer["launches_by_variant"]:   # evo_dq, evo_dkv
            k["launches_by_variant"] = evoformer["launches_by_variant"][fn]
        if fn in sparse["launches_by_variant"]:      # sparse_dq, sparse_dkv
            k["launches_by_variant"] = sparse["launches_by_variant"][fn]
        paged = [p["launches_by_variant"][fn] for p in (served, tenants,
                                                          merged)
                 if fn in p["launches_by_variant"]]
        if paged:                                    # the paged kernels
            k["launches_by_variant"] = {v: sum(p[v] for p in paged)
                                        for v in paged[0]}

    record = dict(kernels=kernels, serve=served, e2e=e2e, profile=prof,
                  tenants=tenants, merged=merged,
                  train=trained, train_profile=tprof, train_plain=tplain,
                  train_control=control, remat=remat, sparse=sparse,
                  train_int8=int8, evoformer=evoformer,
                  evoformer_edges_max_abs_err=evo_edges,
                  device=dict(kind=kind, nvidia_smi=smi,
                              layers=args.layers,
                              train_layers=args.train_layers))
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
