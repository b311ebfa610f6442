#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--out DIR]

Phases (any failure exits non-zero and prints no result):
  0. report the card (name, power limit) and build the CUDA kernels from
     `deepspeed_tpu_torch/csrc` (one nvcc per source, all in parallel);
  1. hold each kernel against its plain PyTorch version on the card in
     bf16, at the serving path's shapes and at edge cases, and time both
     (device time from torch.profiler) beside the card's bound for the
     same work;
  2. serve one wave of 8 requests through `build_engine("llama", "7b")`
     (Llama-2-7B widths, random weights from a seeded generator) and
     `generate_batch`, with every kernel's launch counter reset just
     before and read just after: each kernel must have launched;
  3. rerun the wave's prefill and one decode step through the kernels and
     through an engine that selects the plain versions explicitly
     (`plain_kernels=True`) and compare the logits;
  4. profile a rerun of the wave (torch.profiler): device time by kernel
     kind, and the device's idle share against phase 2's wall time.
Prints a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  `--layers` cuts the model's depth (the
widths stay Llama-2-7B's); the default is the full 32 layers.
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

PROMPT_LENS = [37, 64, 96, 128, 200, 311, 500, 1500]
MAX_NEW = 32

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS
    t_mem = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def time_ms(fn, iters=20, warmup=3):
    """Device time of one call of `fn`: the summed durations of the
    kernels it launches over `iters` calls (torch.profiler), divided by
    `iters`.  Host gaps between launches are left out, which CUDA events
    around a call of a few tens of microseconds would count; the inputs
    stay warm in the 50 MB L2 from call to call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in device_events(prof))
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
def check_flash(torch, fa, dev):
    import torch.nn.functional as F
    errs = []
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # (B, S, NH, NKV, D): main shape first
        (4, 512, 32, 32, 128), (1, 300, 32, 8, 128), (2, 200, 16, 16, 64)]
    for B, S, NH, NKV, D in cases:
        q = torch.randn(B, S, NH, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn(B, S, NKV, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn(B, S, NKV, D, generator=g, device=dev,
                        dtype=torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        print(f"  flash_fwd B={B} S={S} NH={NH} NKV={NKV} D={D}: "
              f"max|dout|={e:.3e} max|dlse|={el:.3e}")
        if not (kernel_close(out, ref) and el <= LSE_ATOL):
            fail(f"flash_fwd disagrees with its plain version at "
                 f"{(B, S, NH, NKV, D)}: {e} (tol {TOL_TEXT}), lse {el} "
                 f"(tol {LSE_ATOL})")
        errs.append(max(e, el))
    B, S, NH, NKV, D = cases[0]
    q = torch.randn(B, S, NH, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, NKV, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, NKV, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain = time_ms(lambda: fa.flash_attention_reference(q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * B * NH * D * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * NH * D + 2 * B * S * NKV * D) + 4 * B * NH * S
    bms, by = bound_ms(flops, nbytes)
    return dict(name="flash_fwd", route="cuda",
                source="deepspeed_tpu_torch/csrc/flash_fwd.cu",
                replaces="deepspeed_tpu/ops/flash_attention.py:272",
                shape=f"q [{B},{S},{NH},{D}] k/v [{B},{S},{NKV},{D}] bf16",
                max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


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
    L, nb, bs, MB, D = 2, 256, 64, 32, 128
    errs, main = [], None
    # (NH, NKV, lens): main shape first — B=8 at mixed lens up to ~1500
    cases = [(32, 32, [36, 63, 95, 127, 199, 310, 499, 1499]),
             (32, 8, [5, -1, 700, 64, 1, -3, 1200, 0])]
    for NH, NKV, lens_l in cases:
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
        print(f"  paged_decode B={B} NH={NH} NKV={NKV} lens={lens_l}: "
              f"max|dout|={e:.3e} inactive rows zero: {zero_ok}")
        if not (kernel_close(out, ref) and zero_ok):
            fail(f"paged_decode disagrees with its plain version "
                 f"(NH={NH}, NKV={NKV}): {e} (tol {TOL_TEXT}), "
                 f"inactive rows zero: {zero_ok}")
        errs.append(e)
        if main is None:
            main = (q, ak, av, tables, lens, lens_np, NH, NKV)
    q, ak, av, tables, lens, lens_np, NH, NKV = main
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
    L, nb, bs, MB, D = 2, 256, 64, 32, 128
    errs, main = [], None
    # (C, NH, NKV, pos0, n_valid, window): main shape first
    cases = [(256, 32, 32, 1024, 256, None), (256, 32, 8, 700, 100, None),
             (3, 32, 32, 77, 3, None), (64, 32, 8, 300, 64, 128),
             (5, 32, 32, 0, 2, None)]
    for C, NH, NKV, pos0, n_valid, win in cases:
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
        print(f"  paged_prefill C={C} NH={NH} NKV={NKV} pos0={pos0} "
              f"n_valid={n_valid} window={win}: max|dout|={e:.3e}")
        if not kernel_close(out[:n_valid], ref[:n_valid]):
            fail(f"paged_prefill disagrees with its plain version at "
                 f"{(C, NH, NKV, pos0, n_valid, win)}: {e} "
                 f"(tol {TOL_TEXT})")
        errs.append(e)
        if main is None:
            main = (q, ak, av, table, C, NH, NKV, pos0, n_valid)
    q, ak, av, table, C, NH, NKV, pos0, n_valid = main
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


def compare_plain(torch, np, eng, prompts, outs):
    """Prefill the wave and run one decode step through the kernels and
    through the plain versions; compare the logits."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    plain = InferenceEngineV2(eng.cfg, params=eng.params, config=eng.config,
                              device="cuda", plain_kernels=True)
    logits = {}
    for name, e in (("kernel", eng), ("plain", plain)):
        uids = list(range(len(prompts)))
        e.put(uids, prompts)
        while any(e.query(u) is None for u in uids):
            e.step()
        first = {u: e.query(u).copy() for u in uids}
        # one decode step, both engines fed the served run's first tokens
        e.put(uids, [np.asarray([int(o[0])], np.int32) for o in outs])
        second = {u: e.query(u).copy() for u in uids}
        for u in uids:
            e.flush(u)
        logits[name] = (first, second)
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
    return dict(e2e_max_rel_dlogit=worst, greedy_agreement=rate)


def _kind(name):
    # the port's kernels live in anonymous namespaces of csrc/*.cu
    for kernel in ("flash_fwd", "paged_prefill", "paged_decode"):
        if f"(anonymous namespace)::{kernel}" in name:
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def profile_wave(torch, eng, prompts, served_wall):
    """Where the device time of the wave goes: torch.profiler over a rerun
    of the same wave, kernel time summed by kind.  The device's idle share
    is taken against the unprofiled run's wall time (phase 2), since the
    profiler slows the host but not the kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate_batch(prompts, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
    by_kind, by_name = {}, {}
    for e in device_events(prof):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth (Llama-2-7B has 32)")
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
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import paged_prefill as pp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    # phase 1
    print(f"phase 1: kernels against their plain versions (bf16, tol "
          f"{TOL_TEXT})")
    kernels = [check_flash(torch, fa, "cuda"),
               check_decode(torch, np, pa, "cuda"),
               check_prefill(torch, np, pp, "cuda")]

    # phase 2
    counters = [fa.flash_attention, pa.paged_decode_attention,
                pp.paged_prefill_attention]
    eng, prompts, outs, served = serve(torch, np, args.layers, counters)
    names = {"flash_fwd": "flash_attention",
             "paged_decode": "paged_decode_attention",
             "paged_prefill": "paged_prefill_attention"}
    for k in kernels:
        k["launches"] = served["launches"][names[k["name"]]]

    # phase 3
    e2e = compare_plain(torch, np, eng, prompts, outs)

    # phase 4
    prof = profile_wave(torch, eng, prompts, served["wall_s"])

    record = dict(kernels=kernels, serve=served, e2e=e2e, profile=prof,
                  device=dict(kind=kind, nvidia_smi=smi,
                              layers=args.layers))
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
