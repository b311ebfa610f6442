"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card with `nvcc` (the kernels build from
`deepspeed_tpu_torch/csrc` on first use) and skips without one.  The file
imports neither `jax` nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Each kernel is checked in both dtypes it takes: f32, where kernel and
plain version differ only by the order of f32 sums, and bf16, where the
output's final rounding adds one bf16 ulp, at the head dims the kernels
take (32, 64, 128; block-sparse 64-256; Evoformer every D % 8 up to 128,
whose backward must also rerun bit for bit).  The engine tests serve the
same wave, and take the same training steps, through the kernels and
through the plain versions (`plain_kernels=True`) in f32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.ops import evoformer as tevo
from deepspeed_tpu_torch.ops import evoformer_flash as tevof
from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.ops import fused_adam8 as tadam8
from deepspeed_tpu_torch.ops import lora_matmul as tlora
from deepspeed_tpu_torch.ops import sparse_attention as tsparse
from deepspeed_tpu_torch.ops import sparse_flash as tsflash
from deepspeed_tpu_torch.ops import paged_attention as tdecode
from deepspeed_tpu_torch.ops import paged_merged as tmerged
from deepspeed_tpu_torch.ops import paged_prefill as tprefill
from deepspeed_tpu_torch.ops import tp_matmul as ttm
from deepspeed_tpu_torch.serving.tenancy import AdapterPool

pytestmark = [pytest.mark.kernels, pytest.mark.cuda]

# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise.
# f32: summation order only (unit-normal inputs, outputs of size ~1).
# bf16: the sums are f32 on both sides; the attention kernels round P to
# bf16 before P.V on the tensor cores and every output is rounded to bf16
# once: two bf16 ulps (2^-7 relative) plus about one ulp at unit scale.
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}
# lse is f32 in both versions whatever the input dtype, of size ~10
LSE_ATOL = 1e-4
# flash backward, |kernel - plain| <= BWD_RTOL |plain| + BWD_ATOL max|plain|:
# f32, summation order only; bf16, the kernels round P and dS to bf16
# before the tensor-core products (the plain versions keep f32) and each
# output, a sum over up to S rows, once: one to two bf16 ulps of the
# output's largest magnitude (measured up to 0.71% of it on an H100)
BWD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}
BWD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# gather-LoRA kernel vs plain version, |kernel - plain| <= LORA_REL
# max|plain|: both take f32 products of the same (exactly widened) inputs;
# only the order of the sums over K and r differs
LORA_REL = 1e-5
# fused 8-bit Adam vs plain version: the kernel keeps the plain version's
# operation order with IEEE roundings and no FMA contraction, so only the
# last bit of exp2f/log2f can differ (the card's libdevice against
# PyTorch's CUDA kernels): master |d| <= 1e-6 |plain| + 1e-7, codes within
# one, scales rtol 1e-6
ADAM8_RTOL, ADAM8_ATOL = 1e-6, 1e-7
# tile GEMM vs plain version, |kernel - plain| <= TILE_REL max|plain|: both
# sum the same exact products (bf16 x bf16 is exact in f32) in f32, in
# another order; over K up to 11008 unit-normal terms that is ~1e-6 of the
# outputs' scale, and a lost K tile or misplaced column is O(1)
TILE_REL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, dtype, *shape):
    return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)


def _close(got, ref, atol, rtol=0.0):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    excess = (got - ref).abs() - (atol + rtol * ref.abs())
    assert float(excess.max()) <= 0, float((got - ref).abs().max())


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("S,NH,NKV,D", [(200, 8, 2, 128), (64, 4, 4, 64),
                                        (1, 2, 1, 128), (50, 4, 2, 32)])
def test_flash_kernel_matches_plain_version(card, dtype, S, NH, NKV, D):
    q, k, v = (_rnd(card, dtype, 2, S, n, D) for n in (NH, NKV, NKV))
    out, lse = tflash.flash_attention_fwd(q, k, v)
    ref, ref_lse = tflash.flash_attention_reference(q, k, v)
    _close(out, ref, ATOL[dtype], RTOL[dtype])
    _close(lse, ref_lse, LSE_ATOL)


@DTYPES
@pytest.mark.parametrize("NH,NKV,D", [(8, 2, 128), (4, 4, 64), (4, 2, 32)])
def test_paged_decode_kernel_matches_plain_version(card, dtype, NH, NKV, D):
    rng = np.random.RandomState(0)
    L, nb, bs, MB = 2, 40, 16, 24
    ak, av = (_rnd(card, dtype, L, nb, bs, NKV, D) for _ in range(2))
    lens = np.asarray([5, -1, 300, 0, 16, 383], np.int32)
    # live blocks first, garbage (negative and past the arena) after them
    tables = rng.randint(-3, nb + 3, size=(lens.size, MB)).astype(np.int32)
    for b, n in enumerate(lens):
        live = max(int(n), 0) // bs + 1
        tables[b, :live] = rng.permutation(nb)[:live]
    q = _rnd(card, dtype, lens.size, NH, D)
    args = (q, ak, av, torch.from_numpy(tables).cuda(),
            torch.from_numpy(lens).cuda())
    got = tdecode.paged_decode_attention(*args, layer_idx=1)
    ref = tdecode.paged_decode_reference(*args, layer_idx=1)
    _close(got, ref, ATOL[dtype], RTOL[dtype])
    assert (got[torch.from_numpy(lens < 0).cuda()] == 0).all()


@DTYPES
@pytest.mark.parametrize("C,pos0,n_valid,window,D", [
    (3, 40, 3, None, 128), (70, 100, 61, None, 128), (32, 0, 32, 8, 128),
    (5, 7, 2, None, 128), (70, 100, 61, None, 32)])
def test_paged_prefill_kernel_matches_plain_version(card, dtype, C, pos0,
                                                    n_valid, window, D):
    rng = np.random.RandomState(1)
    L, nb, bs, MB, NH, NKV = 2, 32, 16, 16, 8, 2
    ak, av = (_rnd(card, dtype, L, nb, bs, NKV, D) for _ in range(2))
    table = rng.randint(-3, nb + 3, size=MB).astype(np.int32)
    live = (pos0 + n_valid - 1) // bs + 1
    table[:live] = rng.permutation(nb)[:live]
    q = _rnd(card, dtype, C, NH, D)
    args = (q, ak, av, torch.from_numpy(table).cuda(), pos0, n_valid)
    got = tprefill.paged_prefill_attention(*args, sliding_window=window,
                                           layer_idx=1)
    ref = tprefill.paged_prefill_reference(*args, sliding_window=window,
                                           layer_idx=1)
    _close(got[:n_valid], ref[:n_valid], ATOL[dtype], RTOL[dtype])


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    q = _rnd(card, torch.float16, 1, 8, 2, 64)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, q, q)
    q = _rnd(card, torch.float32, 1, 8, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention_bwd_dq(q, q, q, q, q[:, :, :, 0].transpose(
            1, 2).contiguous(), q)
    q = _rnd(card, torch.bfloat16, 1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_bwd_dkv(q, q, q, q, lse,
                                       q.transpose(1, 2).contiguous()
                                       .transpose(1, 2))


def test_engine_serves_the_same_through_kernels_and_plain_versions(card):
    """A mixed wave (one prompt over the step budget) through the kernel
    engine and the plain-version engine, f32: same greedy chains, and
    first-token logits within the f32 tolerance."""
    cfg = get_model_config("llama", "tiny", dtype=torch.float32,
                           hidden_size=512, num_heads=8, num_kv_heads=4)
    ecfg = RaggedInferenceEngineConfig(
        num_blocks=64, block_size=16, max_blocks_per_seq=16, max_seqs=8,
        prefill_chunk_size=32, max_prefill_tokens_per_step=64)
    kern = InferenceEngineV2(cfg, config=ecfg, device="cuda")
    plain = InferenceEngineV2(cfg, params=kern.params, config=ecfg,
                              device="cuda", plain_kernels=True)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 40, 100)]
    counts = (tflash.flash_attention_fwd.launches,
              tdecode.paged_decode_attention.launches,
              tprefill.paged_prefill_attention.launches)
    got = kern.generate_batch(prompts, max_new_tokens=8)
    after = (tflash.flash_attention_fwd.launches,
             tdecode.paged_decode_attention.launches,
             tprefill.paged_prefill_attention.launches)
    assert all(a > c for a, c in zip(after, counts))
    want = plain.generate_batch(prompts, max_new_tokens=8)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    firsts = []
    for eng in (kern, plain):
        eng.put(list(range(4)), prompts)
        while any(eng.query(u) is None for u in range(4)):
            eng.step()
        firsts.append(np.stack([eng.query(u) for u in range(4)]))
    np.testing.assert_allclose(firsts[0], firsts[1], rtol=1e-4, atol=1e-4)


# delta kernel vs plain rowsum, |d| <= DELTA_REL max(max|plain|, 1): f32
# sums of D exact products in another order
DELTA_REL = 1e-5


# GQA with a ragged tail, D 64 with a ragged key tile, D 32 (64-byte
# swizzle), one row, a tail of one row past a 128-key tile, a whole number
# of tiles, groups of 4 and 8 q heads
@DTYPES
@pytest.mark.parametrize("S,NH,NKV,D", [(200, 8, 2, 128), (130, 4, 4, 64),
                                        (100, 8, 2, 32), (64, 4, 4, 32),
                                        (1, 2, 1, 128), (1000, 32, 4, 128),
                                        (300, 8, 8, 64), (129, 4, 4, 32),
                                        (256, 8, 8, 128), (200, 16, 2, 64)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_kernels_match_plain_versions(card, dtype, S, NH, NKV,
                                                     D, causal):
    """dq and dk/dv fed the delta kernel's output: one launch each per call
    on the variant the dtype takes (bf16: TMA + wgmma), reruns
    bit-identical, within the backward tolerance of the plain versions;
    delta within DELTA_REL of the plain rowsum."""
    q, do = (_rnd(card, dtype, 2, S, NH, D) for _ in range(2))
    k, v = (_rnd(card, dtype, 2, S, NKV, D) for _ in range(2))
    out, lse = tflash.flash_attention_fwd(q, k, v, causal)
    wrappers = (tflash.flash_attention_bwd_dq, tflash.flash_attention_bwd_dkv)
    before = [dict(w.launches_by_variant) for w in wrappers]
    delta = tflash.flash_attention_bwd_delta(out, do)
    runs = [(tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                           delta),
             *tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, causal,
                                             delta)) for _ in range(2)]
    torch.cuda.synchronize()
    variant = tflash.bwd_variant(dtype)
    for w, b in zip(wrappers, before):
        assert {n: w.launches_by_variant[n] - b[n] for n in b} == {
            n: 2 if n == variant else 0 for n in b}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    want = (tflash.flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                                    causal),
            *tflash.flash_attention_bwd_dkv_reference(q, k, v, out, lse, do,
                                                      causal))
    for g, w in zip(runs[0], want):
        assert g.shape == w.shape and g.dtype == w.dtype
        # the scale has a floor of 1 (the inputs' own): at S = 1 dq and dk
        # are 0 up to rounding
        scale = max(float(w.float().abs().max()), 1.0)
        _close(g, w, BWD_ATOL[dtype] * scale, BWD_RTOL[dtype])
    ref = tflash.flash_attention_bwd_delta_reference(out, do)
    _close(delta, ref, DELTA_REL * max(float(ref.abs().max()), 1.0))


@DTYPES
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_backward_delta_kernel_matches_the_plain_rowsum(card, dtype,
                                                             D):
    out, do = (_rnd(card, dtype, 2, 77, 6, D) for _ in range(2))
    delta = tflash.flash_attention_bwd_delta(out, do)
    ref = tflash.flash_attention_bwd_delta_reference(out, do)
    assert delta.shape == (2, 6, 77) and delta.dtype == torch.float32
    assert torch.equal(delta, tflash.flash_attention_bwd_delta(out, do))
    _close(delta, ref, DELTA_REL * max(float(ref.abs().max()), 1.0))


def test_flash_backward_without_delta_computes_its_own(card):
    """dq and dk/dv called without delta launch the delta kernel
    themselves and give what they give with it."""
    q, k, v, do = (_rnd(card, torch.bfloat16, 1, 90, 4, 64)
                   for _ in range(4))
    out, lse = tflash.flash_attention_fwd(q, k, v)
    delta = tflash.flash_attention_bwd_delta(out, do)
    n = tflash.flash_attention_bwd_delta.launches
    got = (tflash.flash_attention_bwd_dq(q, k, v, out, lse, do),
           *tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do))
    want = (tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, True,
                                          delta),
            *tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, True,
                                            delta))
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd_delta.launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="delta"):
        tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, True,
                                      delta[:, :, :-1])


@pytest.mark.parametrize("arch", ["llama", "gpt2", "qwen2"])
def test_tiny_presets_serve_on_the_card(card, arch):
    """The tiny presets (head dim 32) serve through the kernels: the same
    greedy chains as the plain-version engine, f32."""
    kw = {"vocab_size": 2048} if arch == "qwen2" else {}
    kern = build_engine(arch, "tiny", dtype=torch.float32, **kw)
    assert kern.cfg.head_dim == 32
    plain = InferenceEngineV2(kern.cfg, params=kern.params,
                              config=kern.config, device="cuda",
                              plain_kernels=True)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, kern.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 30, 300)]
    got = kern.generate_batch(prompts, max_new_tokens=6)
    want = plain.generate_batch(prompts, max_new_tokens=6)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_training_steps_match_through_kernels_and_plain_versions(card):
    """llama tiny (head dim 32, GQA) in f32 under save_attn: the kernel
    engine launches flash forward, dq and dk/dv once per layer per step,
    and its losses and grad norms equal the plain engine's within f32
    summation order."""
    model = dt.Transformer(get_model_config(
        "llama", "tiny", dtype=torch.float32, remat=True,
        tiled_loss_shards=4))
    conf = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {
                "lr": 1e-3, "weight_decay": 0.1, "state_dtype": "int8f"}},
            "activation_checkpointing": {"policy": "save_attn"}}
    kern = dt.initialize(model=model, config=conf)
    plain = dt.initialize(model=model, config=conf, plain_kernels=True)
    rng = np.random.RandomState(3)
    batch = {"input_ids": rng.randint(0, model.cfg.vocab_size, (2, 256)
                                      ).astype(np.int32)}
    counters = (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
                tflash.flash_attention_bwd_dkv)
    for step in range(3):
        before = [c.launches for c in counters]
        n_delta = tflash.flash_attention_bwd_delta.launches
        km = kern.train_batch(batch)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == \
            [model.cfg.num_layers] * 3
        # f32: the CUDA-core pair computes delta itself
        assert tflash.flash_attention_bwd_delta.launches == n_delta
        pm = plain.train_batch(batch)
        for key in ("loss", "grad_norm"):
            assert float(km[key]) == pytest.approx(float(pm[key]),
                                                   rel=1e-4), (step, key)


@DTYPES
@pytest.mark.parametrize("S,K,N,r", [(37, 300, 200, 16), (8, 128, 77, 1),
                                     (70, 64, 64, 128), (20, 1100, 96, 40)])
def test_lora_kernel_matches_plain_version(card, dtype, S, K, N, r):
    rng = np.random.RandomState(5)
    slots = 4
    x = _rnd(card, dtype, S, K)
    a = _rnd(card, torch.float32, slots, K, r) / K ** 0.5
    b = _rnd(card, torch.float32, slots, r, N)
    # unsorted, with base rows and an empty slot (slots - 1)
    ids = rng.randint(-1, slots - 1, S).astype(np.int32)
    x[torch.from_numpy(ids < 0).cuda()] = float("nan")   # never multiplied
    before = tlora.lora_delta.launches
    got = tlora.lora_delta(x, a, b, ids, scaling=0.5)
    assert tlora.lora_delta.launches == before + 1
    ref = tlora.lora_delta_reference(x, a, b, ids, scaling=0.5)
    base = torch.from_numpy(ids < 0).cuda()
    torch.cuda.synchronize()
    assert (got[base] == 0).all() and not got[base].signbit().any()
    _close(got[~base], ref[~base], LORA_REL * float(ref.abs().max()))
    none = tlora.lora_delta(x, a, b, np.full(S, -1, np.int32))
    torch.cuda.synchronize()
    assert (none == 0).all()


# the fused LoRA kernel (one launch, bulk copies) against the plain
# version and the two-pass kernel: (S, K, N, r, x dtype); K 1000 and 1003
# are not multiples of 8 (bf16 rows off the bulk copies' 16-byte grain),
# N 777 and 1001 not multiples of 4 (B rows and the output stores
# likewise), S 1 one row, S 2048 at K = N = 4096 more work items (~3600)
# than resident CTAs, r 40 and 128 factor spans of several ring slots
LORA_FUSED_CASES = [(32, 4096, 4096, 16, torch.bfloat16),
                    (1, 4096, 4096, 16, torch.bfloat16),
                    (2048, 4096, 4096, 16, torch.bfloat16),
                    (77, 1000, 777, 16, torch.bfloat16),
                    (45, 1003, 1001, 40, torch.bfloat16),
                    (64, 4096, 512, 128, torch.bfloat16),
                    (33, 1003, 96, 1, torch.float32),
                    (64, 4096, 4096, 16, torch.float32)]


@pytest.mark.parametrize("S,K,N,r,dtype", LORA_FUSED_CASES, ids=[
    f"s{s}-k{k}-n{n}-r{r}-{str(d)[6:]}" for s, k, n, r, d in LORA_FUSED_CASES])
def test_lora_fused_matches_plain_version_and_two_pass(card, S, K, N, r,
                                                       dtype):
    """The fused kernel within LORA_REL of the plain version and of the
    two-pass kernel, base rows exactly +0.0 though their x rows hold NaN,
    reruns bitwise equal (the counters back at zero after each call), and
    one launch counted on its variant."""
    rng = np.random.RandomState(S + K)
    slots = 4
    x = _rnd(card, dtype, S, K)
    a = _rnd(card, torch.float32, slots, K, r) / K ** 0.5
    b = _rnd(card, torch.float32, slots, r, N)
    ids = rng.randint(-1, slots - 1, S).astype(np.int32)
    ids[0] = -1 if S > 1 else 1        # a base row; one adapter row alone
    base = torch.from_numpy(ids < 0).cuda()
    x[base] = float("nan")
    rows = tlora.LoraRows(ids)
    before = dict(tlora.lora_delta.launches_by_variant)
    runs = [tlora.lora_delta(x, a, b, rows, scaling=0.5) for _ in range(2)]
    two = tlora.lora_delta(x, a, b, rows, scaling=0.5, variant="two_pass")
    ref = tlora.lora_delta_reference(x, a, b, rows, scaling=0.5)
    torch.cuda.synchronize()
    got = runs[0]
    assert torch.equal(runs[0], runs[1])
    assert (got[base] == 0).all() and not got[base].signbit().any()
    scale = LORA_REL * float(ref[~base].abs().max())
    _close(got[~base], ref[~base], scale)
    _close(got[~base], two[~base], scale)
    assert {v: n - before[v] for v, n in
            tlora.lora_delta.launches_by_variant.items()} == {
        "fused": 2, "two_pass": 1}


def test_lora_fused_counters_return_to_zero(card):
    """The fused kernel leaves the counter region of the next call on
    its stream at zero (each call zeroes the region the previous one
    used), so a call after a larger one and on a second stream gives the
    same bits."""
    g = card
    a = _rnd(g, torch.float32, 3, 512, 8) / 512 ** 0.5
    b = _rnd(g, torch.float32, 3, 8, 256)
    rng = np.random.RandomState(3)
    big = _rnd(g, torch.bfloat16, 300, 512)
    small = _rnd(g, torch.bfloat16, 20, 512)
    ids_big = rng.randint(-1, 3, 300).astype(np.int32)
    ids_small = rng.randint(-1, 3, 20).astype(np.int32)
    first = tlora.lora_delta(small, a, b, ids_small)
    tlora.lora_delta(big, a, b, ids_big)
    again = tlora.lora_delta(small, a, b, ids_small)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = tlora.lora_delta(small, a, b, ids_small)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, other)
    from deepspeed_tpu_torch.ops import _scratch
    for stream in (torch.cuda.current_stream(), side):
        ctr = _scratch.buffer("lora_ctr", torch.device("cuda"),
                              stream.cuda_stream, 1, torch.int32)
        region = ctr.numel() // 2
        nxt = tlora._fused_calls[ctr.data_ptr()] & 1
        assert int(ctr[nxt * region:(nxt + 1) * region].abs().sum()) == 0


def test_lora_variant_refusals(card):
    x = _rnd(card, torch.bfloat16, 8, 64)
    a = _rnd(card, torch.float32, 2, 64, 4)
    b = _rnd(card, torch.float32, 2, 4, 32)
    ids = np.zeros(8, np.int32)
    before = tlora.lora_delta.launches
    for bad in ("cuda", "fused ", "mma"):
        with pytest.raises(ValueError, match="variant"):
            tlora.lora_delta(x, a, b, ids, variant=bad)
    with pytest.raises(ValueError, match="out of range"):
        tlora.lora_delta(x, a, b, np.full(8, 2, np.int32))
    assert tlora.lora_delta.launches == before


def test_hopper_bulk_rows_land_at_their_pitch(card):
    """1-D bulk copies of gathered byte ranges (the LoRA kernel's x rows:
    rows of a [rows, K] tensor at a K offset) into shared memory at a row
    pitch, byte for byte."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _selftest("dstt_selftest_bulk_rows",
                   (P, P, P, I, ctypes.c_longlong, I, I, I, P))
    src = torch.randint(0, 256, (40, 1024), generator=card, device="cuda",
                        dtype=torch.int32).to(torch.uint8)
    for rows, col0, nbytes, pitch in (([5, 0, 39, 7, 7], 256, 512, 512),
                                      (list(range(16))[::-1], 48, 80, 96),
                                      ([3] * 32, 1008, 16, 16)):
        idx = torch.tensor(rows, dtype=torch.int32, device="cuda")
        dst = torch.full((len(rows) * pitch,), 7, dtype=torch.uint8,
                         device="cuda")
        rc = fn(src.data_ptr(), dst.data_ptr(), idx.data_ptr(), len(rows),
                1024, col0, nbytes, pitch,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        got = dst.view(len(rows), pitch)[:, :nbytes]
        assert torch.equal(got, src[idx.long(), col0:col0 + nbytes])
    bad = fn(src.data_ptr(), dst.data_ptr(), idx.data_ptr(), 4, 1024, 8,
             16, 16, torch.cuda.current_stream().cuda_stream)
    assert bad != 0   # an offset off the 16-byte grain is refused


# one step of the forward's masked score tile: (block, owned query
# blocks, the step's entries (key block << 4 | owner mask, or -1), causal)
SCORE_CASES = [(16, (0, 1, 2, 3), (0 << 4 | 15, 2 << 4 | 5, 7 << 4 | 8, -1),
                True),
               (16, (4, 5, 6, -1), (1 << 4 | 1, 5 << 4 | 6, -1, -1), False),
               (32, (2, 3), (0 << 4 | 3, 3 << 4 | 2), True),
               (64, (1,), (1 << 4 | 1,), True),
               (64, (2,), (-1,), False)]


@pytest.mark.parametrize("block,own,ents,causal", SCORE_CASES, ids=[
    f"b{b}-{i}" for i, (b, *_) in enumerate(SCORE_CASES)])
def test_hopper_sparse_scores_hide_what_an_owner_does_not_visit(
        card, block, own, ents, causal):
    """The forward's step: Q's owned blocks and the gathered K blocks by
    TMA, S = Q K^T by wgmma, then the owner mask: a row sees a key only
    where its owner's mask bit is set, the entry is not -1 and (causal)
    the key is not past the query; masked entries are exactly -1e30."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _selftest("dstt_selftest_sparse_scores",
                   (P, P, P, I, I, I, I, P, I, I, I, ctypes.c_float, P))
    S = 8 * block
    q = _rnd(card, torch.bfloat16, S, 64)
    k = _rnd(card, torch.bfloat16, S, 64)
    ent = torch.tensor(ents, dtype=torch.int32, device="cuda")
    owners = list(own) + [-1] * (4 - len(own))
    out = torch.full((64, 64), float("nan"), device="cuda")
    scale = 0.125 * 1.4426950408889634
    rc = fn(q.data_ptr(), k.data_ptr(), ent.data_ptr(), *owners,
            out.data_ptr(), S, block, int(causal), scale,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    qrows = torch.zeros(64, 64, device="cuda")
    krows = torch.zeros(64, 64, device="cuda")
    vis = torch.zeros(64, 64, dtype=torch.bool)
    for r in range(64):
        o = owners[r // block]
        if o >= 0:
            qrows[r] = q[o * block + r % block].float()
    for c in range(64):
        e = ents[c // block]
        if e >= 0:
            krows[c] = k[(e >> 4) * block + c % block].float()
    for r in range(64):
        o, qb = r // block, owners[r // block]
        for c in range(64):
            e = ents[c // block]
            kp = (e >> 4) * block + c % block
            vis[r, c] = (e >= 0 and (e >> o) & 1 == 1 and qb >= 0
                         and (not causal or kp <= qb * block + r % block))
    want = (qrows @ krows.t()) * scale
    vis = vis.cuda()
    assert torch.equal(out[~vis], torch.full_like(out[~vis], -1e30))
    if vis.any():
        _close(out[vis], want[vis], 1e-3, 1e-5)


@DTYPES
@pytest.mark.parametrize("NH,NKV,D", [(8, 2, 128), (4, 4, 64), (4, 2, 32)])
def test_merged_wrappers_equal_the_5d_kernels(card, dtype, NH, NKV, D):
    rng = np.random.RandomState(6)
    L, nb, bs, MB = 2, 40, 16, 24
    ak, av = (_rnd(card, dtype, L, nb, bs, NKV * D) for _ in range(2))
    lens = np.asarray([5, -1, 300, 0, 16, 383], np.int32)
    tables = rng.randint(-3, nb + 3, size=(lens.size, MB)).astype(np.int32)
    for i, n in enumerate(lens):
        live = max(int(n), 0) // bs + 1
        tables[i, :live] = rng.permutation(nb)[:live]
    q = _rnd(card, dtype, lens.size, NH, D)
    tables = torch.from_numpy(tables).cuda()
    lens = torch.from_numpy(lens).cuda()
    k5, v5 = tmerged.as_5d(ak, D), tmerged.as_5d(av, D)
    before = (tmerged.merged_decode_attention.launches,
              tdecode.paged_decode_attention.launches)
    got = tmerged.merged_decode_attention(q, ak, av, tables, lens,
                                          layer_idx=1)
    assert (tmerged.merged_decode_attention.launches,
            tdecode.paged_decode_attention.launches) == (before[0] + 1,
                                                         before[1])
    assert torch.equal(got, tdecode.paged_decode_attention(
        q, k5, v5, tables, lens, layer_idx=1))
    _close(got, tmerged.merged_decode_reference(q, ak, av, tables, lens,
                                                layer_idx=1),
           ATOL[dtype], RTOL[dtype])
    qc = _rnd(card, dtype, 70, NH, D)
    got = tmerged.merged_prefill_attention(qc, ak, av, tables[2], 100, 61,
                                           layer_idx=0)
    assert torch.equal(got[:61], tprefill.paged_prefill_attention(
        qc, k5, v5, tables[2], 100, 61, layer_idx=0)[:61])
    _close(got[:61], tmerged.merged_prefill_reference(
        qc, ak, av, tables[2], 100, 61, layer_idx=0)[:61],
        ATOL[dtype], RTOL[dtype])


# ----------------------------------------------------------------------
# the paged TMA kernels (bf16): every block size, group and head dim they
# take, against the plain versions and the mma.sync kernels they replace
# ----------------------------------------------------------------------
def _paged_arena(card, L, nb, bs, NKV, D):
    return (_rnd(card, torch.bfloat16, L, nb, bs, NKV, D) for _ in range(2))


def _live_tables(rng, lens, MB, nb, bs):
    """Live blocks distinct and first; garbage (negative and past the
    arena) after them."""
    tables = rng.randint(-5, nb + 5, size=(len(lens), MB)).astype(np.int32)
    for b, n in enumerate(lens):
        live = min(max(int(n), 0) // bs + 1, MB)
        tables[b, :live] = rng.permutation(nb)[:live]
    return tables


def _by_variant(fn):
    return dict(fn.launches_by_variant)


@pytest.mark.parametrize("bs,G,D", [
    (16, 1, 128), (32, 4, 64), (64, 8, 32), (128, 1, 128), (64, 4, 128),
    (16, 8, 64), (64, 1, 64), (8, 2, 32), (128, 8, 128), (32, 1, 32)])
def test_paged_decode_tma_matches_plain_version_and_mma_kernel(card, bs, G,
                                                               D):
    rng = np.random.RandomState(bs + G + D)
    NKV, L, MB = 2, 2, max(1600 // bs, 2)
    nb = MB + 7
    ak, av = _paged_arena(card, L, nb, bs, NKV, D)
    lens = np.asarray([-1, 0, bs - 1, bs, 37, 1499, -4, MB * bs + 9],
                      np.int32)
    tables = torch.from_numpy(_live_tables(rng, lens, MB, nb, bs)).cuda()
    q = _rnd(card, torch.bfloat16, lens.size, G * NKV, D)
    lens_t = torch.from_numpy(lens).cuda()
    args = (q, ak, av, tables, lens_t)
    assert tdecode.decode_variant(torch.bfloat16, D, bs, G) == "tma"
    before = _by_variant(tdecode.paged_decode_attention)
    got = tdecode.paged_decode_attention(*args, layer_idx=1)
    after = _by_variant(tdecode.paged_decode_attention)
    assert after["tma"] == before["tma"] + 1
    assert after["mma"] == before["mma"]
    ref = tdecode.paged_decode_reference(*args, layer_idx=1)
    _close(got, ref, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
    assert (got[torch.from_numpy(lens < 0).cuda()] == 0).all()
    for _ in range(2):
        assert torch.equal(got, tdecode.paged_decode_attention(
            *args, layer_idx=1))
    old = tdecode.paged_decode_attention(*args, layer_idx=1, variant="mma")
    assert _by_variant(tdecode.paged_decode_attention)["mma"] == \
        before["mma"] + 1
    _close(old, ref, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
    mk, mv = (t.view(L, nb, bs, NKV * D) for t in (ak, av))
    assert torch.equal(got, tmerged.merged_decode_attention(
        q, mk, mv, tables, lens_t, layer_idx=1))


@pytest.mark.parametrize("C,n_valid,pos0,window,bs,G,D", [
    (1, 1, 0, None, 16, 1, 128), (3, 3, 77, None, 64, 4, 128),
    (70, 61, 100, None, 32, 8, 64), (256, 250, 1024, None, 64, 1, 128),
    (512, 500, 0, None, 16, 4, 32), (256, 256, 300, 8, 64, 1, 128),
    (256, 200, 700, 128, 128, 4, 64), (64, 64, 0, 128, 16, 8, 32),
    (256, 256, 0, None, 64, 1, 128), (70, 70, 1000, 8, 128, 1, 32),
    (256, 256, 1024, None, 8, 2, 64)])
def test_paged_prefill_tma_matches_plain_version_and_mma_kernel(
        card, C, n_valid, pos0, window, bs, G, D):
    rng = np.random.RandomState(C + pos0 + bs)
    NKV, L = 2, 2
    MB = -(-(pos0 + C) // bs) + 3
    nb = MB + 5
    ak, av = _paged_arena(card, L, nb, bs, NKV, D)
    table = torch.from_numpy(_live_tables(
        rng, [pos0 + n_valid - 1], MB, nb, bs)[0]).cuda()
    q = _rnd(card, torch.bfloat16, C, G * NKV, D)
    args = (q, ak, av, table, pos0, n_valid)
    assert tprefill.prefill_variant(torch.bfloat16, D, bs) == "tma"
    before = _by_variant(tprefill.paged_prefill_attention)
    got = tprefill.paged_prefill_attention(*args, sliding_window=window,
                                           layer_idx=1)
    after = _by_variant(tprefill.paged_prefill_attention)
    assert after["tma"] == before["tma"] + 1
    assert after["mma"] == before["mma"]
    ref = tprefill.paged_prefill_reference(*args, sliding_window=window,
                                           layer_idx=1)
    _close(got[:n_valid], ref[:n_valid], ATOL[torch.bfloat16],
           RTOL[torch.bfloat16])
    for _ in range(2):
        assert torch.equal(got, tprefill.paged_prefill_attention(
            *args, sliding_window=window, layer_idx=1))
    old = tprefill.paged_prefill_attention(*args, sliding_window=window,
                                           layer_idx=1, variant="mma")
    _close(old[:n_valid], ref[:n_valid], ATOL[torch.bfloat16],
           RTOL[torch.bfloat16])
    mk, mv = (t.view(L, nb, bs, NKV * D) for t in (ak, av))
    assert torch.equal(got, tmerged.merged_prefill_attention(
        q, mk, mv, table, pos0, n_valid, sliding_window=window,
        layer_idx=1))


def test_paged_tma_kernels_ignore_nan_past_the_keys_they_may_read(card):
    """Arena rows past a sequence's keys (and before a window's start)
    hold NaN: P is 0 there, and the kernels never let the garbage in."""
    rng = np.random.RandomState(9)
    L, nb, bs, NKV, D, MB = 1, 40, 16, 2, 64, 32
    ak, av = (t.fill_(float("nan")) for t in _paged_arena(
        card, L, nb, bs, NKV, D))
    lens = np.asarray([20, 200, 7], np.int32)
    tables = _live_tables(rng, lens, MB, nb, bs)
    g = torch.Generator(device="cuda").manual_seed(9)
    for b, n in enumerate(lens):
        for j in range(int(n) // bs + 1):
            blk = tables[b, j]
            rows = min(bs, int(n) + 1 - j * bs)
            for t in (ak, av):
                t[0, blk, :rows] = torch.randn(
                    rows, NKV, D, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    tables_t = torch.from_numpy(tables).cuda()
    q = _rnd(card, torch.bfloat16, 3, 4, D)
    got = tdecode.paged_decode_attention(q, ak, av, tables_t,
                                         torch.from_numpy(lens).cuda(),
                                         layer_idx=0)
    assert torch.isfinite(got).all()
    # a 17-query chunk ending at key 200, window 40
    qc = _rnd(card, torch.bfloat16, 17, 4, D)
    out = tprefill.paged_prefill_attention(qc, ak, av, tables_t[1], 184, 17,
                                           sliding_window=40, layer_idx=0)
    assert torch.isfinite(out).all()


def test_paged_wrappers_refuse_a_variant_that_cannot_take_the_call(card):
    rng = np.random.RandomState(3)
    L, nb, bs, NKV, D, MB = 1, 12, 24, 2, 64, 4
    ak, av = _paged_arena(card, L, nb, bs, NKV, D)
    tables = torch.from_numpy(_live_tables(rng, [30, 5], MB, nb, bs)).cuda()
    lens = torch.tensor([30, 5], dtype=torch.int32, device="cuda")
    q = _rnd(card, torch.bfloat16, 2, 4, D)
    # bs 24: no TMA tile; the mma.sync kernels take it
    assert tdecode.decode_variant(torch.bfloat16, D, bs, 2) == "mma"
    with pytest.raises(ValueError, match="cannot take"):
        tdecode.paged_decode_attention(q, ak, av, tables, lens, layer_idx=0,
                                       variant="tma")
    with pytest.raises(ValueError, match="cannot take"):
        tprefill.paged_prefill_attention(q, ak, av, tables[0], 0, 2,
                                         layer_idx=0, variant="tma")
    with pytest.raises(ValueError, match="cannot take"):
        tdecode.paged_decode_attention(q, ak, av, tables, lens, layer_idx=0,
                                       variant="f32")
    with pytest.raises(ValueError, match="one of"):
        tprefill.paged_prefill_attention(q, ak, av, tables[0], 0, 2,
                                         layer_idx=0, variant="wgmma")
    before = _by_variant(tdecode.paged_decode_attention)
    tdecode.paged_decode_attention(q, ak, av, tables, lens, layer_idx=0)
    assert _by_variant(tdecode.paged_decode_attention)["mma"] == \
        before["mma"] + 1


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(card):
    ids = np.zeros(4, np.int32)
    x = _rnd(card, torch.float32, 4, 64)
    a = _rnd(card, torch.float32, 2, 64, 129)
    b = _rnd(card, torch.float32, 2, 129, 32)
    with pytest.raises(ValueError, match="rank"):
        tlora.lora_delta(x, a, b, ids)
    a, b = a[:, :, :8].contiguous(), b[:, :8].contiguous()
    with pytest.raises(TypeError):
        tlora.lora_delta(x.half(), a, b, ids)
    with pytest.raises(TypeError, match="f32"):
        tlora.lora_delta(x, a.bfloat16(), b, ids)
    with pytest.raises(ValueError, match="contiguous"):
        tlora.lora_delta(x, a.transpose(1, 2).contiguous().transpose(1, 2),
                         b, ids)
    with pytest.raises(ValueError, match="out of range"):
        tlora.lora_delta(x, a, b, np.asarray([0, 1, 2, -1], np.int32))
    arena = _rnd(card, torch.float32, 1, 4, 8, 2 * 48)
    q = _rnd(card, torch.float32, 2, 2, 48)
    ints = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tmerged.merged_decode_attention(q, arena, arena, ints, ints[:, 0],
                                        layer_idx=0)
    with pytest.raises(ValueError, match="head dim"):
        tmerged.merged_prefill_attention(q, arena, arena, ints[0], 0, 2,
                                         layer_idx=0)


def test_engine_serves_adapters_through_the_kernel(card):
    """Adapter and base rows in one wave, f32, on a merged arena: the
    kernel engine launches the LoRA kernel once per layer per serving call
    with adapter rows and gives the plain-version engine's chains; base
    rows give what an engine without adapters gives."""
    cfg = get_model_config("llama", "tiny", dtype=torch.float32,
                           hidden_size=512, num_heads=8, num_kv_heads=4)
    ecfg = RaggedInferenceEngineConfig(
        num_blocks=64, block_size=16, max_blocks_per_seq=16, max_seqs=8,
        prefill_chunk_size=32, max_prefill_tokens_per_step=64,
        arena_merged=True)
    kern = InferenceEngineV2(cfg, config=ecfg, device="cuda")
    plain = InferenceEngineV2(cfg, params=kern.params, config=ecfg,
                              device="cuda", plain_kernels=True)
    rng = np.random.RandomState(7)
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 40, 100)]
    factors = {f"a{i}": (rng.randn(L, K, 8) / K ** 0.5, rng.randn(L, 8, H))
               for i in range(2)}
    base = kern.generate_batch(prompts, max_new_tokens=8)
    chains = []
    for eng in (kern, plain):
        # rank 8 over K = H = 512: 2 blocks a layer, so 4 L blocks hold
        # both adapters
        pool = AdapterPool(eng, 4 * L)
        for aid, (a, b) in factors.items():
            pool.register(aid, a, b)
        for uid, aid in ((0, "a0"), (2, "a1"), (3, "a0")):
            eng.set_adapter(uid, pool.reserve(aid))
        before = tlora.lora_delta.launches
        chains.append([c.tolist() for c in eng.generate_batch(
            prompts, max_new_tokens=8)])
        launched = tlora.lora_delta.launches - before
        assert launched > 0 if eng is kern else launched == 0
        assert launched % L == 0
    assert chains[0] == chains[1]
    assert chains[0][1] == base[1].tolist()
    assert all(chains[0][i] != base[i].tolist() for i in (0, 2, 3))


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16],
                         ids=["g-f32", "g-bf16"])
@pytest.mark.parametrize("shape", [(64, 256), (7, 100), (5, 33), (300,),
                                   (2, 30000)],
                         ids=["vec", "rows-of-100", "odd-R", "1d",
                              "recompute"])
def test_fused_adam8_kernel_matches_plain_version(card, gdtype, shape):
    """Inputs after one real quantized step; the kernel in place on copies
    of the state (as the engine calls it) and out of place."""
    from deepspeed_tpu_torch.runtime import optimizers as topt
    p = _rnd(card, torch.float32, *shape) * 0.1
    g = (_rnd(card, torch.float32, *shape) * 1e-3).to(gdtype)
    m0 = _rnd(card, torch.float32, *shape) * 1e-3
    m_q, m_s = topt._q8_signed(m0)
    v_q, v_s = topt._q8_log(m0 * m0)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.1, adam_w=True)
    args = (1e-3, torch.tensor(0.5, device="cuda"), 1 - 0.9 ** 2,
            1 - 0.999 ** 2)
    want = tadam8.fused_adam8_leaf_reference(g, m_q, m_s, v_q, v_s, p,
                                             *args, **kw)
    before = tadam8.fused_adam8_leaf.launches
    got = tadam8.fused_adam8_leaf(g, m_q, m_s, v_q, v_s, p, *args, **kw)
    state = [t.clone() for t in (m_q, m_s, v_q, v_s, p)]
    cast = torch.empty_like(p, dtype=torch.bfloat16)
    inplace = tadam8.fused_adam8_leaf(
        g, *state, *args, out=(state[4], cast, state[0], state[1], state[2],
                               state[3]), **kw)
    torch.cuda.synchronize()
    assert tadam8.fused_adam8_leaf.launches == before + 2
    for res in (got, inplace):
        _close(res[0], want[0], ADAM8_ATOL, ADAM8_RTOL)
        assert torch.equal(res[1], res[0].bfloat16())
        for i in (2, 4):
            assert int((res[i].int() - want[i].int()).abs().max()) <= 1
        for i in (3, 5):
            _close(res[i], want[i], 0.0, 1e-6)
    assert inplace[0] is state[4] and inplace[2] is state[0]


SPARSE_CASES = [(8, 64), (16, 128), (24, 64), (64, 64), (128, 128),
                (64, 192), (112, 256), (128, 256)]


def _sparse_layout(H, nb, seed):
    """BigBird-like per-head layout with one q-block that sees no key
    block at all (a fully-masked row)."""
    rng = np.random.RandomState(seed)
    layout = rng.rand(H, nb, nb) < 0.3
    layout |= np.eye(nb, dtype=bool)[None]
    layout[:, :, 0] = True
    layout[0, 2] = False
    layout[0, 2, 5] = True          # row 2 of head 0: one later block only
    return layout


@DTYPES
@pytest.mark.parametrize("block,D", SPARSE_CASES,
                         ids=[f"block{b}-d{d}" for b, d in SPARSE_CASES])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sparse_kernels_match_plain_versions(card, dtype, block, D, causal):
    B, H, nb = 2, 2, 8
    S = nb * block
    q, k, v, do = (_rnd(card, dtype, B, S, H, D) for _ in range(4))
    kidx = tsparse._layout_to_gather(_sparse_layout(H, nb, block))
    idx, rev, _ = tsparse._device_tables(kidx, "cuda", block)
    counts = [c.launches for c in (tsflash.block_sparse_flash_attention,
                                   tsflash.block_sparse_flash_dq,
                                   tsflash.block_sparse_flash_dkv)]
    out, lse = tsflash.block_sparse_flash_attention(
        q, k, v, idx, block, causal=causal, return_lse=True)
    ref, ref_lse = tsflash.block_sparse_flash_attention_reference(
        q, k, v, idx, block, causal=causal)
    _close(out, ref, ATOL[dtype], RTOL[dtype])
    _close(lse, ref_lse, LSE_ATOL, 1e-6)
    if causal:   # head 0, q-block 2 sees only block 5: out 0, lse finite
        rows = slice(2 * block, 3 * block)
        assert (out[:, rows, 0] == 0).all()
        assert torch.isfinite(lse).all()
    got = tsflash.block_sparse_flash_backward(q, k, v, idx, rev, out, do,
                                              lse, block, causal=causal)
    want = (tsflash.block_sparse_flash_dq_reference(
                q, k, v, idx, out, do, lse, block, causal),
            *tsflash.block_sparse_flash_dkv_reference(
                q, k, v, idx, out, do, lse, block, causal))
    for gt, w in zip(got, want):
        assert gt.shape == w.shape and gt.dtype == w.dtype
        scale = max(float(w.float().abs().max()), 1.0)
        _close(gt, w, BWD_ATOL[dtype] * scale, BWD_RTOL[dtype])
    assert [c.launches for c in (tsflash.block_sparse_flash_attention,
                                 tsflash.block_sparse_flash_dq,
                                 tsflash.block_sparse_flash_dkv)] == \
        [n + 1 for n in counts]


# the wgmma pair (bf16, D 64 / 128, block 16 / 32 / 64): phase 1's edges
SPARSE_WGMMA_CASES = [(16, 64, True), (16, 128, False), (32, 64, False),
                      (32, 128, True), (64, 64, True), (64, 128, False)]
# delta vs its plain rowsum: f32 sums of D exact products in another order
DELTA_REL = 1e-5


def _bwd_walks(block):
    """(owners, grouping) of every walk the wgmma pair takes at block."""
    return [(r, g) for r in tsflash.OWNER_GROUPS[block]
            for g in tsflash.WALK_GROUPINGS if r > 1 or g == "adjacent"]


@pytest.mark.parametrize("block,D,causal", SPARSE_WGMMA_CASES, ids=[
    f"block{b}-d{d}-{'causal' if c else 'full'}"
    for b, d, c in SPARSE_WGMMA_CASES])
def test_sparse_wgmma_pair_and_delta_match_plain_versions(card, block, D,
                                                         causal):
    """The delta kernel and the wgmma dq and dk/dv over every walk the
    plan can give (1, 2 or 4 owners a CTA, adjacent or sorted): 12 blocks
    a row, so lists end mid-step; the fully-masked row gives 0 gradients;
    reruns are bit-identical."""
    B, H, nb = 2, 2, 12
    S = nb * block
    q, k, v, do = (_rnd(card, torch.bfloat16, B, S, H, D) for _ in range(4))
    kidx = tsparse._layout_to_gather(_sparse_layout(H, nb, block + 1))
    idx, rev, _ = tsparse._device_tables(kidx, "cuda", block)
    out, lse = tsflash.block_sparse_flash_attention(
        q, k, v, idx, block, causal=causal, return_lse=True)
    delta = tsflash.block_sparse_flash_bwd_delta(out, do)
    want_delta = tsflash.block_sparse_flash_bwd_delta_reference(out, do)
    _close(delta, want_delta, DELTA_REL * max(
        float(want_delta.abs().max()), 1.0))
    want = (tsflash.block_sparse_flash_dq_reference(
                q, k, v, idx, out, do, lse, block, causal),
            *tsflash.block_sparse_flash_dkv_reference(
                q, k, v, idx, out, do, lse, block, causal))
    for owners, grouping in _bwd_walks(block):
        plan = tsflash.bwd_plan(kidx, block, "cuda", owners, grouping)
        before = [dict(f.launches_by_variant) for f in (
            tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv)]
        runs = [tsflash.block_sparse_flash_backward(
                    q, k, v, idx, rev, out, do, lse, block, causal=causal,
                    plan=plan, variant="wgmma") for _ in range(2)]
        torch.cuda.synchronize()
        for gt, rr, w in zip(*runs, want):
            scale = max(float(w.float().abs().max()), 1.0)
            _close(gt, w, BWD_ATOL[torch.bfloat16] * scale,
                   BWD_RTOL[torch.bfloat16])
            assert torch.equal(gt, rr), (owners, grouping)
        if causal:   # head 0, q-block 2 sees only block 5
            assert (runs[0][0][:, 2 * block:3 * block, 0] == 0).all()
        for f, b4 in zip((tsflash.block_sparse_flash_dq,
                          tsflash.block_sparse_flash_dkv), before):
            assert f.launches_by_variant["wgmma"] == b4["wgmma"] + 2


# the bf16 forward on TMA + wgmma (`sparse_fwd_wgmma`): (B, nb, block, D,
# causal); nb 10 at block 16 and 9 at block 32 leave a ragged last group
# of query blocks (4 and 2 a CTA), and 12 blocks a row end lists mid-step
SPARSE_FWD_CASES = [(2, 12, 16, 64, True), (2, 10, 16, 128, False),
                    (2, 9, 32, 64, False), (1, 12, 32, 128, True),
                    (2, 6, 64, 64, True), (1, 7, 64, 128, False)]


@pytest.mark.parametrize("B,nb,block,D,causal", SPARSE_FWD_CASES, ids=[
    f"nb{n}-block{b}-d{d}-{'causal' if c else 'full'}"
    for _, n, b, d, c in SPARSE_FWD_CASES])
def test_sparse_forward_wgmma_matches_plain_version_and_mma(card, B, nb,
                                                           block, D, causal):
    """The wgmma forward on its plan's walk and on both groupings: within
    the forward tolerance of the plain version and of the mma.sync
    kernel; NaN in the key and value blocks no row visits never reaches
    the output; the fully-masked row gives out 0 and a finite lse; reruns
    bitwise equal; launches counted on their variant."""
    H = 2
    S = nb * block
    q = _rnd(card, torch.bfloat16, B, S, H, D)
    k = _rnd(card, torch.bfloat16, B, S, H, D)
    v = _rnd(card, torch.bfloat16, B, S, H, D)
    layout = _sparse_layout(H, nb, block + nb)
    layout[:, :, nb - 1] = False            # no row visits the last block
    layout[1, 3] = False
    layout[1, 3, 3] = True
    k[:, (nb - 1) * block:] = float("nan")
    v[:, (nb - 1) * block:] = float("nan")
    kidx = tsparse._layout_to_gather(layout)
    idx, rev, plan = tsparse._device_tables(kidx, "cuda", block)
    ref, ref_lse = tsflash.block_sparse_flash_attention_reference(
        q, k, v, idx, block, causal=causal)
    mma, mma_lse = tsflash.block_sparse_flash_attention(
        q, k, v, idx, block, causal, return_lse=True, variant="mma")
    plans = [plan] + [dataclasses.replace(plan, fwd=w, fwd_device=(
        torch.from_numpy(w.sched).cuda(), torch.from_numpy(w.ents).cuda()))
        for w in (tsflash.tile_walk(kidx, block, 64 // block, g, ragged=True)
                  for g in tsflash.WALK_GROUPINGS)]
    fwd = tsflash.block_sparse_flash_attention
    for p in plans:
        before = dict(fwd.launches_by_variant)
        runs = [fwd(q, k, v, idx, block, causal, return_lse=True, plan=p)
                for _ in range(2)]
        torch.cuda.synchronize()
        (out, lse), (out2, lse2) = runs
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        assert torch.isfinite(out.float()).all()
        assert torch.isfinite(lse).all()
        _close(out, ref, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
        _close(out, mma, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
        _close(lse, ref_lse, LSE_ATOL, 1e-6)
        _close(lse, mma_lse, LSE_ATOL, 1e-6)
        if causal:   # head 0, q-block 2 sees only block 5: out 0
            assert (out[:, 2 * block:3 * block, 0] == 0).all()
        assert {n: c - before[n] for n, c in
                fwd.launches_by_variant.items()} == {"wgmma": 2, "mma": 0,
                                                     "f32": 0}


def test_sparse_forward_refuses_a_variant_that_cannot_take_the_call(card):
    """A named forward kernel that does not take the call raises, nothing
    launches; a plan of another block or without the forward walk is
    refused."""
    fwd = tsflash.block_sparse_flash_attention

    def call(dtype, D, block, variant, plan_block=None):
        q = _rnd(card, dtype, 1, 8 * block, 2, D)
        layout = tsparse.FixedSparsityConfig(
            num_heads=2, block=block).make_layout(8 * block)
        kidx = tsparse._layout_to_gather(layout)
        idx, _, plan = tsparse._device_tables(kidx, "cuda", block)
        if plan_block is not None:
            plan = tsflash.bwd_plan(tsparse._layout_to_gather(
                tsparse.FixedSparsityConfig(num_heads=2, block=plan_block)
                .make_layout(8 * plan_block)), plan_block, "cuda")
        before = fwd.launches
        with pytest.raises(ValueError):
            fwd(q, q, q, idx, block, plan=plan, variant=variant)
        assert fwd.launches == before

    call(torch.bfloat16, 192, 16, "wgmma")
    call(torch.bfloat16, 64, 128, "wgmma")
    call(torch.bfloat16, 64, 8, "wgmma")
    call(torch.float32, 64, 16, "wgmma")
    call(torch.float32, 64, 16, "mma")
    call(torch.bfloat16, 64, 16, "f32")
    call(torch.bfloat16, 64, 16, "tma")
    call(torch.bfloat16, 64, 16, "wgmma", plan_block=32)
    for dtype, D, block, want in ((torch.bfloat16, 64, 16, "wgmma"),
                                  (torch.bfloat16, 192, 64, "mma"),
                                  (torch.bfloat16, 64, 8, "mma"),
                                  (torch.float32, 64, 16, "f32")):
        q = _rnd(card, dtype, 1, 8 * block, 2, D)
        kidx = tsparse._layout_to_gather(tsparse.FixedSparsityConfig(
            num_heads=2, block=block).make_layout(8 * block))
        idx, _, plan = tsparse._device_tables(kidx, "cuda", block)
        before = dict(fwd.launches_by_variant)
        fwd(q, q, q, idx, block, plan=plan)
        torch.cuda.synchronize()
        assert {n: c - before[n] for n, c in
                fwd.launches_by_variant.items()} == {
            n: int(n == want) for n in tsflash.FWD_VARIANTS}


def test_sparse_launches_by_variant_follow_the_rule(card):
    """SparseSelfAttention forward and backward: dq and dk/dv count one
    launch each on the pair `bwd_variant` names for the cached plan, and
    the delta kernel one launch where that pair is wgmma."""
    cases = [(tsparse.FixedSparsityConfig(num_heads=2, block=16), 64),
             (tsparse.LocalSlidingWindowSparsityConfig(num_heads=2,
                                                       block=32), 64),
             (tsparse.BigBirdSparsityConfig(num_heads=2, block=64), 64),
             (tsparse.FixedSparsityConfig(num_heads=2, block=16), 192),
             (tsparse.BigBirdSparsityConfig(num_heads=2, block=128), 128)]
    fns = (tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv)
    for cfg, D in cases:
        attn = tsparse.SparseSelfAttention(cfg)
        S = 8 * cfg.block
        q = _rnd(card, torch.bfloat16, 1, S, 2, D).requires_grad_()
        _, tables = attn.tables(S, "cuda")
        want = tsflash.bwd_variant(torch.bfloat16, D, cfg.block)
        before = [dict(f.launches_by_variant) for f in fns]
        deltas = tsflash.block_sparse_flash_bwd_delta.launches
        (attn(q, q, q).float() ** 2).sum().backward()
        torch.cuda.synchronize()
        for f, b4 in zip(fns, before):
            assert {n: c - b4[n] for n, c in f.launches_by_variant.items()
                    } == {n: int(n == want) for n in tsflash.BWD_VARIANTS}
        assert tsflash.block_sparse_flash_bwd_delta.launches - deltas == \
            int(want == "wgmma")


def test_sparse_wrappers_raise_on_what_their_variant_does_not_take(card):
    """A named pair that does not take the call raises; no other pair is
    tried and nothing launches."""
    fns = (tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv)

    def call(dtype, D, block, variant, plan_block=None):
        q = _rnd(card, dtype, 1, 8 * block, 2, D)
        layout = tsparse.FixedSparsityConfig(
            num_heads=2, block=block).make_layout(8 * block)
        kidx = tsparse._layout_to_gather(layout)
        idx, rev, plan = tsparse._device_tables(kidx, "cuda", block)
        if plan_block is not None:
            plan = tsflash.bwd_plan(tsparse._layout_to_gather(
                tsparse.FixedSparsityConfig(num_heads=2, block=plan_block)
                .make_layout(8 * plan_block)), plan_block, "cuda")
        out, lse = tsflash.block_sparse_flash_attention(q, q, q, idx, block,
                                                        return_lse=True)
        before = [f.launches for f in fns]
        for fn, args in ((tsflash.block_sparse_flash_dq, (idx,)),
                         (tsflash.block_sparse_flash_dkv, (idx, rev))):
            with pytest.raises(ValueError):
                fn(q, q, q, *args, out, q, lse, block, plan=plan,
                   variant=variant)
        assert [f.launches for f in fns] == before

    call(torch.bfloat16, 192, 16, "wgmma")
    call(torch.bfloat16, 64, 128, "wgmma")
    call(torch.bfloat16, 64, 8, "wgmma")
    call(torch.float32, 64, 16, "wgmma")
    call(torch.float32, 64, 16, "mma")
    call(torch.bfloat16, 64, 16, "f32")
    call(torch.bfloat16, 64, 16, "cuda")
    call(torch.bfloat16, 64, 16, "wgmma", plan_block=32)
    # the delta kernel takes what the wgmma pair reads, bf16 at D 64/128
    deltas = tsflash.block_sparse_flash_bwd_delta.launches
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 192),
                     (torch.bfloat16, 256)):
        o = _rnd(card, dtype, 1, 32, 2, D)
        with pytest.raises(ValueError):
            tsflash.block_sparse_flash_bwd_delta(o, o)
    assert tsflash.block_sparse_flash_bwd_delta.launches == deltas


def test_sparse_wgmma_call_without_a_plan_builds_its_walks_once(card):
    """dq, dk/dv and the backward called with no plan run the wgmma pair
    on `call_plan`'s walks, built once per table, and give what the
    cached module plan gives, bit for bit."""
    block, D = 16, 64
    layout = tsparse.FixedSparsityConfig(num_heads=2, block=block,
                                         attention="bidirectional",
                                         different_layout_per_head=True,
                                         num_different_global_patterns=2
                                         ).make_layout(8 * block)
    kidx = tsparse._layout_to_gather(layout)
    idx, rev, plan = tsparse._device_tables(kidx, "cuda", block)
    q, k, v, do = (_rnd(card, torch.bfloat16, 2, 8 * block, 2, D)
                   for _ in range(4))
    out, lse = tsflash.block_sparse_flash_attention(q, k, v, idx, block,
                                                    False, return_lse=True)
    want = tsflash.block_sparse_flash_backward(q, k, v, idx, rev, out, do,
                                               lse, block, False, plan=plan)
    tsflash._call_walks.clear()
    dq = tsflash.block_sparse_flash_dq(q, k, v, idx, out, do, lse, block,
                                       False)
    assert [k_[0] for k_ in tsflash._call_walks] == ["dq"]
    dk, dv = tsflash.block_sparse_flash_dkv(q, k, v, idx, rev, out, do, lse,
                                            block, False)
    walks = dict(tsflash._call_walks)
    got = tsflash.block_sparse_flash_backward(q, k, v, idx, rev, out, do,
                                              lse, block, False)
    assert {k_: id(w) for k_, w in tsflash._call_walks.items()} == {
        k_: id(w) for k_, w in walks.items()} and len(walks) == 2
    for a, b, c in zip((dq, dk, dv), got, want):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_sparse_self_attention_trains_through_the_kernels(card):
    """SparseSelfAttention forward and backward on the card, q/k/v sliced
    out of one fused [B, S, 3, H, D] projection (not contiguous): one
    launch of each kernel per call, and the gradients of the plain gather
    path."""
    cfg = tsparse.BigBirdSparsityConfig(num_heads=4, block=16,
                                        different_layout_per_head=True)
    attn = tsparse.SparseSelfAttention(cfg)
    plain = tsparse.SparseSelfAttention(cfg, impl="jnp")
    base = _rnd(card, torch.bfloat16, 2, 256, 3, 4, 64)
    grads = []
    counters = (tsflash.block_sparse_flash_attention,
                tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv)
    for mod in (attn, plain):
        qkv = base.clone().requires_grad_()
        before = [c.launches for c in counters]
        (mod(*qkv.unbind(2)).float() ** 2).sum().backward()
        torch.cuda.synchronize()
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([1, 1, 1] if mod is attn else [0, 0, 0])
        grads.append(qkv.grad.unbind(2))
    for g, w in zip(*grads):
        scale = max(float(w.float().abs().max()), 1.0)
        _close(g, w, BWD_ATOL[torch.bfloat16] * scale * 2,
               BWD_RTOL[torch.bfloat16] * 2)


@pytest.mark.parametrize("block,D", [(16, 96), (4, 64)],
                         ids=["d96", "block4"])
def test_sparse_self_attention_raises_on_what_the_kernels_do_not_take(
        card, block, D):
    """A CUDA tensor under impl "auto" goes to the kernels or raises: it
    never runs the plain path."""
    attn = tsparse.SparseSelfAttention(tsparse.FixedSparsityConfig(
        num_heads=2, block=block, num_local_blocks=2))
    q = _rnd(card, torch.bfloat16, 1, 8 * block, 2, D)
    counters = (tsflash.block_sparse_flash_attention,
                tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="block|head dim"):
        attn(q, q, q)
    assert [c.launches for c in counters] == before


def test_sparse_and_adam8_wrappers_raise_on_what_they_do_not_take(card):
    idx = torch.zeros(2, 2, 1, dtype=torch.int32, device="cuda")
    for block, D in ((256, 64), (16, 96), (16, 160)):
        q = _rnd(card, torch.bfloat16, 1, 2 * block, 2, D)
        i2 = torch.zeros(2, 2, 1, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="block|head dim"):
            tsflash.block_sparse_flash_attention(q, q, q, i2, block)
    q = _rnd(card, torch.float16, 1, 32, 2, 64)
    with pytest.raises(TypeError):
        tsflash.block_sparse_flash_attention(q, q, q, idx, 16)
    q = _rnd(card, torch.float32, 1, 32, 2, 64)
    with pytest.raises(ValueError, match="int32"):
        tsflash.block_sparse_flash_attention(q, q, q, idx.long(), 16)
    p = _rnd(card, torch.float32, 4, 8)
    codes = torch.zeros(4, 8, dtype=torch.int8, device="cuda")
    ones = torch.ones(4, 1, device="cuda")
    with pytest.raises(TypeError, match="uint8"):
        tadam8.fused_adam8_leaf(p, codes, ones, codes, ones, p, 1e-3, 1.0,
                                1.0, 1.0, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                                adam_w=True)
    with pytest.raises(ValueError, match="contiguous"):
        tadam8.fused_adam8_leaf(p.t().contiguous().t(), codes, ones,
                                codes.view(torch.uint8), ones, p, 1e-3, 1.0,
                                1.0, 1.0, b1=0.9, b2=0.999, eps=1e-8,
                                wd=0.0, adam_w=True)


def test_int8_fused_training_on_the_card(card):
    """llama tiny in bf16 with int8 moments: fused_update launches the
    kernel once per leaf per step, writes in place, and step 1 equals the
    engine without the flag (same parameters through the same kernels);
    steps 2-3 agree within a bf16 rounding of the parameters."""
    model = dt.Transformer(get_model_config(
        "llama", "tiny", dtype=torch.bfloat16, remat=True,
        tiled_loss_shards=4))

    def conf(fused):
        return {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "data_types": {"grad_accum_dtype": "bf16"},
                "optimizer": {"type": "adamw", "params": {
                    "lr": 1e-3, "weight_decay": 0.1, "state_dtype": "int8",
                    "fused_update": fused}},
                "activation_checkpointing": {"policy": "save_attn"}}
    fused = dt.initialize(model=model, config=conf(True))
    plain = dt.initialize(model=model, config=conf(False))
    assert fused.fused_update and not plain.fused_update
    n_leaves = sum(1 for _ in fused.params["layers"]) + sum(
        1 for k in fused.params if k != "layers")
    rng = np.random.RandomState(3)
    batch = {"input_ids": rng.randint(0, model.cfg.vocab_size, (2, 256)
                                      ).astype(np.int32)}
    ptr = fused.params["layers"]["wq"].data_ptr()
    for step in range(3):
        before = tadam8.fused_adam8_leaf.launches
        fm = fused.train_batch(batch)
        pm = plain.train_batch(batch)
        torch.cuda.synchronize()
        assert tadam8.fused_adam8_leaf.launches - before == n_leaves
        for key in ("loss", "grad_norm"):
            a, b = float(fm[key]), float(pm[key])
            assert np.isfinite(a)
            if step == 0:
                assert a == b, key
            else:
                assert a == pytest.approx(b, rel=2e-3), (step, key)
    assert fused.params["layers"]["wq"].data_ptr() == ptr


# (B, N, L, H, D, biases): AlphaFold's widths at small N, the tails of L
# (100, 77), every D class (8 runs padded to 16, 24 to 32, 48 to 64; the
# bf16 pair takes TMA + wgmma at D 32, 64 and 128, mma.sync elsewhere)
EVO_CASES = [(1, 4, 256, 8, 32, "both"), (1, 3, 100, 4, 8, "both"),
             (2, 2, 77, 2, 48, "b1"), (1, 2, 128, 2, 128, "b2"),
             (1, 3, 64, 2, 24, "none"), (1, 2, 96, 4, 64, "both"),
             (1, 3, 100, 4, 32, "both")]


def _evo_inputs(g, dtype, B, N, L, H, D, which, mask_row=False,
                b2_dtype=torch.bfloat16):
    """q, k, v in `dtype`; b1 f32 with about 15% of keys at -1e9 (and,
    with `mask_row`, row 0 at -1e30 everywhere); b2 in `b2_dtype`."""
    q, k, v = (_rnd(g, dtype, B, N, L, H, D) for _ in range(3))
    b1 = torch.where(torch.rand(B, N, 1, 1, L, generator=g, device="cuda")
                     < 0.15, -1e9, 0.0)
    if mask_row:
        b1[0, 0] = -1e30
    b2 = _rnd(g, b2_dtype, B, 1, H, L, L)
    return (q, k, v, b1 if which in ("b1", "both") else None,
            b2 if which in ("b2", "both") else None)


def _evo_want_variant(dtype, D, kernel="pair", L=128, N=64,
                      b2_dtype=torch.bfloat16):
    """The kernel each case must take: the f32 CUDA-core kernels; for
    bf16 the TMA + wgmma kernels at D 32, 64 and 128, elsewhere the dq and
    dk/dv pair's mma.sync kernels, db2's split mma.sync kernel and the
    forward's row-walking mma.sync kernel (while two of its CTAs fit an
    SM; the wgmma one while its pair-bias strip fits shared memory; the
    first forward kernel past that); db2 at D <= 32 with
    fewer than 32 rows n on its first kernel."""
    if dtype == torch.float32:
        return "f32"
    new = "wgmma" if D in (32, 64, 128) else "rows"
    smem = tevof.fwd_smem(new, D, L, b2_dtype)
    if kernel == "fwd" and (smem > tevof.SMEM_MAX or new == "rows" and
                            tevof.resident("fwd", new, D, smem) < 2):
        return "mma"
    if kernel == "db2" and D <= 32 and N < 32:
        return "mma"
    if D in (32, 64, 128):
        return "wgmma"
    return {"pair": "mma", "fwd": "rows", "db2": "split"}[kernel]


def _evo_check_backward(got, again, want):
    for gt, ag, w in zip(got, again, want):
        assert (gt is None) == (w is None)
        if w is None:
            continue
        assert gt.shape == w.shape and gt.dtype == w.dtype
        assert torch.equal(gt, ag)          # no atomics: the same bits
        # each gradient rounds once to its own dtype (db2 to b2's bf16)
        scale = max(float(w.float().abs().max()), 1.0)
        _close(gt, w, BWD_ATOL[gt.dtype] * scale, BWD_RTOL[gt.dtype])


@DTYPES
@pytest.mark.parametrize("B,N,L,H,D,which", EVO_CASES,
                         ids=[f"L{c[2]}-d{c[4]}-{c[5]}" for c in EVO_CASES])
def test_evoformer_kernels_match_plain_versions(card, dtype, B, N, L, H, D,
                                                which):
    q, k, v, b1, b2 = _evo_inputs(card, dtype, B, N, L, H, D, which,
                                  mask_row=which == "both")
    counters = (tevof.evoformer_flash_forward, tevof.evoformer_flash_dq,
                tevof.evoformer_flash_dkv, tevof.evoformer_flash_db2,
                tevof.evoformer_flash_db1)
    pair = (tevof.evoformer_flash_dq, tevof.evoformer_flash_dkv)
    before = [c.launches for c in counters]
    by_variant = [dict(c.launches_by_variant) for c in
                  pair + (counters[0], counters[3])]
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    ref, ref_lse = tevof.evoformer_flash_forward_reference(q, k, v, b1, b2)
    _close(out, ref, ATOL[dtype], RTOL[dtype])
    _close(lse, ref_lse, LSE_ATOL, 1e-6)
    if which == "both":   # row 0 fully masked: out 0, lse -1e30
        assert (out[0, 0] == 0).all() and torch.isfinite(lse).all()
        assert float(lse.view(B, N, H, L)[0, 0].max()) <= -1e29
    assert torch.equal(out, tevof.evoformer_flash_forward(q, k, v, b1, b2))
    do = _rnd(card, dtype, B, N, L, H, D)
    got = tevof.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
    again = tevof.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
    want = tevof.evoformer_flash_backward_reference(q, k, v, b1, b2, out,
                                                    do, lse)
    _evo_check_backward(got, again, want)
    if which == "both":   # the masked row's gradients are zero
        assert all((t[0, 0] == 0).all() for t in got[:3])
    _, delta = tevof.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
    _close(delta, tevof._delta(out, do), 1e-5 * max(
        float(delta.abs().max()), 1.0))
    # two forward and two backward calls and one more dq
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [2, 3, 2, 2 * int(b2 is not None), 2 * int(b1 is not None)]
    variant = _evo_want_variant(dtype, D)
    assert tevof.bwd_variant(dtype, D, L) == variant
    for c, b, n in zip(pair, by_variant, (3, 2)):
        assert {k: c.launches_by_variant[k] - b[k] for k in b} == {
            k: n if k == variant else 0 for k in b}
    # the forward and db2 on the kernels their rules name
    b2_dtype = None if b2 is None else b2.dtype
    for c, b, n, kernel, routed in (
            (counters[0], by_variant[2], 2, "fwd",
             tevof.fwd_variant(dtype, D, L, b2_dtype)),
            (counters[3], by_variant[3], 2 * int(b2 is not None), "db2",
             tevof.db2_variant(dtype, D, L, N))):
        want = _evo_want_variant(dtype, D, kernel, L, N, b2_dtype)
        assert routed == want
        assert {k: c.launches_by_variant[k] - b[k] for k in b} == {
            k: n if k == want else 0 for k in b}


@pytest.mark.parametrize("L,b2_dtype", [(77, torch.float32),
                                        (100, torch.float32),
                                        (100, torch.bfloat16),
                                        (128, torch.float32)],
                         ids=["L77-f32", "L100-f32", "L100-bf16",
                              "L128-f32"])
def test_evoformer_wgmma_pair_takes_any_pair_bias_row(card, L, b2_dtype):
    """The TMA + wgmma pair reads the pair bias by TMA, whose rows must
    start on 16-byte boundaries: a row of L elements that does not (L 77
    in f32, L 100 in bf16) is read from a zero-padded copy, counted on
    each wrapper; L 100 and 128 in f32 are read as they are."""
    q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, 1, 3, L, 4, 32,
                                  "both", mask_row=True, b2_dtype=b2_dtype)
    pair = (tevof.evoformer_flash_dq, tevof.evoformer_flash_dkv)
    copies = [c.pair_bias_copies for c in pair]
    wgmma = [c.launches_by_variant["wgmma"] for c in pair]
    more = (tevof.evoformer_flash_forward, tevof.evoformer_flash_db2)
    more_copies = [c.pair_bias_copies for c in more]
    more_wgmma = [c.launches_by_variant["wgmma"] for c in more]
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    do = _rnd(card, torch.bfloat16, *q.shape)
    got = tevof.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
    again = tevof.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
    want = tevof.evoformer_flash_backward_reference(q, k, v, b1, b2, out,
                                                    do, lse)
    _evo_check_backward(got, again, want)
    assert got[4].dtype == b2_dtype
    padded = tevof.pair_bias_pitch(L, b2_dtype) != L
    assert padded == (L * b2.element_size() % 16 != 0)
    assert [c.pair_bias_copies - n for c, n in zip(pair, copies)] == \
        [2 * int(padded)] * 2
    assert [c.launches_by_variant["wgmma"] - n
            for c, n in zip(pair, wgmma)] == [2, 2]
    # the forward and db2 (the wgmma split kernel, which N 3 takes only
    # when named) read it by TMA too, from the same padded copy
    lse_delta = tevof.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)[1]
    got2 = tevof.evoformer_flash_db2(q, k, v, b1, b2, do, lse, lse_delta,
                                     variant="wgmma")
    scale = max(float(want[4].float().abs().max()), 1.0)
    _close(got2, want[4], BWD_ATOL[torch.bfloat16] * scale,
           BWD_RTOL[torch.bfloat16])
    assert [c.pair_bias_copies - n for c, n in zip(more, more_copies)] == \
        [int(padded), int(padded)]
    assert [c.launches_by_variant["wgmma"] - n
            for c, n in zip(more, more_wgmma)] == [1, 1]


@pytest.mark.parametrize("B,N,L,H,D,which", [
    (1, 4, 256, 8, 32, "both"), (1, 3, 100, 4, 8, "both"),
    (1, 2, 96, 4, 64, "b2"), (1, 2, 128, 2, 128, "both")],
    ids=["L256-d32", "L100-d8", "L96-d64", "L128-d128"])
def test_evoformer_first_forward_and_db2_stay_reachable(card, B, N, L, H, D,
                                                        which):
    """`variant="mma"` runs the first forward and db2 kernels (one CTA a
    row n; one CTA walking every row) beside the new ones, within the
    kernels' limits of each other and of the plain versions; "split"
    takes D 32 too; a variant that cannot take the call raises."""
    q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, B, N, L, H, D, which,
                                  mask_row=True)
    fwd, db2 = tevof.evoformer_flash_forward, tevof.evoformer_flash_db2
    counts = [dict(c.launches_by_variant) for c in (fwd, db2)]
    out, lse = fwd(q, k, v, b1, b2, return_lse=True)
    old, old_lse = fwd(q, k, v, b1, b2, return_lse=True, variant="mma")
    ref, ref_lse = tevof.evoformer_flash_forward_reference(q, k, v, b1, b2)
    for o, ls in ((out, lse), (old, old_lse)):
        _close(o, ref, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
        _close(ls, ref_lse, LSE_ATOL, 1e-6)
    do = _rnd(card, torch.bfloat16, *q.shape)
    _, delta = tevof.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
    want = tevof.evoformer_flash_db2_reference(q, k, v, b1, b2, do, lse,
                                               delta)
    scale = max(float(want.float().abs().max()), 1.0)
    got = {vr: db2(q, k, v, b1, b2, do, lse, delta, variant=vr)
           for vr in ("mma", "split", None)}
    for g in got.values():
        _close(g, want, BWD_ATOL[torch.bfloat16] * scale,
               BWD_RTOL[torch.bfloat16])
    routed_fwd = tevof.fwd_variant(torch.bfloat16, D, L,
                                   None if b2 is None else b2.dtype)
    routed_db2 = tevof.db2_variant(torch.bfloat16, D, L, N)
    assert {k_: fwd.launches_by_variant[k_] - counts[0][k_]
            for k_ in counts[0]} == {k_: (k_ == routed_fwd) + (k_ == "mma")
                                     for k_ in counts[0]}
    assert {k_: db2.launches_by_variant[k_] - counts[1][k_]
            for k_ in counts[1]} == {
        k_: (k_ == routed_db2) + (k_ == "mma") + (k_ == "split")
        for k_ in counts[1]}
    if D not in (32, 64, 128):
        with pytest.raises(ValueError, match="variant 'wgmma'"):
            fwd(q, k, v, b1, b2, variant="wgmma")
        with pytest.raises(ValueError, match="variant 'wgmma'"):
            db2(q, k, v, b1, b2, do, lse, delta, variant="wgmma")
    with pytest.raises(ValueError, match="variant 'f32'"):
        fwd(q, k, v, b1, b2, variant="f32")


@pytest.mark.parametrize("D,b2_dtype", [
    (8, torch.bfloat16), (8, torch.float32), (32, torch.bfloat16),
    (64, torch.float32), (128, torch.bfloat16), (128, torch.float32)],
    ids=["d8-bf16", "d8-f32", "d32-bf16", "d64-f32", "d128-bf16",
         "d128-f32"])
def test_evoformer_forward_takes_long_rows_up_to_the_strip_limit(card, D,
                                                                 b2_dtype):
    """The row-walking forward launches, named, at the longest L whose
    pair-bias strip `fwd_smem` says fits shared memory (so the launcher's
    check agrees with the rule), and one key later the call takes the
    first kernel; both within the forward's limits of the plain
    version."""
    new = "wgmma" if D in (32, 64, 128) else "rows"
    top = max(L for L in range(64, 4097, 64)
              if tevof.fwd_smem(new, D, L, b2_dtype) <= tevof.SMEM_MAX)
    fwd = tevof.evoformer_flash_forward
    for L, want in ((top, new), (top + 1, "mma")):
        q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, 1, 2, L, 2, D,
                                      "both", mask_row=True,
                                      b2_dtype=b2_dtype)
        if want == "mma":
            assert tevof.fwd_variant(torch.bfloat16, D, L, b2_dtype) == want
        before = fwd.launches_by_variant[want]
        out, lse = fwd(q, k, v, b1, b2, return_lse=True, variant=want)
        assert fwd.launches_by_variant[want] == before + 1
        ref, ref_lse = tevof.evoformer_flash_forward_reference(q, k, v, b1,
                                                               b2)
        _close(out, ref, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
        _close(lse, ref_lse, LSE_ATOL, 1e-6)
        assert (out[0, 0] == 0).all()
        del q, k, v, b1, b2, out, lse, ref, ref_lse


@pytest.mark.parametrize("D", [8, 32], ids=["d8", "d32"])
def test_evoformer_db2_reruns_equal_under_every_split(card, D,
                                                      monkeypatch):
    """db2's splits add their f32 partials in split order in the launch
    (an integer ticket, no float atomics): every split count gives the
    same bits from run to run, and each is within the backward limit of
    the plain version and of the one-split sum."""
    B, N, L, H = 1, 40, 200, 2
    q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, B, N, L, H, D,
                                  "both")
    do = _rnd(card, torch.bfloat16, *q.shape)
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    _, delta = tevof.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
    want = tevof.evoformer_flash_db2_reference(q, k, v, b1, b2, do, lse,
                                               delta)
    scale = max(float(want.float().abs().max()), 1.0)
    planned = tevof.db2_plan(B, N, L, H, D, b2.dtype, 132)
    for splits in sorted({1, 2, 5, N // 4, planned}):
        monkeypatch.setattr(tevof, "db2_plan", lambda *a, s=splits: s)
        got = tevof.evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta)
        again = tevof.evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta)
        assert torch.equal(got, again), splits
        _close(got, want, BWD_ATOL[torch.bfloat16] * scale,
               BWD_RTOL[torch.bfloat16])


@pytest.mark.parametrize("D", [8, 32], ids=["d8", "d32"])
def test_evoformer_forward_and_db2_walk_past_the_grid_limit(card, D,
                                                            monkeypatch):
    """The row-walking forward at one row a CTA over B*N = 70000 rows
    (B * groups past the 65535 limit of the grid's z axis) and db2 over B*H
    = 80000 heads (past it too): both walk their slices grid-stride."""
    q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, 1, 70000, 16, 1, D,
                                  "both")
    monkeypatch.setattr(tevof, "fwd_plan", lambda *a: 1)
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    monkeypatch.undo()
    ref, ref_lse = tevof.evoformer_flash_forward_reference(q, k, v, b1, b2)
    _close(out, ref, ATOL[torch.bfloat16], RTOL[torch.bfloat16])
    _close(lse, ref_lse, LSE_ATOL, 1e-6)
    del q, k, v, b1, b2, out, lse, ref, ref_lse
    B, N, L, H = 2, 2, 16, 40000
    q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, B, N, L, H, D,
                                  "both")
    do = _rnd(card, torch.bfloat16, *q.shape)
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    _, delta = tevof.evoformer_flash_dq(q, k, v, b1, b2, out, do, lse)
    variant = "wgmma" if D == 32 else "split"   # the split kernels
    before = tevof.evoformer_flash_db2.launches_by_variant[variant]
    got = tevof.evoformer_flash_db2(q, k, v, b1, b2, do, lse, delta,
                                    variant=variant)
    assert tevof.evoformer_flash_db2.launches_by_variant[variant] == \
        before + 1
    want = tevof.evoformer_flash_db2_reference(q, k, v, b1, b2, do, lse,
                                               delta)
    scale = max(float(want.float().abs().max()), 1.0)
    _close(got, want, BWD_ATOL[torch.bfloat16] * scale,
           BWD_RTOL[torch.bfloat16])


def test_evoformer_attention_trains_through_the_kernels(card):
    """evoformer_attention forward and backward on the card (bf16 q/k/v
    and pair bias, f32 mask bias): one launch of each kernel per call, db1
    only for a mask bias that requires grad, gradients within the
    backward tolerance of the plain path's autograd."""
    q, k, v, b1, b2 = _evo_inputs(card, torch.bfloat16, 1, 8, 128, 4, 32,
                                  "both")
    counters = (tevof.evoformer_flash_forward, tevof.evoformer_flash_dq,
                tevof.evoformer_flash_dkv, tevof.evoformer_flash_db2,
                tevof.evoformer_flash_db1)
    grads = []
    for impl in ("auto", "jnp"):
        for b1_grad in (False, True):
            t = [x.clone().requires_grad_() for x in (q, k, v, b2)]
            bb1 = b1.clone().requires_grad_(b1_grad)
            before = [c.launches for c in counters]
            out = tevo.evoformer_attention(t[0], t[1], t[2], (bb1, t[3]),
                                           impl=impl)
            (out.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            launched = [c.launches - b for c, b in zip(counters, before)]
            assert launched == ([1, 1, 1, 1, int(b1_grad)] if impl == "auto"
                                else [0] * 5)
            assert (bb1.grad is None) != b1_grad
            if b1_grad:
                grads.append([x.grad for x in t] + [bb1.grad])
    for g, w in zip(*grads):
        scale = max(float(w.float().abs().max()), 1.0)
        _close(g, w, BWD_ATOL[torch.bfloat16] * scale * 2,
               BWD_RTOL[torch.bfloat16] * 2)


def test_evoformer_wrappers_raise_on_what_the_kernels_do_not_take(card):
    for D in (12, 136):
        q = _rnd(card, torch.bfloat16, 1, 2, 16, 2, D)
        with pytest.raises(ValueError, match="head dim"):
            tevof.evoformer_flash_forward(q, q, q)
        with pytest.raises(ValueError, match="head dim"):
            tevo.evoformer_attention(q, q, q)
    q = _rnd(card, torch.float16, 1, 2, 16, 2, 32)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tevof.evoformer_flash_forward(q, q, q)
    q = _rnd(card, torch.bfloat16, 1, 2, 16, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tevof.evoformer_flash_forward(q.transpose(1, 2).contiguous()
                                      .transpose(1, 2), q, q)
    b1 = torch.zeros(1, 2, 1, 1, 16, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="mask bias"):
        tevof.evoformer_flash_forward(q, q, q, b1)


# ----------------------------------------------------------------------
# tensor-parallel serving: the tile GEMM, and the ring on several cards
# ----------------------------------------------------------------------
@DTYPES
@pytest.mark.parametrize("M,K,N", [
    (4, 4096, 2048), (2, 4096, 2752), (1, 2752, 1001), (16, 512, 256),
    (37, 100, 60), (256, 1024, 1000), (3, 7, 5), (5, 0, 9)],
    ids=["decode-q-tp2", "decode-up-tp4", "edges", "bm16", "odd",
         "prefill", "tiny", "k0"])
def test_tile_matmul_kernel_matches_plain_version(card, dtype, M, K, N):
    x = _rnd(card, dtype, M, K)
    w = _rnd(card, dtype, K, N)
    before = ttm.tile_matmul.launches
    got = ttm.tile_matmul(x, w)
    again = ttm.tile_matmul(x, w)
    torch.cuda.synchronize()
    assert ttm.tile_matmul.launches - before == 2
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, again)              # fixed order: the same bits
    ref = ttm.tile_matmul_reference(x, w)
    scale = TILE_REL * max(float(ref.abs().max()), 1.0)
    _close(got, ref, scale)
    # a view one element past an aligned start takes the element loads
    if K:
        xs = _rnd(card, dtype, M * K + 1)[1:].view(M, K)
        assert xs.data_ptr() % 16
        _close(ttm.tile_matmul(xs, w), ttm.tile_matmul_reference(xs, w),
               TILE_REL * max(float(ttm.tile_matmul_reference(
                   xs, w).abs().max()), 1.0))


# ----------------------------------------------------------------------
# Hopper building blocks (csrc/hopper_tile.cuh) one at a time, and the
# TMA / wgmma kernels built on them at the main paths' shapes
# ----------------------------------------------------------------------
def _selftest(symbol, argtypes):
    from deepspeed_tpu_torch.ops import _build
    _build.build_all(("hopper_selftest",))
    return _build.function("hopper_selftest", symbol, argtypes)


def _swizzled(off, swizzle):
    """The shared-memory byte offset TMA writes logical offset `off` to
    (Swizzle<B, 4, 3>: 16-byte chunk bits 4.. XOR row bits 7..)."""
    mask = {0: 0, 1: 1, 2: 3, 3: 7}[swizzle]
    return off ^ (((off >> 7) & mask) << 4)


def _tma_box_image(g, symbol, rank, dims, box, coords, swizzle, itype):
    """One TMA box of a random tensor of `itype` elements (int16 for bf16,
    int32 for f32: the copy moves bits) through selftest `symbol`, against
    the image the swizzle and the zero fill predict."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _selftest(symbol, (P, P, I, P, P, P, I, P))
    es = torch.empty((), dtype=itype).element_size()
    numel = int(np.prod(dims))
    src = torch.randint(-2 ** 15, 2 ** 15, (numel,), generator=g,
                        device="cuda", dtype=torch.int32).to(itype)
    nbox = int(np.prod(box))
    dst = torch.full((nbox,), 7, dtype=itype, device="cuda")
    dims_c = (ctypes.c_longlong * rank)(*dims)
    box_c = (ctypes.c_int * rank)(*box)
    coords_c = (ctypes.c_int * rank)(*coords)
    rc = fn(src.data_ptr(), dst.data_ptr(), rank, dims_c, box_c, coords_c,
            swizzle, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    # expected image: box element (innermost first) -> its source element
    full = src.view(*dims[::-1]).cpu().numpy()
    want = np.zeros(nbox, full.dtype)
    for flat in range(nbox):
        idx, rem = [], flat
        for b in box:
            idx.append(rem % b)
            rem //= b
        pos = [c + i for c, i in zip(coords, idx)]
        inside = all(0 <= p < d for p, d in zip(pos, dims))
        val = full[tuple(pos[::-1])] if inside else 0
        want[_swizzled(es * flat, swizzle) // es] = val
    assert np.array_equal(dst.cpu().numpy(), want)


@pytest.mark.parametrize("rank,dims,box,coords,swizzle", [
    (2, (64, 40), (64, 16), (0, 8), 3),
    (2, (64, 40), (32, 16), (32, 30), 2),      # rows past the edge: zero
    (2, (48, 20), (16, 8), (16, 0), 1),
    (2, (48, 20), (24, 8), (8, 4), 0),
    (4, (128, 3, 100, 2), (64, 1, 128, 1), (64, 1, 0, 1), 3),
    (4, (32, 2, 50, 3), (32, 1, 128, 1), (0, 1, 0, 2), 2),
    # the Evoformer pair bias [B, H, L, L] (keys innermost), bf16 boxes of
    # 64 keys: the transposed tile of dk/dv and the rows of dq, past L
    (4, (104, 100, 2, 1), (64, 64, 1, 1), (64, 64, 1, 0), 3)],
    ids=["2d-sw128", "2d-sw64-edge", "2d-sw32", "2d-none", "4d-sw128-S100",
         "4d-sw64-S50", "4d-sw128-bias-L100"])
def test_hopper_tma_box_lands_swizzled_and_zero_filled(card, rank, dims,
                                                      box, coords, swizzle):
    _tma_box_image(card, "dstt_selftest_tma", rank, dims, box, coords,
                   swizzle, torch.int16)


@pytest.mark.parametrize("rank,dims,box,coords,swizzle", [
    (2, (64, 40), (32, 16), (32, 30), 3),
    (4, (80, 77, 3, 2), (32, 64, 1, 1), (64, 64, 2, 1), 3),   # pitch 80
    (4, (100, 100, 2, 1), (32, 128, 1, 1), (96, 0, 1, 0), 3)],
    ids=["2d-sw128-edge", "4d-sw128-bias-L77", "4d-sw128-bias-L100"])
def test_hopper_tma_f32_box_lands_swizzled_and_zero_filled(
        card, rank, dims, box, coords, swizzle):
    """f32 tensor maps, as the Evoformer wgmma pair reads an f32 pair bias:
    boxes of 32 keys (128 bytes, the 128-byte swizzle), rows and keys past
    L zero."""
    _tma_box_image(card, "dstt_selftest_tma_f32", rank, dims, box, coords,
                   swizzle, torch.int32)


# (N, B MN-major, swizzle): an MN-major B is stored in column blocks of
# the swizzle's width (16, 32 or 64 bf16), so N 32 has no 128-byte case
WGMMA_CASES = [(n, mn, sw) for n in (32, 64, 128) for mn in (0, 1)
               for sw in (1, 2, 3) if not (mn and n < 8 << sw)]


@pytest.mark.parametrize("N,b_mn,swizzle", WGMMA_CASES, ids=[
    f"n{n}-{'mn' if mn else 'k'}major-sw{16 << sw}"
    for n, mn, sw in WGMMA_CASES])
@pytest.mark.parametrize("a_regs", [0, 1], ids=["a-smem", "a-regs"])
def test_hopper_wgmma_tile_matches_a_matmul(card, swizzle, b_mn, a_regs, N):
    import ctypes
    fn = _selftest("dstt_selftest_wgmma", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    a = _rnd(card, torch.bfloat16, 64, 64)
    b = _rnd(card, torch.bfloat16, *((64, N) if b_mn else (N, 64)))
    out = torch.full((64, N), float("nan"), device="cuda")
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), N, b_mn, a_regs,
            swizzle, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    ref = a.float() @ (b.float() if b_mn else b.float().t())
    _close(out, ref, 1e-4)


N16_CASES = [(mn, sw) for mn in (0, 1) for sw in (1, 2, 3)
             if not (mn and 16 < 8 << sw)]


@pytest.mark.parametrize("b_mn,swizzle", N16_CASES, ids=[
    f"{'mn' if mn else 'k'}major-sw{16 << sw}" for mn, sw in N16_CASES])
def test_hopper_wgmma_n16_matches_a_matmul(card, b_mn, swizzle):
    """wgmma m64n16k16 with A K-major from shared memory (the block-sparse
    pair's S^T and dP^T at block 16); the register-A form, which no kernel
    issues at N 16, is refused."""
    import ctypes
    fn = _selftest("dstt_selftest_wgmma", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    a = _rnd(card, torch.bfloat16, 64, 64)
    b = _rnd(card, torch.bfloat16, *((64, 16) if b_mn else (16, 64)))
    out = torch.full((64, 16), float("nan"), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 16, b_mn, 1,
              swizzle, stream) != 0
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 16, b_mn, 0,
            swizzle, stream)
    assert rc == 0
    _close(out, a.float() @ (b.float() if b_mn else b.float().t()), 1e-4)


# A MN-major (a [K, M] read as the transposed operand), from shared memory
A_MN_CASES = [(n, mn, sw) for n in (16, 32, 64) for mn in (0, 1)
              for sw in (1, 2, 3) if not (mn and n < 8 << sw)]


@pytest.mark.parametrize("N,b_mn,swizzle", A_MN_CASES, ids=[
    f"n{n}-{'mn' if mn else 'k'}major-sw{16 << sw}"
    for n, mn, sw in A_MN_CASES])
def test_hopper_wgmma_transposed_a_matches_a_matmul(card, N, b_mn, swizzle):
    """wgmma with A MN-major (the transpose bit of A, as the block-sparse
    pair reads its gathered tile for dQ^T, dK^T and dV^T), every N the
    pair takes and N 16's K-major and MN-major B."""
    import ctypes
    fn = _selftest("dstt_selftest_wgmma", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    a = _rnd(card, torch.bfloat16, 64, 64)
    b = _rnd(card, torch.bfloat16, *((64, N) if b_mn else (N, 64)))
    out = torch.full((64, N), float("nan"), device="cuda")
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), N, b_mn, 2,
            swizzle, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    ref = a.float().t() @ (b.float() if b_mn else b.float().t())
    _close(out, ref, 1e-4)


def _tile_hop_shapes(H=4096, F=11008, V=32000, C=256, max_seqs=8):
    """(M, K, N) of every per-hop GEMM of chip_smoke phase 13 at
    Llama-2-7B widths: decode and NC = 1, 2, 4, 8 prefill, tp 2 and 4."""
    shapes = set()
    for tp in (2, 4):
        for m in [max_seqs // tp] + [C * nc // tp for nc in (1, 2, 4, 8)]:
            shapes |= {(m, H, H // tp), (m, H // tp, H), (m, H, F // tp),
                       (m, F // tp, H)}
        shapes.add((max_seqs // tp, H, V // tp))
    return sorted(shapes)


@pytest.mark.parametrize("M,K,N", _tile_hop_shapes())
def test_tile_matmul_hops_take_the_tma_kernels(card, M, K, N):
    x = _rnd(card, torch.bfloat16, M, K)
    w = _rnd(card, torch.bfloat16, K, N)
    want = "stream" if M <= ttm.STREAM_MAX_M else "wgmma"
    assert ttm.tile_plan(M, K, N, torch.bfloat16).variant == want
    before = dict(ttm.tile_matmul.launches_by_variant)
    got = ttm.tile_matmul(x, w)
    again = ttm.tile_matmul(x, w)
    torch.cuda.synchronize()
    after = ttm.tile_matmul.launches_by_variant
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 if k == want else 0 for k in after}
    assert torch.equal(got, again)
    ref = ttm.tile_matmul_reference(x, w)
    _close(got, ref, TILE_REL * max(float(ref.abs().max()), 1.0))


@pytest.mark.parametrize("B,S,NH,NKV,D", [
    (4, 2048, 16, 16, 128), (1, 1, 8, 2, 128), (2, 50, 8, 2, 64),
    (2, 200, 8, 2, 32), (1, 300, 32, 8, 128), (2, 130, 4, 4, 64),
    (1, 256, 8, 2, 128)],
    ids=["training", "S1", "S50-D64", "S200-D32", "S300-gqa", "S130",
         "S256-gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_forward_wgmma_matches_plain_version(card, B, S, NH, NKV, D,
                                                   causal):
    dtype = torch.bfloat16
    q, k, v = (_rnd(card, dtype, B, S, n, D) for n in (NH, NKV, NKV))
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal)
    assert tflash.flash_attention_fwd.launches == before + 1
    ref, ref_lse = tflash.flash_attention_reference(q, k, v, causal=causal)
    _close(out, ref, ATOL[dtype], RTOL[dtype])
    _close(lse, ref_lse, LSE_ATOL)


def test_tile_matmul_raises_on_what_the_kernel_does_not_take(card):
    x = _rnd(card, torch.bfloat16, 4, 64)
    with pytest.raises(TypeError, match="one dtype"):
        ttm.tile_matmul(x, _rnd(card, torch.float32, 64, 8))
    with pytest.raises(ValueError, match="contiguous"):
        ttm.tile_matmul(x, _rnd(card, torch.bfloat16, 8, 64).t())
    with pytest.raises(ValueError, match="w \\[K, N\\]"):
        ttm.tile_matmul(x, _rnd(card, torch.bfloat16, 32, 8))


def test_evoformer_takes_a_misaligned_bias_view(card):
    """A bf16 mask bias sliced at an odd row starts 200 bytes into its
    storage, off the kernels' 16-byte boundary: the autograd Function
    copies it (forward and backward), as the reference takes any view."""
    B, N, L, H, D = 1, 8, 100, 2, 32
    q, k, v = (_rnd(card, torch.bfloat16, B, N, L, H, D) for _ in range(3))
    full = _rnd(card, torch.bfloat16, B, N + 1, 1, 1, L)
    b1 = full[:, 1:]
    assert b1.is_contiguous() and b1.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tevof.evoformer_flash_forward(q, k, v, b1)
    grads = []
    for impl in ("auto", "jnp"):
        t = [x.clone().requires_grad_() for x in (q, k, v)]
        bb = full.clone().requires_grad_()
        out = tevo.evoformer_attention(t[0], t[1], t[2], (bb[:, 1:],),
                                       impl=impl)
        (out.float() ** 2).sum().backward()
        grads.append([out] + [x.grad for x in t] + [bb.grad])
    _close(grads[0][0], grads[1][0], ATOL[torch.bfloat16],
           RTOL[torch.bfloat16])
    for g, w in zip(grads[0][1:], grads[1][1:]):
        scale = max(float(w.float().abs().max()), 1.0)
        _close(g, w, BWD_ATOL[torch.bfloat16] * scale * 2,
               BWD_RTOL[torch.bfloat16] * 2)
    assert (grads[0][-1][:, 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 32], ids=["d8", "d32"])
def test_evoformer_kernels_walk_more_slices_than_the_grid(card, dtype, D):
    """B*N = 70000 rows: past the 65535 grid limit, every slice is served
    by the grid-stride loops, forward and backward (bf16 D 32 on the TMA
    + wgmma pair, whose CTAs walk several slices through one ring)."""
    q, k, v, b1, b2 = _evo_inputs(card, dtype, 1, 70000, 16, 1, D, "both")
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    ref, ref_lse = tevof.evoformer_flash_forward_reference(q, k, v, b1, b2)
    _close(out, ref, ATOL[dtype], RTOL[dtype])
    _close(lse, ref_lse, LSE_ATOL, 1e-6)
    do = _rnd(card, dtype, *q.shape)
    got = tevof.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
    want = tevof.evoformer_flash_backward_reference(q, k, v, b1, b2, out,
                                                    do, lse)
    for gt, w in zip(got, want):
        if w is None:
            continue
        scale = max(float(w.float().abs().max()), 1.0)
        _close(gt, w, BWD_ATOL[gt.dtype] * scale, BWD_RTOL[gt.dtype])


@pytest.fixture
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (the tp ring)")
    return card


@pytest.mark.multi_cuda
def test_ring_on_nccl_matches_the_replicated_product(two_cards, tmp_path):
    import _torch_tp_ranks as ranks
    from deepspeed_tpu_torch.comm import spawn_ranks
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32).astype(np.float32)
    w1 = rng.randn(32, 64).astype(np.float32)
    w2 = rng.randn(64, 32).astype(np.float32)
    ref = np.tanh(x @ w1) @ w2
    res = spawn_ranks(ranks.ring_block, 2, str(tmp_path / "store"),
                      args=(x, w1, w2, "cuda"), timeout_s=300)
    for got in (np.concatenate([r[0] for r in res]),
                np.concatenate([r[1] for r in res])):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    for _, _, log_ag, log_rs in res:
        assert log_ag.count("hop") == log_rs.count("hop") == 1


@pytest.mark.multi_cuda
def test_tp2_greedy_chain_on_two_cards(two_cards, tmp_path):
    """A tiny f32 Llama at tp 2 on two cards (NCCL, the tile kernel, the
    paged kernels on local heads) against the same engine at tp 1."""
    import _torch_tp_ranks as ranks
    from deepspeed_tpu_torch.comm import spawn_ranks
    cfg_kw = dict(vocab_size=512, hidden_size=256, num_layers=2,
                  num_heads=8, num_kv_heads=4, max_seq_len=256,
                  pos_emb="rope", norm="rmsnorm", activation="swiglu",
                  dtype=torch.float32)
    engine_kw = dict(num_blocks=64, block_size=16, max_blocks_per_seq=16,
                     max_seqs=4, prefill_chunk_size=32,
                     max_prefill_tokens_per_step=64,
                     full_prompt_prefill=False)
    cfg = dt.models.TransformerConfig(**cfg_kw)
    params = {k: ({kk: vv.cpu().numpy() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.cpu().numpy())
              for k, v in dt.models.init_params(
                  cfg, torch.Generator().manual_seed(0), "cpu").items()}
    rng = np.random.RandomState(11)
    # both prompts fit one step's 64-token budget (the drive reads both
    # first logits from one put)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (40, 9)]
    want = ranks._drive(ranks.engine(params, cfg_kw, engine_kw,
                                     device="cuda"), prompts)
    before = ttm.tile_matmul.launches
    res = spawn_ranks(ranks.serve_tp, 2, str(tmp_path / "store"),
                      args=(params, cfg_kw, engine_kw, prompts, "cuda"),
                      timeout_s=300)
    assert ttm.tile_matmul.launches == before      # only the ranks ran it
    for out in res:
        assert out["tile_launches"] > 0
        for key in ("prefill", "cont"):
            for u in want[key]:
                np.testing.assert_allclose(out[key][u], want[key][u],
                                           rtol=2e-4, atol=2e-4)
        for u in (0, 1):
            np.testing.assert_array_equal(out["burst"][u], want["burst"][u])
        assert out["chains"] == want["chains"]
