"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card with `nvcc` (the kernels build from
`deepspeed_tpu_torch/csrc` on first use) and skips without one.  The file
imports neither `jax` nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Each kernel is checked in both dtypes it takes: f32, where kernel and
plain version differ only by the order of f32 sums, and bf16, where the
output's final rounding adds one bf16 ulp, at every head dim the kernels
take (32, 64, 128).  The engine tests serve the same wave, and take the
same training steps, through the kernels and through the plain versions
(`plain_kernels=True`) in f32.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.ops import fused_adam8 as tadam8
from deepspeed_tpu_torch.ops import lora_matmul as tlora
from deepspeed_tpu_torch.ops import sparse_attention as tsparse
from deepspeed_tpu_torch.ops import sparse_flash as tsflash
from deepspeed_tpu_torch.ops import paged_attention as tdecode
from deepspeed_tpu_torch.ops import paged_merged as tmerged
from deepspeed_tpu_torch.ops import paged_prefill as tprefill
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


@DTYPES
@pytest.mark.parametrize("S,NH,NKV,D", [(200, 8, 2, 128), (130, 4, 4, 64),
                                        (100, 8, 2, 32), (64, 4, 4, 32),
                                        (1, 2, 1, 128)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_kernels_match_plain_versions(card, dtype, S, NH, NKV,
                                                     D, causal):
    q, do = (_rnd(card, dtype, 2, S, NH, D) for _ in range(2))
    k, v = (_rnd(card, dtype, 2, S, NKV, D) for _ in range(2))
    out, lse = tflash.flash_attention_fwd(q, k, v, causal)
    got = (tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, causal),
           *tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, causal))
    want = (tflash.flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                                    causal),
            *tflash.flash_attention_bwd_dkv_reference(q, k, v, out, lse, do,
                                                      causal))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        # the scale has a floor of 1 (the inputs' own): at S = 1 dq and dk
        # are 0 up to rounding
        scale = max(float(w.float().abs().max()), 1.0)
        _close(g, w, BWD_ATOL[dtype] * scale, BWD_RTOL[dtype])


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
        km = kern.train_batch(batch)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == \
            [model.cfg.num_layers] * 3
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


SPARSE_CASES = [(8, 64), (16, 128), (24, 64), (64, 64), (128, 128)]


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
    idx, rev = tsparse._device_tables(kidx, "cuda")
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
    for block, D in ((256, 64), (16, 96), (16, 192)):
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
