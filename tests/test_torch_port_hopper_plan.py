"""The tile GEMM's host plan (`ops/tp_matmul.tile_plan`) and the flash
backward's kernel choice (`ops/flash_attention.bwd_variant`) on the CPU.

The plan picks the kernel for a shape (the split-K TMA stream at the
decode hops, TMA + wgmma at the prefill hops, the cp.async or CUDA-core
kernel where TMA cannot go) and how K is split.  Its cases are every
per-hop GEMM of chip_smoke phase 13's wave at Llama-2-7B widths (tp 2 and
4, decode and NC = 1, 2, 4, 8 prefill chunks), computed here, and the edge
shapes phase 1 checks.  The kernels' order of sums across splits (an f32
partial per K range, added in split order) is emulated in numpy and held
against the JAX package's Pallas tile kernel in interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.ops import tp_matmul as ttm

pytestmark = pytest.mark.kernels

# |emulation - Pallas| <= TILE_REL max|Pallas|: the same exact products of
# bf16 values summed in f32 in another order (chip_smoke's limit)
TILE_REL = 2e-5
H, F, V, CHUNK, MAX_SEQS = 4096, 11008, 32000, 256, 8


def _hops():
    """{(M, K, N): label} of phase 13's per-hop GEMMs at Llama-2-7B."""
    shapes = {}
    for tp in (2, 4):
        rows = [("decode", MAX_SEQS // tp)] + [
            (f"prefill NC={nc}", CHUNK * nc // tp) for nc in (1, 2, 4, 8)]
        for stage, m in rows:
            hops = [("q/k/v", H, H // tp), ("o", H // tp, H),
                    ("gate/up", H, F // tp), ("down", F // tp, H)]
            if stage == "decode":
                hops.append(("head", H, V // tp))
            for proj, k, n in hops:
                shapes.setdefault((m, k, n), f"tp{tp} {stage} {proj}")
    return shapes


HOPS = _hops()
DECODE = [s for s, lb in HOPS.items() if "decode" in lb]
# (M, K, N, dtype, aligned): phase 1's edges, and the hops in f32
EDGES = ([(1, 2752, 1001, torch.bfloat16, True),
          (37, 100, 60, torch.bfloat16, True),
          (3, 7, 5, torch.bfloat16, True),
          (5, 0, 9, torch.bfloat16, True),
          (5, 0, 8, torch.bfloat16, True),
          (17, 4096, 2048, torch.bfloat16, False),
          (4, 4096, 2048, torch.bfloat16, False),
          (64 * 65535 + 37, 8, 8, torch.bfloat16, True),
          (128 * 65536, 8, 8, torch.bfloat16, True),
          (32 * 65535 + 5, 8, 8, torch.float32, True)]
         + [(m, k, n, torch.float32, True) for m, k, n in DECODE])
EDGE_IDS = [f"{m}x{k}x{n}-{str(dt)[6:]}{'' if al else '-unaligned'}"
            for m, k, n, dt, al in EDGES]


def test_the_hops_are_the_waves():
    assert len(HOPS) == 42 and len(DECODE) == 10
    assert (2, 4096, 2752) in DECODE and (4, 4096, 2048) in DECODE
    assert (128, 4096, 2752) in HOPS and (1024, 4096, 5504) in HOPS


@pytest.mark.parametrize("M,K,N", list(HOPS), ids=list(HOPS.values()))
def test_hop_takes_a_tma_kernel_and_its_ranges_partition_k(M, K, N):
    plan = ttm.tile_plan(M, K, N, torch.bfloat16)
    assert plan.reason == ""
    assert plan.variant == ("stream" if M <= ttm.STREAM_MAX_M else "wgmma")
    ranges = plan.k_ranges
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                      # in order, no gap, no overlap
    for k0, k1 in ranges:                    # whole ring slots, none empty
        assert k0 < k1 and k0 % ttm.SPLIT_KT == 0
    if plan.variant == "stream":
        assert max(k1 - k0 for k0, k1 in ranges) <= ttm.STREAM_MAX_KR
        assert plan.tiles == -(-N // ttm.STREAM_BN)
    else:
        assert plan.tiles == -(-M // ttm.WGMMA_BM) * -(-N // ttm.WGMMA_BN)
        # K split only where the tiles leave 3/4 of the SMs idle, into
        # ranges of at least WGMMA_MIN_KR rows
        assert plan.splits == 1 or (
            plan.tiles <= ttm.H100_SMS // 4 and
            min(k1 - k0 for k0, k1 in ranges) >= ttm.WGMMA_MIN_KR)


@pytest.mark.parametrize("M,K,N", DECODE, ids=[HOPS[s] for s in DECODE])
@pytest.mark.parametrize("sms", [132, 114])
def test_decode_hops_reach_twice_the_sms(M, K, N, sms):
    plan = ttm.tile_plan(M, K, N, torch.bfloat16, sm_count=sms)
    assert plan.variant == "stream"
    assert plan.ctas >= 2 * sms
    assert plan.splits <= -(-K // ttm.SPLIT_KT)


@pytest.mark.parametrize("M,K,N,dtype,aligned", EDGES, ids=EDGE_IDS)
def test_only_the_edge_rule_takes_the_old_kernels(M, K, N, dtype, aligned):
    plan = ttm.tile_plan(M, K, N, dtype, aligned)
    reason = ttm.tile_edge_reason(M, K, N, dtype, aligned)
    assert plan.reason == reason
    if dtype == torch.float32:
        assert plan.variant == "f32"
    elif not aligned or K % 8 or N % 8 or K == 0 or \
            (M > ttm.STREAM_MAX_M and -(-M // ttm.WGMMA_BM) > 65535):
        assert plan.variant == "cp_async" and reason
    else:
        assert plan.variant in ("stream", "wgmma") and not reason
    if plan.variant in ("cp_async", "f32"):
        assert plan.splits == 1 and plan.k_ranges == [(0, K)]


def _split_order(x, w, plan):
    """The kernels' sum across splits: an f32 partial per K range, added
    to the running sum in split order."""
    out = None
    for k0, k1 in plan.k_ranges:
        part = x[:, k0:k1] @ w[k0:k1]
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("M,K,N", [(16, 1024, 256), (8, 2048, 512),
                                   (128, 2048, 256)])
def test_split_order_matches_the_pallas_kernel(monkeypatch, M, K, N):
    import jax.experimental.pallas as pl
    import deepspeed_tpu.ops.tp_matmul as jtm
    monkeypatch.setattr(jtm.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    assert jtm.tile_matmul_supported(M, K, N)
    plan = ttm.tile_plan(M, K, N, torch.bfloat16)
    assert plan.splits > 1
    rng = np.random.RandomState(M + K + N)
    # bf16 values, so every product is exact in f32 on both sides
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32))
            .bfloat16().float().numpy() for s in ((M, K), (K, N)))
    want = np.asarray(jtm._pallas_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = _split_order(x, w, plan)
    assert got.dtype == np.float32
    scale = TILE_REL * max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= scale
    # and the CPU wrapper (the plain version) agrees the same way
    plain = ttm.tile_matmul(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w).bfloat16()).numpy()
    assert float(np.abs(plain - want).max()) <= scale


def test_variant_counts_start_at_zero_and_name_every_kernel():
    assert set(ttm.tile_matmul.launches_by_variant) == set(
        ttm.TILE_VARIANTS)
    # the CPU path runs the plain version: no kernel launch is counted
    before = dict(ttm.tile_matmul.launches_by_variant)
    ttm.tile_matmul(torch.ones(2, 8), torch.ones(8, 8))
    assert ttm.tile_matmul.launches_by_variant == before


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "f32")],
                         ids=["bf16", "f32"])
def test_flash_backward_variant_follows_the_dtype(dtype, want):
    """bf16 takes the TMA + wgmma pair (which reads delta), f32 the CUDA-
    core pair; every variant has a counter on both wrappers."""
    assert tflash.bwd_variant(dtype) == want
    assert want in tflash.BWD_VARIANTS
    for fn in (tflash.flash_attention_bwd_dq, tflash.flash_attention_bwd_dkv):
        assert set(fn.launches_by_variant) == set(tflash.BWD_VARIANTS)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_flash_backward_variant_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bf16 or f32"):
        tflash.bwd_variant(dtype)


def test_flash_backward_on_the_cpu_counts_no_kernel_launch():
    """The CPU path runs the plain versions (delta included): no counter
    moves."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 9, 2, 32, generator=g) for _ in range(4))
    counters = (tflash.flash_attention_bwd_delta,
                tflash.flash_attention_bwd_dq, tflash.flash_attention_bwd_dkv)
    before = ([c.launches for c in counters],
              [dict(c.launches_by_variant) for c in counters[1:]])
    out, lse = tflash.flash_attention_fwd(q, k, v)
    delta = tflash.flash_attention_bwd_delta(out, do)
    tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, delta=delta)
    tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, delta=delta)
    assert ([c.launches for c in counters],
            [dict(c.launches_by_variant) for c in counters[1:]]) == before
