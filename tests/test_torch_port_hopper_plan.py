"""The tile GEMM's host plan (`ops/tp_matmul.tile_plan`), the flash
backward's kernel choice (`ops/flash_attention.bwd_variant`), the
Evoformer backward's (`ops/evoformer_flash.bwd_variant`, with the pair-bias
row pitch its TMA pair reads, `pair_bias_pitch`) and the block-sparse
backward's and forward's (`ops/sparse_flash.bwd_variant`, `fwd_variant`,
with the gathered tile walks of its wgmma kernels, `tile_walk`,
`fwd_walk`, `bwd_plan`), the fused LoRA delta's work list
(`ops/lora_matmul.work_items`) and the paged kernels' (
`ops/paged_prefill.prefill_variant` with `prefill_plan`, the split of each
query tile's key range over CTAs, and `ops/paged_attention.decode_variant`
with `decode_plan`, the split of a sequence's key tiles) on the CPU.

The plan picks the kernel for a shape (the split-K TMA stream at the
decode hops, TMA + wgmma at the prefill hops, the cp.async or CUDA-core
kernel where TMA cannot go) and how K is split.  Its cases are every
per-hop GEMM of chip_smoke phase 13's wave at Llama-2-7B widths (tp 2 and
4, decode and NC = 1, 2, 4, 8 prefill chunks), computed here, and the edge
shapes phase 1 checks.  The kernels' order of sums across splits (an f32
partial per K range, added in split order) is emulated in numpy and held
against the JAX package's Pallas tile kernel in interpret mode; so are
the paged TMA kernels' orders (an online softmax over 64-key tiles with a
base-2 exponent inside a split, the splits' (m, l, acc) merged in split
order), against the Pallas paged prefill and decode kernels; and so are
the fused LoRA kernel's (k-group sums in order, K spans' partials in span
order) against the JAX `lora_delta` and the block-sparse wgmma forward's
(the gathered, owner-masked online softmax with P rounded to bf16)
against the Pallas block-sparse forward.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import evoformer_flash as tevof
from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.ops import lora_matmul as tlora
from deepspeed_tpu_torch.ops import paged_attention as tdecode
from deepspeed_tpu_torch.ops import paged_merged as tmerged
from deepspeed_tpu_torch.ops import paged_prefill as tprefill
from deepspeed_tpu_torch.ops import sparse_attention as tsparse
from deepspeed_tpu_torch.ops import sparse_flash as tsflash
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


# (dtype, D, L, the pair): phase 12's MSA row and triangle (D 32, L 256)
# and extra-MSA row (D 8) shapes, phase 1's L 100 tail (its bf16 pair-bias
# rows are 200 bytes, off TMA's 16-byte stride rule) and every other head
# dim class the kernels take
EVO_VARIANTS = [(torch.bfloat16, 32, 256, "wgmma"),
                (torch.bfloat16, 32, 100, "wgmma"),
                (torch.bfloat16, 64, 77, "wgmma"),
                (torch.bfloat16, 128, 128, "wgmma"),
                (torch.bfloat16, 8, 256, "mma"),
                (torch.bfloat16, 16, 64, "mma"),
                (torch.bfloat16, 24, 100, "mma"),
                (torch.bfloat16, 48, 77, "mma"),
                (torch.float32, 32, 256, "f32"),
                (torch.float32, 8, 100, "f32")]


@pytest.mark.parametrize("dtype,D,L,want", EVO_VARIANTS, ids=[
    f"{str(c[0])[6:]}-d{c[1]}-L{c[2]}" for c in EVO_VARIANTS])
def test_evoformer_backward_variant_by_dtype_head_dim_and_length(
        dtype, D, L, want):
    """bf16 takes the TMA + wgmma pair at D 32, 64 and 128 (any L, D 8 of
    the extra-MSA row stays on mma.sync), f32 the CUDA-core pair."""
    assert tevof.bwd_variant(dtype, D, L) == want
    assert want in tevof.BWD_VARIANTS


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8, torch.float64])
def test_evoformer_backward_variant_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bf16 or f32"):
        tevof.bwd_variant(dtype, 32, 256)


@pytest.mark.parametrize("D", [4, 12, 136])
def test_evoformer_backward_variant_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head dim"):
        tevof.bwd_variant(torch.bfloat16, D, 256)


@pytest.mark.parametrize("L,dtype,pitch", [
    (256, torch.bfloat16, 256), (100, torch.bfloat16, 104),
    (77, torch.bfloat16, 80), (100, torch.float32, 100),
    (77, torch.float32, 80), (1, torch.float32, 4)])
def test_evoformer_pair_bias_pitch_meets_the_tma_stride_rule(L, dtype,
                                                             pitch):
    """The pair bias's rows as the wgmma pair reads them: 16-byte
    multiples, L itself where it already is one, else the least
    multiple above (a zero-padded copy)."""
    got = tevof.pair_bias_pitch(L, dtype)
    assert got == pitch
    size = torch.empty((), dtype=dtype).element_size()
    assert got * size % 16 == 0 and L <= got < L + 16 // size


def test_evoformer_pair_bias_copy_holds_the_bias_and_zeros():
    """The padded copy (its rows `pair_bias_pitch` apart) holds b2 in the
    first L keys of every row and zeros past them, and is counted."""
    g = torch.Generator().manual_seed(0)
    b2 = torch.randn(1, 1, 2, 100, 100, generator=g).bfloat16()
    fn = tevof.evoformer_flash_dq
    before = fn.pair_bias_copies
    padded, pitch = tevof._tma_pair_bias(fn, b2, 100)
    assert pitch == 104 and padded.shape == (1, 1, 2, 100, 104)
    assert torch.equal(padded[..., :100], b2)
    assert not padded[..., 100:].any()
    assert fn.pair_bias_copies == before + 1
    fn.pair_bias_copies = before
    # rows already on 16-byte boundaries are read as they are
    for bias in (b2.float(), b2[..., :96, :96].contiguous()):
        L = bias.shape[-1]
        assert tevof._tma_pair_bias(fn, bias, L)[0] is bias
    assert tevof._tma_pair_bias(fn, None, 100) == (None, 100)
    assert fn.pair_bias_copies == before


def test_evoformer_variant_counters_name_every_kernel_and_count_no_cpu_launch():
    """Both wrappers of the pair keep a count per variant, all zero on
    the CPU, where the backward runs the plain versions."""
    pair = (tevof.evoformer_flash_dq, tevof.evoformer_flash_dkv)
    for fn in pair:
        assert set(fn.launches_by_variant) == set(tevof.BWD_VARIANTS)
        assert set(fn.launches_by_variant.values()) == {0}
        assert fn.pair_bias_copies == 0
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(1, 2, 9, 2, 32, generator=g).bfloat16()
                   for _ in range(4))
    b1 = torch.zeros(1, 2, 1, 1, 9)
    b2 = torch.randn(1, 1, 2, 9, 9, generator=g).bfloat16()
    out, lse = tevof.evoformer_flash_forward(q, k, v, b1, b2,
                                             return_lse=True)
    grads = tevof.evoformer_flash_backward(q, k, v, b1, b2, out, do, lse)
    assert all(bool(torch.isfinite(t.float()).all()) for t in grads)
    for fn in pair:
        assert fn.launches == 0
        assert set(fn.launches_by_variant.values()) == {0}
        assert fn.pair_bias_copies == 0


# ----------------------------------------------------------------------
# the block-sparse backward: the gathered tile plan and the kernel pair
# ----------------------------------------------------------------------
def _sparse_layouts(block, H=2, S=512):
    """(name, layout [H, nb, nb]) of each of the port's sparsity configs,
    unidirectional and bidirectional where the config has the mode, and a
    random layout whose visitor lists scatter."""
    sa = tsparse
    cfgs = [("dense", sa.DenseSparsityConfig(num_heads=H, block=block)),
            ("bigbird", sa.BigBirdSparsityConfig(
                num_heads=H, block=block, different_layout_per_head=True)),
            ("bslongformer", sa.BSLongformerSparsityConfig(
                num_heads=H, block=block)),
            ("sliding3", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=block)),
            ("sliding7", sa.LocalSlidingWindowSparsityConfig(
                num_heads=H, block=block, num_sliding_window_blocks=7))]
    for mode in ("unidirectional", "bidirectional"):
        cfgs += [(f"fixed-{mode}", sa.FixedSparsityConfig(
                     num_heads=H, block=block, num_local_blocks=4,
                     attention=mode, different_layout_per_head=True,
                     num_different_global_patterns=2)),
                 (f"variable-{mode}", sa.VariableSparsityConfig(
                     num_heads=H, block=block, attention=mode))]
    out = [(n, c.make_layout(S)) for n, c in cfgs]
    nb = S // block
    rng = np.random.RandomState(5)
    rand = np.zeros((H, nb, nb), bool)
    for h in range(H):
        for i in range(nb):
            rand[h, i, rng.choice(nb, 3, replace=False)] = True
    return out + [("random", rand)]


WALK_CASES = [(block, name, owners, grouping)
              for block in (16, 32, 64)
              for name, _ in _sparse_layouts(block)
              for owners in tsflash.OWNER_GROUPS[block]
              for grouping in tsflash.WALK_GROUPINGS]


def _visited(layout, side):
    """Sorted (h, owned block, visited block) of a layout: dq owns query
    blocks, dk/dv key blocks."""
    h, i, j = np.nonzero(layout)
    pairs = np.stack([h, i, j] if side == "dq" else [h, j, i], 1)
    return pairs[np.lexsort(pairs.T[::-1])]


@pytest.mark.parametrize("block,name,owners,grouping", WALK_CASES, ids=[
    f"b{b}-{n}-r{r}-{g}" for b, n, r, g in WALK_CASES])
def test_sparse_tile_walk_covers_each_visit_once_and_counts_its_padding(
        block, name, owners, grouping):
    layout = dict(_sparse_layouts(block))[name]
    kidx = tsparse._layout_to_gather(layout)
    tables = {"dq": kidx, "dkv": tsflash.reverse_gather(kidx)}
    for side, table in tables.items():
        walk = tsflash.tile_walk(table, block, owners, grouping)
        got = walk.pairs()
        got = got[np.lexsort(got.T[::-1])]
        assert np.array_equal(got, _visited(layout, side)), side
        # the padding factor counted by hand: each CTA's union of its
        # owners' lists, whole steps of 64 rows, over the visited pairs
        lists = [set(r[r >= 0].tolist()) for r in table.reshape(
            -1, table.shape[-1])]
        nb, gather = table.shape[1], 64 // block
        tiles, seen = 0, set()
        for h, steps, _, r, *own in walk.sched.tolist():
            assert r == owners and steps >= 0
            rows = [h * nb + o for o in own[:owners]]
            seen.update(rows)
            union = set().union(*(lists[x] for x in rows))
            assert steps == -(-len(union) // gather)
            tiles += steps * gather * owners
        assert seen == set(range(table.shape[0] * nb))
        assert walk.visits == int(layout.sum())
        assert walk.padding == pytest.approx(tiles / layout.sum())
        # the CTAs with the most steps first
        assert (np.diff(walk.sched[:, 1]) <= 0).all()


@pytest.mark.parametrize("block", [16, 32, 64])
def test_sparse_plan_takes_the_cheapest_walk(block):
    for name, layout in _sparse_layouts(block):
        kidx = tsparse._layout_to_gather(layout)
        plan = tsflash.bwd_plan(kidx, block)
        for walk, table in ((plan.dq, kidx),
                            (plan.dkv, tsflash.reverse_gather(kidx))):
            cost = walk.steps * tsflash.STEP_COST[block * walk.owners]
            for r in tsflash.OWNER_GROUPS[block]:
                for g in tsflash.WALK_GROUPINGS:
                    other = tsflash.tile_walk(table, block, r, g)
                    assert cost <= other.steps * tsflash.STEP_COST[
                        block * r], (name, r, g)
        # the device side holds the same walks
        for walk, (sched, ents) in zip((plan.dq, plan.dkv),
                                       plan.device_walks):
            assert sched.dtype == torch.int32 and ents.dtype == torch.int32
            assert np.array_equal(sched.numpy(), walk.sched)


def test_sparse_plan_at_blocks_the_wgmma_pair_does_not_take():
    layout = tsparse.FixedSparsityConfig(num_heads=2, block=8).make_layout(
        256)
    plan = tsflash.bwd_plan(tsparse._layout_to_gather(layout), 8)
    assert plan.dq is None and plan.dkv is None and not plan.device_walks
    with pytest.raises(ValueError, match="no 'adjacent' gathered walk"):
        tsflash.tile_walk(tsparse._layout_to_gather(layout), 8)


SPARSE_VARIANTS = [(torch.bfloat16, 64, 16, "wgmma"),
                   (torch.bfloat16, 128, 32, "wgmma"),
                   (torch.bfloat16, 64, 64, "wgmma"),
                   (torch.bfloat16, 64, 8, "mma"),
                   (torch.bfloat16, 128, 128, "mma"),
                   (torch.bfloat16, 192, 16, "mma"),
                   (torch.bfloat16, 256, 64, "mma"),
                   (torch.float32, 64, 16, "f32"),
                   (torch.float32, 256, 128, "f32")]


@pytest.mark.parametrize("dtype,D,block,want", SPARSE_VARIANTS, ids=[
    f"{str(d)[6:]}-d{D}-b{b}" for d, D, b, _ in SPARSE_VARIANTS])
def test_sparse_backward_variant_by_dtype_head_dim_and_block(dtype, D, block,
                                                            want):
    assert tsflash.bwd_variant(dtype, D, block) == want


CALL_PLAN_WALKS = [("dq",), ("dkv",), ("dq", "dkv")]


@pytest.mark.parametrize("walks", CALL_PLAN_WALKS, ids=[
    "+".join(w) for w in CALL_PLAN_WALKS])
def test_sparse_call_plan_builds_only_its_walks_once(walks, monkeypatch):
    """A wrapper call given no plan builds the walks it runs, the same as
    `bwd_plan`'s, once per table, block and device: a second call, or a
    call of the same table as a tensor, builds nothing."""
    monkeypatch.setattr(tsflash, "_call_walks", {})
    layout = tsparse.BSLongformerSparsityConfig(
        num_heads=2, block=16).make_layout(256)
    kidx = tsparse._layout_to_gather(layout)
    full = tsflash.bwd_plan(kidx, 16)
    built = []
    real = tsflash._plan_walk
    monkeypatch.setattr(tsflash, "_plan_walk", lambda t, b, w, *a: (
        built.append(w), real(t, b, w, *a))[1])
    plan = tsflash.call_plan(kidx, 16, "cpu", walks)
    assert built == list(walks)
    for i, w in enumerate(tsflash.WALKS):
        got, want = getattr(plan, w), getattr(full, w)
        if w in walks:
            assert np.array_equal(got.sched, want.sched)
            assert np.array_equal(got.ents, want.ents)
            assert np.array_equal(plan.device_walks[i][0].numpy(),
                                  want.sched)
        else:
            assert got is None and plan.device_walks[i] is None
    again = tsflash.call_plan(torch.from_numpy(kidx), 16, "cpu", walks)
    assert built == list(walks)
    for w in walks:
        assert getattr(again, w) is getattr(plan, w)
    # another table, block or device builds its own
    tsflash.call_plan(kidx[:, :, :1].copy(), 16, "cpu", walks)
    assert built == list(walks) * 2


def test_sparse_call_plan_keeps_the_latest_walks(monkeypatch):
    monkeypatch.setattr(tsflash, "_call_walks", {})
    monkeypatch.setattr(tsflash, "CALL_PLANS", 2)
    tables = [tsparse._layout_to_gather(
        tsparse.LocalSlidingWindowSparsityConfig(
            num_heads=1, block=16, num_sliding_window_blocks=w
        ).make_layout(128)) for w in (1, 3, 5)]
    for t in tables:
        tsflash.call_plan(t, 16, "cpu")
    assert len(tsflash._call_walks) == 4
    kept = {(k[0], k[2]) for k in tsflash._call_walks}
    assert kept == {(w, t.tobytes()) for w in tsflash.WALKS
                    for t in tables[1:]}


@pytest.mark.parametrize("dtype,D,block,err", [
    (torch.float16, 64, 16, TypeError), (torch.int8, 64, 16, TypeError),
    (torch.bfloat16, 32, 16, ValueError), (torch.bfloat16, 96, 16,
                                           ValueError),
    (torch.bfloat16, 64, 12, ValueError), (torch.float32, 64, 256,
                                           ValueError)])
def test_sparse_backward_variant_refuses_what_no_pair_takes(dtype, D, block,
                                                           err):
    with pytest.raises(err):
        tsflash.bwd_variant(dtype, D, block)


def test_sparse_variant_counters_start_at_zero_and_count_no_cpu_launch():
    for fn in (tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv):
        assert set(fn.launches_by_variant) == set(tsflash.BWD_VARIANTS)
        assert all(n == 0 for n in fn.launches_by_variant.values())
    layout = tsparse.FixedSparsityConfig(num_heads=2, block=16).make_layout(
        128)
    kidx = tsparse._layout_to_gather(layout)
    idx, rev, plan = tsparse._device_tables(kidx, "cpu", 16)
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 128, 2, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    counters = (tsflash.block_sparse_flash_attention,
                tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv,
                tsflash.block_sparse_flash_bwd_delta)
    before = [c.launches for c in counters]
    out, lse = tsflash.block_sparse_flash_attention(q, k, v, idx, 16,
                                                    return_lse=True)
    tsflash.block_sparse_flash_backward(q, k, v, idx, rev, out, do, lse, 16,
                                        plan=plan)
    assert [c.launches for c in counters] == before
    for fn in (tsflash.block_sparse_flash_dq, tsflash.block_sparse_flash_dkv):
        assert all(n == 0 for n in fn.launches_by_variant.values())


# ----------------------------------------------------------------------
# the paged kernels: variant rules, split plans, split-merge order
# ----------------------------------------------------------------------
# |emulation - Pallas| <= PAGED_TOL (rtol = atol): both in f32, the
# emulation with base-2 exponents, 64-key tiles and splits merged in
# order, the Pallas kernels with exp over their own blocks (the JAX
# package's own kernel tolerance)
PAGED_TOL = 2e-5
LOG2E = 1.4426950408889634
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,D,bs,want", [
    (BF16, 128, 64, "tma"), (BF16, 64, 16, "tma"), (BF16, 32, 8, "tma"),
    (BF16, 128, 32, "tma"), (BF16, 128, 128, "tma"), (BF16, 64, 256, "tma"),
    (BF16, 128, 24, "mma"), (BF16, 128, 48, "mma"), (BF16, 64, 96, "mma"),
    (BF16, 32, 4, "mma"), (BF16, 128, 12, "mma"),
    (F32, 128, 64, "f32"), (F32, 32, 16, "f32"), (F32, 64, 24, "f32")])
def test_paged_prefill_variant_by_dtype_head_dim_and_block(dtype, D, bs,
                                                           want):
    assert tprefill.prefill_variant(dtype, D, bs) == want


@pytest.mark.parametrize("dtype,D,bs,G,want", [
    (BF16, 128, 64, 1, "tma"), (BF16, 128, 16, 4, "tma"),
    (BF16, 32, 16, 8, "tma"), (BF16, 64, 128, 2, "tma"),
    (BF16, 128, 24, 1, "mma"), (BF16, 64, 40, 8, "mma"),
    (F32, 128, 64, 1, "f32"), (F32, 64, 16, 8, "f32")])
def test_paged_decode_variant_by_dtype_head_dim_block_and_group(dtype, D, bs,
                                                                G, want):
    assert tdecode.decode_variant(dtype, D, bs, G) == want


@pytest.mark.parametrize("dtype,D,G,err", [
    (torch.float16, 128, 1, TypeError), (torch.int8, 64, 1, TypeError),
    (BF16, 48, 1, ValueError), (BF16, 256, 1, ValueError),
    (BF16, 128, 9, ValueError), (F32, 128, 16, ValueError)])
def test_paged_variants_refuse_what_no_kernel_takes(dtype, D, G, err):
    with pytest.raises(err):
        tdecode.decode_variant(dtype, D, 64, G)
    if G <= 8:
        with pytest.raises(err):
            tprefill.prefill_variant(dtype, D, 64)


def _partitions(plan, C, n_valid, pos0, window, max_keys):
    """Each query tile's split ranges are contiguous, in split order, and
    cover exactly the key tiles of [window start, last valid key]."""
    for qt, ranges in enumerate(plan.ranges):
        k_begin, k_end = tprefill.tile_keys(qt, n_valid, pos0, window,
                                            max_keys)
        if k_end > k_begin:
            lo, hi = k_begin // 64, -(-k_end // 64)
        else:
            lo = hi = k_begin // 64
        assert len(ranges) == plan.splits
        assert ranges[0][0] == lo and ranges[-1][1] == hi
        for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
            assert a0 <= a1 == b0 <= b1
        # the last valid query's position is covered, the window's start
        # is the first key read
        if k_end > k_begin:
            c_last = min(qt * 64 + 63, n_valid - 1)
            assert lo * 64 <= k_begin and hi * 64 >= min(
                pos0 + c_last + 1, max_keys)


PREFILL_PLANS = [
    # (C, n_valid, pos0, window, NH, NKV, max_keys): the main shape, phase
    # 13's local heads, the wave's first chunk, windows, n_valid < C
    (256, 256, 1024, None, 32, 32, 2048), (256, 256, 1024, None, 16, 16, 2048),
    (256, 256, 1024, None, 8, 8, 2048), (256, 256, 0, None, 32, 32, 2048),
    (70, 61, 100, None, 8, 2, 256), (64, 64, 300, 128, 32, 8, 2048),
    (256, 100, 700, None, 32, 8, 2048), (3, 3, 77, None, 32, 32, 2048),
    (512, 400, 0, 8, 8, 2, 1024), (1, 1, 0, None, 4, 4, 64),
    (256, 256, 1900, None, 32, 32, 2048)]


@pytest.mark.parametrize("C,n_valid,pos0,window,NH,NKV,max_keys",
                         PREFILL_PLANS)
def test_prefill_plan_partitions_each_tile_key_range_in_order(
        C, n_valid, pos0, window, NH, NKV, max_keys):
    plan = tprefill.prefill_plan(C, n_valid, pos0, window, NH, NKV, 132,
                                 max_keys)
    assert plan.q_tiles == -(-C // 64)
    assert 1 <= plan.splits <= tprefill.MAX_SPLITS
    _partitions(plan, C, n_valid, pos0, window, max_keys)


@pytest.mark.parametrize("NH", [32, 16, 8])
def test_prefill_plan_fills_the_card_at_the_main_shape(NH):
    plan = tprefill.prefill_plan(256, 256, 1024, None, NH, NH, 132, 2048)
    assert plan.ctas(NH) >= 132
    # and the longest tile's splits keep two key tiles or more to pipeline
    longest = max(r[-1][1] - r[0][0] for r in plan.ranges)
    assert min(b - a for r in plan.ranges for a, b in r
               if r[-1][1] - r[0][0] == longest) >= 2


DECODE_LENS = [[36, 63, 95, 127, 199, 310, 499, 1499],
               [5, -1, 700, 64, 1, -3, 1200, 0], [40, -1, 300, 0],
               [2047, 0, 63, 64, 65]]


@pytest.mark.parametrize("lens", DECODE_LENS)
@pytest.mark.parametrize("NKV,MB,bs,ctas", [
    (32, 32, 64, 528), (32, 256, 64, 528), (2, 24, 16, 7), (4, 16, 128, 13),
    (8, 33, 8, 264), (1, 64, 32, 5), (32, 32, 64, 1000)])
def test_decode_work_list_covers_each_head_once_in_equal_shares(
        lens, NKV, MB, bs, ctas):
    plan = tdecode.decode_plan(MB, bs)
    assert plan.segs * 64 >= MB * bs
    work = tdecode.decode_work(lens, NKV, MB, bs, ctas)
    # every CTA that works carries the same number of key tiles within one
    if work.tiles_per_cta:
        assert max(work.tiles_per_cta) - min(work.tiles_per_cta) <= 1
        assert min(work.tiles_per_cta) >= 1 and len(work.tiles_per_cta) <= ctas
    for b, n in enumerate(lens):
        n_keys = min(n + 1, MB * bs)
        for kvh in range(NKV):
            segs = work.segments.get((b, kvh))
            if n_keys <= 0:
                assert segs is None
                continue
            # the CTAs sharing a head cover its keys once, in order, no
            # more of them than the workspace holds
            assert segs[0][0] == 0 and segs[-1][1] == n_keys
            assert 1 <= len(segs) <= plan.segs
            for (a0, a1), (b0, b1) in zip(segs, segs[1:]):
                assert a0 < a1 == b0 < b1 and a0 % 64 == 0 and b0 % 64 == 0


@pytest.mark.parametrize("MB", [32, 256])
def test_decode_work_is_level_at_the_wave_whatever_the_table(MB):
    """At the wave's positions the 1504 key tiles spread over a wave of
    CTAs (four an SM on 132) at 2-3 tiles each, the longest sequence over
    10 of them, whatever the table's length."""
    work = tdecode.decode_work(DECODE_LENS[0], 32, MB, 64, 528)
    assert sum(work.tiles_per_cta) == 32 * 47
    assert set(work.tiles_per_cta) == {2, 3}
    assert max(len(s) for s in work.segments.values()) == 10


def test_decode_variant_routes_a_batch_past_the_work_list_to_mma():
    assert tdecode.decode_variant(BF16, 128, 64, 1, B=4096) == "tma"
    assert tdecode.decode_variant(BF16, 128, 64, 1, B=4097) == "mma"


def _softmax_tiles(qs, keys_k, keys_v, tiles, visible):
    """One split: the online softmax over its 64-key tiles in order, in
    log2 units (scores scaled by log2(e)/sqrt(D)).  qs [R, D] f32 already
    scaled; visible(k0) -> [R, 64] bool.  Returns (m, l, acc)."""
    R, D = qs.shape
    m = np.full(R, -np.inf, np.float32)
    l = np.zeros(R, np.float32)
    acc = np.zeros((R, D), np.float32)
    for j in tiles:
        k0 = j * 64
        s = (qs @ keys_k[k0:k0 + 64].T).astype(np.float32)
        s = np.where(visible(k0), s, -np.inf)
        m_new = np.maximum(m, s.max(axis=1))
        mu = np.where(np.isneginf(m_new), 0.0, m_new).astype(np.float32)
        alpha = np.exp2(m - mu)
        p = np.exp2(s - mu[:, None]).astype(np.float32)
        l = l * alpha + p.sum(axis=1)
        acc = acc * alpha[:, None] + p @ keys_v[k0:k0 + 64]
        m = m_new
    return m, l, acc


def _merge(parts):
    """Splits' (m, l, acc) merged in split order; a row no split saw is
    zeros."""
    M = np.max([m for m, _, _ in parts], axis=0)
    L = np.zeros_like(parts[0][1])
    O = np.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = np.where(np.isneginf(m), 0.0,
                     np.exp2(m - np.where(np.isneginf(M), 0.0, M)))
        L = L + l * f
        O = O + acc * f[:, None]
    return np.where(L[:, None] > 0, O / np.where(L > 0, L, 1.0)[:, None],
                    0.0)


def _gathered(ak, av, table, kvh, pad_to):
    """K and V rows of kv head kvh in key order through the clamped
    table, zeros past the table (the kernels mask those keys)."""
    nb, bs = ak.shape[:2]
    idx = np.clip(table, 0, nb - 1)
    k = ak[idx, :, kvh].reshape(-1, ak.shape[-1])
    v = av[idx, :, kvh].reshape(-1, av.shape[-1])
    pad = max(0, pad_to - k.shape[0])
    return (np.pad(k, ((0, pad), (0, 0))), np.pad(v, ((0, pad), (0, 0))))


def _emulate_prefill(q, ak, av, table, pos0, n_valid, window, plan):
    C, NH, D = q.shape
    NKV = ak.shape[2]
    max_keys = table.size * ak.shape[1]
    out = np.zeros((C, NH, D), np.float32)
    scale = LOG2E / np.sqrt(D)
    for h in range(NH):
        kk, vv = _gathered(ak, av, table, h // (NH // NKV),
                           (max_keys // 64 + 2) * 64)
        for qt, ranges in enumerate(plan.ranges):
            c0 = qt * 64
            rows = np.zeros((64, D), np.float32)
            rows[:min(64, C - c0)] = q[c0:c0 + 64, h]
            qpos = pos0 + c0 + np.arange(64)
            _, k_end = tprefill.tile_keys(qt, n_valid, pos0, window,
                                          max_keys)

            def visible(k0, qpos=qpos, k_end=k_end):
                kp = k0 + np.arange(64)[None, :]
                vis = (kp <= qpos[:, None]) & (kp < k_end)
                if window:
                    vis &= kp > qpos[:, None] - window
                return vis

            parts = [_softmax_tiles(rows * scale, kk, vv, range(j0, j1),
                                    visible) for j0, j1 in ranges]
            merged = _merge(parts)
            out[c0:c0 + 64, h] = merged[:min(64, C - c0)]
    return out


@pytest.mark.parametrize("C,n_valid,pos0,window,NH,NKV,bs", [
    (128, 120, 100, None, 4, 2, 16), (64, 64, 250, 150, 4, 4, 16),
    (32, 20, 0, None, 4, 2, 8), (128, 128, 192, 70, 2, 1, 32),
    (40, 33, 300, None, 4, 2, 8)])
def test_prefill_split_order_matches_the_pallas_kernel(
        monkeypatch, C, n_valid, pos0, window, NH, NKV, bs):
    import jax.experimental.pallas as pl
    import deepspeed_tpu.ops.paged_prefill as jpp
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    D, nb, MB = 64, 40, 512 // bs
    rng = np.random.RandomState(C + pos0)
    q = rng.randn(C, NH, D).astype(np.float32)
    ak, av = (rng.randn(nb, bs, NKV, D).astype(np.float32)
              for _ in range(2))
    table = rng.randint(0, nb, MB).astype(np.int32)
    # 8 SMs: several splits even at these sizes, where a tile has keys to
    # split
    plan = tprefill.prefill_plan(C, n_valid, pos0, window, NH, NKV, 8,
                                 MB * bs)
    assert plan.splits > 1 or max(r[-1][1] - r[0][0]
                                  for r in plan.ranges) < 4
    got = _emulate_prefill(q, ak, av, table, pos0, n_valid, window, plan)
    want = np.asarray(jpp.paged_prefill_attention(
        *map(jnp.asarray, (q, ak, av, table)), pos0, n_valid, window))
    np.testing.assert_allclose(got[:n_valid], want[:n_valid],
                               rtol=PAGED_TOL, atol=PAGED_TOL)


def _emulate_decode(q, ak, av, tables, lens, ctas):
    B, NH, D = q.shape
    NKV, bs = ak.shape[2], ak.shape[1]
    MB = tables.shape[1]
    out = np.zeros((B, NH, D), np.float32)
    scale = LOG2E / np.sqrt(D)
    G = NH // NKV
    work = tdecode.decode_work(lens, NKV, MB, bs, ctas)
    for b in range(B):
        for kvh in range(NKV):
            segs = work.segments.get((b, kvh))
            if segs is None:
                continue
            n_keys = segs[-1][1]
            kk, vv = _gathered(ak, av, tables[b], kvh,
                               (MB * bs // 64 + 2) * 64)
            rows = q[b, kvh * G:(kvh + 1) * G] * scale

            def visible(k0, n_keys=n_keys):
                return np.broadcast_to(k0 + np.arange(64) < n_keys, (G, 64))

            parts = [_softmax_tiles(rows, kk, vv,
                                    range(k0 // 64, -(-k1 // 64)), visible)
                     for k0, k1 in segs]
            out[b, kvh * G:(kvh + 1) * G] = _merge(parts)
    return out


@pytest.mark.parametrize("NH,NKV,bs,MB,lens", [
    (8, 2, 16, 24, [5, -1, 300, 0, 16, 383]),
    (4, 4, 8, 40, [319, 63, 64, -3]), (8, 1, 32, 12, [200, 1, 383]),
    (4, 2, 64, 8, [511, 129, 128, 127])])
def test_decode_split_order_matches_the_pallas_kernel(monkeypatch, NH, NKV,
                                                      bs, MB, lens):
    import jax.experimental.pallas as pl
    import deepspeed_tpu.ops.paged_attention as jpa
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    B, D, nb = len(lens), 64, 48
    rng = np.random.RandomState(MB + bs)
    q = rng.randn(B, NH, D).astype(np.float32)
    ak, av = (rng.randn(nb, bs, NKV, D).astype(np.float32)
              for _ in range(2))
    tables = rng.randint(-3, nb + 3, (B, MB)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    # few CTAs for the work: a head's tiles shared by several of them
    work = tdecode.decode_work(lens, NKV, MB, bs, 5)
    assert max(len(s) for s in work.segments.values()) > 1
    got = _emulate_decode(q, ak, av, tables, lens, 5)
    want = np.asarray(jpa.paged_decode_attention(
        *map(jnp.asarray, (q, ak, av, tables, lens))))
    np.testing.assert_allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)
    assert (got[lens < 0] == 0).all()


def test_paged_variant_counters_name_every_kernel_and_count_no_cpu_launch():
    wrappers = (tprefill.paged_prefill_attention,
                tdecode.paged_decode_attention,
                tmerged.merged_prefill_attention,
                tmerged.merged_decode_attention)
    for fn in wrappers:
        assert set(fn.launches_by_variant) == {"tma", "mma", "f32"}
    before = [(fn.launches, dict(fn.launches_by_variant)) for fn in wrappers]
    rng = np.random.RandomState(0)
    ak, av = (torch.from_numpy(rng.randn(2, 8, 16, 2, 32).astype(np.float32))
              .bfloat16() for _ in range(2))
    q = torch.from_numpy(rng.randn(3, 4, 32).astype(np.float32)).bfloat16()
    tables = torch.from_numpy(rng.randint(0, 8, (3, 4)).astype(np.int32))
    lens = torch.tensor([5, -1, 40], dtype=torch.int32)
    tdecode.paged_decode_attention(q, ak, av, tables, lens, layer_idx=1)
    tprefill.paged_prefill_attention(q, ak, av, tables[0], 10, 3,
                                     layer_idx=0)
    mk, mv = (t.view(2, 8, 16, 64) for t in (ak, av))
    tmerged.merged_decode_attention(q, mk, mv, tables, lens, layer_idx=1)
    tmerged.merged_prefill_attention(q, mk, mv, tables[0], 10, 3,
                                     layer_idx=0)
    assert [(fn.launches, dict(fn.launches_by_variant))
            for fn in wrappers] == before


# ----------------------------------------------------------------------
# the fused LoRA delta: work items and order of sums
# ----------------------------------------------------------------------
# |emulation - JAX| <= LORA_REL max|JAX|: f32 products of the same inputs
# on both sides, summed in another order (chip_smoke's LoRA limit)
LORA_REL = 1e-5


def _lora_ids(S, slots, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(-1, slots, S).astype(np.int32)
    ids[::5] = -1
    return ids


LORA_ITEMS = [(1, 4096, 4096, 4, 0), (32, 4096, 4096, 4, 1),
              (512, 4096, 4096, 4, 2), (77, 1000, 777, 3, 3),
              (40, 256, 256, 1, 4), (20, 300, 200, 4, 5)]


@pytest.mark.parametrize("S,K,N,slots,seed", LORA_ITEMS, ids=[
    f"s{s}-k{k}-n{n}" for s, k, n, *_ in LORA_ITEMS])
def test_lora_work_items_cover_each_tile_span_once_shrinks_first(
        S, K, N, slots, seed):
    """The fused kernel's work list: every (adapter tile, K span) shrink
    item and every (tile, N span) expand item once, every shrink item
    before any expand item (so an expand item, which waits for its tile's
    shrinks, never waits on an item no CTA has taken); the tiles group one
    slot's rows, at most TILE_ROWS a tile, base tiles first."""
    ids = _lora_ids(S, slots, seed)
    if S == 1:
        ids[:] = 0
    perm, tiles, n_base = tlora.LoraRows(ids).tiles()
    assert sorted(perm.tolist()) == list(range(S))
    assert (tiles[:n_base, 0] < 0).all() and (tiles[n_base:, 0] >= 0).all()
    covered = []
    for slot, p0, rows in tiles.tolist():
        assert 1 <= rows <= tlora.TILE_ROWS
        got = ids[perm[p0:p0 + rows]]
        assert ((got < 0) if slot < 0 else (got == slot)).all()
        covered += perm[p0:p0 + rows].tolist()
    assert sorted(covered) == list(range(S))
    items = tlora.work_items(len(tiles), n_base, K, N)
    kinds = [kind for kind, _, _ in items]
    n_shrink = kinds.count("shrink")
    assert kinds == ["shrink"] * n_shrink + ["expand"] * (len(kinds)
                                                          - n_shrink)
    ks, ns = -(-K // tlora.SPAN), -(-N // tlora.SPAN)
    shrink = [(t, s) for kind, t, s in items if kind == "shrink"]
    expand = [(t, s) for kind, t, s in items if kind == "expand"]
    assert shrink == [(t, s) for t in range(n_base, len(tiles))
                      for s in range(ks)]
    assert sorted(set(expand)) == expand == [
        (t, n) for t in range(len(tiles)) for n in range(ns)]


def _contract(X, W, J0, chunk, C):
    """out [rows, C] = X [:, j] W [j, :] over j in [J0, J0 + len) summed as
    the fused kernel does: the item's j range in chunks of `chunk`; in
    each, k-group g (KG = 256 / (4 ceil(C / 4)) of them) takes the
    4-row pieces g, g + KG, ... of the chunk; the groups' f32 sums added
    in group order."""
    KG = 256 // (4 * -(-C // 4))
    J = X.shape[1]
    acc = np.zeros((KG, X.shape[0], C), np.float32)
    for c0 in range(0, J, chunk):
        jc = min(chunk, J - c0)
        for g in range(KG):
            for j0 in range(4 * g, jc, 4 * KG):
                for j in range(j0, min(j0 + 4, jc)):
                    acc[g] += (X[:, c0 + j, None] * W[None, c0 + j]).astype(
                        np.float32)
    out = np.zeros(acc.shape[1:], np.float32)
    for g in range(KG):
        out += acc[g]
    return out


def _emulate_lora(x, a, b, ids, scaling):
    """The fused kernel in numpy f32: per adapter tile, a partial h per K
    span (`_contract` over chunks of k_chunk rows), the partials summed
    in span order, then each N span's h B (chunks of 16 rows of B),
    times scaling; base rows 0.0."""
    S, K = x.shape
    r, N = b.shape[1], b.shape[2]
    span = tlora.SPAN
    k_chunk = min(span, 4096 // r // 8 * 8)
    perm, tiles, _ = tlora.LoraRows(ids).tiles()
    out = np.zeros((S, N), np.float32)
    for slot, p0, rows in tiles.tolist():
        if slot < 0:
            continue
        xr = x[perm[p0:p0 + rows]]
        h = np.zeros((rows, r), np.float32)
        for k0 in range(0, K, span):      # span order
            h += _contract(xr[:, k0:k0 + span], a[slot, k0:k0 + span],
                           0, k_chunk, r)
        for n0 in range(0, N, span):
            nc = min(span, N - n0)
            o = _contract(h, b[slot, :, n0:n0 + nc], 0, 16, nc)
            out[perm[p0:p0 + rows], n0:n0 + nc] = o * np.float32(scaling)
    return out


@pytest.mark.parametrize("S,K,N,r,impl", [(24, 384, 256, 16, "pallas"),
                                          (20, 512, 384, 40, "pallas"),
                                          (18, 300, 200, 4, "jnp")])
def test_lora_fused_order_of_sums_matches_jax(monkeypatch, S, K, N, r,
                                             impl):
    """The fused kernel's order of sums (k-groups in order, K spans'
    partials in span order, B in 16-row chunks), emulated in numpy f32,
    within LORA_REL of the JAX `lora_delta` (the Pallas kernel in
    interpret mode where it takes the shape, else the jnp path); base
    rows exactly 0.0."""
    from deepspeed_tpu.ops import lora_matmul as jlora
    rng = np.random.RandomState(S + K + r)
    x = rng.randn(S, K).astype(np.float32)
    a = (rng.randn(3, K, r) / np.sqrt(K)).astype(np.float32)
    b = rng.randn(3, r, N).astype(np.float32)
    ids = _lora_ids(S, 3, S)
    got = _emulate_lora(x, a, b, ids, 0.5)
    kw = {"interpret": True} if impl == "pallas" else {}
    ref = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), jnp.asarray(ids),
                                      scaling=0.5, impl=impl, **kw))
    assert (got[ids < 0] == 0).all()
    assert np.abs(got - ref).max() <= LORA_REL * np.abs(ref).max()


# ----------------------------------------------------------------------
# the block-sparse forward: its walk, its rule, its order of sums
# ----------------------------------------------------------------------
FWD_WALK_CASES = [(block, name) for block in (16, 32, 64)
                  for name, _ in _sparse_layouts(block)]


@pytest.mark.parametrize("block,name", FWD_WALK_CASES, ids=[
    f"b{b}-{n}" for b, n in FWD_WALK_CASES])
def test_sparse_forward_walk_visits_each_pair_once(block, name):
    """The forward's walk: 64 / block query blocks a CTA (64 rows), as
    many key blocks a step, every (query block, key block) pair of the
    layout visited once, a mask bit set exactly where its owner's list
    holds the block (`pairs`), every query block owned once; the
    fewer-steps grouping."""
    layout = dict(_sparse_layouts(block))[name]
    for nb in (layout.shape[1], layout.shape[1] - 3):   # the second ragged
        lay = layout[:, :nb, :nb].copy()
        lay[:, np.arange(nb), np.arange(nb)] = True
        kidx = tsparse._layout_to_gather(lay)
        walk = tsflash.fwd_walk(kidx, block)
        owners = 64 // block
        assert walk.owners == owners and walk.gather == owners
        got = walk.pairs()
        got = got[np.lexsort(got.T[::-1])]
        assert np.array_equal(got, _visited(lay, "dq"))
        owned = [(h, o) for h, _, _, _, *own in walk.sched.tolist()
                 for o in own[:owners] if o >= 0]
        assert sorted(owned) == [(h, i) for h in range(lay.shape[0])
                                 for i in range(nb)]
        gaps = sum(o < 0 for row in walk.sched.tolist()
                   for o in row[4:4 + owners])
        assert gaps == lay.shape[0] * (-nb % owners)
        other = [tsflash.tile_walk(kidx, block, owners, g, ragged=True)
                 for g in tsflash.WALK_GROUPINGS]
        assert walk.steps == min(w.steps for w in other)


def test_sparse_tile_walk_refuses_a_ragged_group_unless_asked():
    kidx = tsparse._layout_to_gather(np.eye(10, dtype=bool)[None])
    with pytest.raises(ValueError, match="gathered walk"):
        tsflash.tile_walk(kidx, 16, 4)
    assert tsflash.tile_walk(kidx, 16, 4, ragged=True).sched.shape[0] == 3


@pytest.mark.parametrize("dtype,D,block,want", SPARSE_VARIANTS, ids=[
    f"{str(d)[6:]}-d{D}-b{b}" for d, D, b, _ in SPARSE_VARIANTS])
def test_sparse_forward_variant_by_dtype_head_dim_and_block(dtype, D, block,
                                                           want):
    assert tsflash.fwd_variant(dtype, D, block) == want


@pytest.mark.parametrize("dtype,D,block,err", [
    (torch.float16, 64, 16, TypeError), (torch.int8, 64, 16, TypeError),
    (torch.bfloat16, 32, 16, ValueError), (torch.bfloat16, 96, 16,
                                           ValueError),
    (torch.bfloat16, 64, 12, ValueError), (torch.float32, 64, 256,
                                           ValueError)])
def test_sparse_forward_variant_refuses_what_no_kernel_takes(dtype, D, block,
                                                            err):
    with pytest.raises(err):
        tsflash.fwd_variant(dtype, D, block)


def test_sparse_plan_holds_the_forward_walk_and_call_plan_builds_it_alone(
        monkeypatch):
    monkeypatch.setattr(tsflash, "_call_walks", {})
    layout = tsparse.BSLongformerSparsityConfig(
        num_heads=2, block=16).make_layout(480)        # 30 blocks: ragged
    kidx = tsparse._layout_to_gather(layout)
    plan = tsflash.bwd_plan(kidx, 16)
    want = tsflash.fwd_walk(kidx, 16)
    assert np.array_equal(plan.fwd.sched, want.sched)
    assert np.array_equal(plan.device("fwd")[1].numpy(), want.ents)
    built = []
    real = tsflash._plan_walk
    monkeypatch.setattr(tsflash, "_plan_walk", lambda t, b, w, *a: (
        built.append(w), real(t, b, w, *a))[1])
    got = tsflash.call_plan(kidx, 16, "cpu", ("fwd",))
    assert built == ["fwd"] and got.dq is None and got.dkv is None
    assert np.array_equal(got.fwd.ents, want.ents)
    tsflash.call_plan(torch.from_numpy(kidx), 16, "cpu", ("fwd",))
    assert built == ["fwd"]


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _emulate_sparse_forward(q, k, v, kidx, block, causal, scale):
    """The wgmma forward in numpy f32 over its walk: per CTA, the owners'
    query rows; per step the gathered 64 keys (a -1 entry: zeros),
    scores times scale log2 e masked by owner bit and causal to -1e30,
    the online softmax in base 2 (row max m, alpha = 2^(m_old - m_new)),
    P rounded to bf16 before O += P V; out = O / max(l, 1e-30), lse = m
    / log2 e + log(max(l, 1e-30)) (m -1e30 where the row saw no key)."""
    B, S, H, D = q.shape
    walk = tsflash.fwd_walk(kidx, block)
    R, G = walk.owners, walk.gather
    M = R * block                              # query rows a CTA
    neg, log2e = -1e30, np.float32(1.4426950408889634)
    out = np.zeros_like(q)
    lse = np.zeros((B, H, S), np.float32)
    for h, steps, off, _, *own in walk.sched.tolist():
        own = own[:R]
        rows = np.arange(M)
        qpos = np.array([own[r // block] * block + r % block for r in rows])
        for b in range(B):
            Q = np.stack([q[b, p, h] if own[r // block] >= 0 else
                          np.zeros(D, np.float32)
                          for r, p in zip(rows, qpos)])
            m = np.full(M, neg, np.float32)
            l = np.zeros(M, np.float32)
            O = np.zeros((M, D), np.float32)
            for j in range(steps):
                ents = walk.ents[off + j * G:off + (j + 1) * G]
                K = np.zeros((64, D), np.float32)
                V = np.zeros((64, D), np.float32)
                vis = np.zeros((M, 64), bool)
                for i, e in enumerate(ents.tolist()):
                    if e < 0:
                        continue
                    kp = (e >> 4) * block + np.arange(block)
                    K[i * block:(i + 1) * block] = k[b, kp, h]
                    V[i * block:(i + 1) * block] = v[b, kp, h]
                    bits = (e >> (rows // block)) & 1
                    ok = bits[:, None] == 1
                    if causal:
                        ok = ok & (kp[None, :] <= qpos[:, None])
                    vis[:, i * block:(i + 1) * block] = ok
                s = np.where(vis, (Q @ K.T) * np.float32(scale) * log2e,
                             np.float32(neg)).astype(np.float32)
                m_new = np.maximum(m, s.max(1))
                alpha = np.exp2(m - m_new).astype(np.float32)
                p = np.where(s > neg / 2, np.exp2(s - m_new[:, None]),
                             0).astype(np.float32)
                l = l * alpha + p.sum(1)
                O = O * alpha[:, None] + _bf16(p) @ V
                m = m_new
            lsafe = np.maximum(l, np.float32(1e-30))
            for r in rows:
                if own[r // block] < 0:
                    continue
                out[b, qpos[r], h] = O[r] / lsafe[r]
                lse[b, h, qpos[r]] = ((m[r] / log2e if m[r] > neg / 2
                                       else neg) + np.log(lsafe[r]))
    return out, lse


def _fwd_emulation_layouts():
    rng = np.random.RandomState(7)
    scattered = np.zeros((2, 12, 12), bool)
    for h in range(2):
        for i in range(12):
            scattered[h, i, rng.choice(12, 3, replace=False)] = True
    masked = np.eye(8, dtype=bool)[None].repeat(2, 0)
    masked[0, 2] = False
    masked[0, 2, 5] = True            # causal: q-block 2 sees no key
    return {
        "fixed16": (tsparse.FixedSparsityConfig(
            num_heads=2, block=16, num_local_blocks=4,
            attention="bidirectional").make_layout(256), 16, False),
        "scattered16": (scattered, 16, False),
        "masked-row16": (masked, 16, True),
        "ragged16": (tsparse.BSLongformerSparsityConfig(
            num_heads=2, block=16).make_layout(160), 16, True),
        "sliding32": (tsparse.LocalSlidingWindowSparsityConfig(
            num_heads=2, block=32).make_layout(288), 32, True)}


# the forward tolerance (chip_smoke's): out |d| <= 0.02 + 2^-7 |JAX|, lse
# 1e-3 — the emulation rounds P to bf16 before P V as the kernel does,
# the f32 Pallas kernel keeps it f32
FWD_ATOL, FWD_RTOL, FWD_LSE = 2e-2, 2 ** -7, 1e-3


@pytest.mark.parametrize("name", list(_fwd_emulation_layouts()))
def test_sparse_forward_order_of_sums_matches_the_pallas_kernel(monkeypatch,
                                                                name):
    """The wgmma forward's gathered, owner-masked online softmax (lists
    ending mid-step, a ragged last group, a row that sees no key),
    emulated in numpy over the plan's walk, against the JAX
    `block_sparse_flash_attention` (its Pallas kernel in interpret mode)
    on the same bf16-representable inputs."""
    import functools as ft

    import jax.experimental.pallas as pl
    from deepspeed_tpu.ops import sparse_flash as jsf
    monkeypatch.setattr(pl, "pallas_call",
                        ft.partial(pl.pallas_call, interpret=True))
    layout, block, causal = _fwd_emulation_layouts()[name]
    H, nb, _ = layout.shape
    rng = np.random.RandomState(nb + block)
    q, k, v = (_bf16(rng.randn(2, nb * block, H, 64).astype(np.float32))
               for _ in range(3))
    kidx = tsparse._layout_to_gather(layout)
    scale = 1.0 / 8.0
    got, got_lse = _emulate_sparse_forward(q, k, v, kidx, block, causal,
                                           scale)
    ref, ref_lse = (np.asarray(t) for t in jsf.block_sparse_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kidx, block,
        causal=causal, return_lse=True))
    assert (np.abs(got - ref) <= FWD_ATOL + FWD_RTOL * np.abs(ref)).all()
    assert np.abs(got_lse - ref_lse.reshape(got_lse.shape)).max() <= FWD_LSE
    if name == "masked-row16":
        assert (got[:, 2 * block:3 * block, 0] == 0).all()


# ----------------------------------------------------------------------
# the Evoformer forward and db2: their rules, plans and orders of sums
# ----------------------------------------------------------------------
# phase 12's shapes (chip_smoke EVO_SHAPES): MSA row, triangle, extra-MSA
EVO_SHAPES = [(1, 128, 256, 8, 32), (1, 256, 256, 4, 32),
              (1, 1024, 256, 8, 8)]
# (dtype, D, L, N, pair-bias dtype, forward, db2): the phase-12 shapes,
# phase 1's cases, AlphaFold 2's fine-tuning crop (L 384), and rows whose
# forward strip does not fit shared memory
EVO_NEW_VARIANTS = [
    (torch.bfloat16, 32, 256, 128, torch.bfloat16, "wgmma", "wgmma"),
    (torch.bfloat16, 32, 256, 256, torch.bfloat16, "wgmma", "wgmma"),
    (torch.bfloat16, 8, 256, 1024, torch.bfloat16, "rows", "split"),
    (torch.bfloat16, 8, 256, 16, torch.bfloat16, "rows", "mma"),
    (torch.bfloat16, 64, 128, 8, None, "wgmma", "wgmma"),
    (torch.bfloat16, 128, 128, 4, torch.bfloat16, "wgmma", "wgmma"),
    (torch.bfloat16, 32, 100, 4, torch.bfloat16, "wgmma", "mma"),
    (torch.bfloat16, 16, 64, 4, None, "rows", "mma"),
    (torch.bfloat16, 48, 77, 40, torch.float32, "rows", "split"),
    (torch.bfloat16, 32, 384, 32, torch.bfloat16, "wgmma", "wgmma"),
    (torch.bfloat16, 8, 384, 64, torch.bfloat16, "rows", "split"),
    (torch.bfloat16, 128, 384, 32, torch.float32, "wgmma", "wgmma"),
    (torch.bfloat16, 128, 448, 32, torch.float32, "mma", "wgmma"),
    (torch.bfloat16, 128, 800, 32, torch.bfloat16, "mma", "wgmma"),
    (torch.bfloat16, 8, 704, 64, torch.bfloat16, "rows", "split"),
    (torch.bfloat16, 8, 768, 64, torch.bfloat16, "mma", "split"),
    (torch.bfloat16, 8, 384, 64, torch.float32, "mma", "split"),
    (torch.bfloat16, 8, 2000, 64, torch.bfloat16, "mma", "split"),
    (torch.bfloat16, 32, 5000, 64, None, "wgmma", "wgmma"),
    (torch.float32, 32, 256, 128, torch.float32, "f32", "f32"),
    (torch.float32, 8, 100, 4, None, "f32", "f32")]


@pytest.mark.parametrize("dtype,D,L,N,b2_dtype,fwd,db2", EVO_NEW_VARIANTS,
                         ids=[f"{str(c[0])[6:]}-d{c[1]}-L{c[2]}-N{c[3]}-"
                              f"{str(c[4])[6:]}" for c in EVO_NEW_VARIANTS])
def test_evoformer_forward_and_db2_variants(dtype, D, L, N, b2_dtype, fwd,
                                            db2):
    """bf16 takes the row-walking forward (TMA + wgmma at D 32, 64 and
    128 wherever its pair-bias strip fits shared memory, mma.sync at
    other D while two of its CTAs fit an SM), the first kernel past it,
    and the split db2 (wgmma at D
    32/64/128, mma.sync at other D; the first kernel at D <= 32 with
    fewer than 32 rows); f32 the CUDA-core kernels."""
    assert tevof.fwd_variant(dtype, D, L, b2_dtype) == fwd
    assert tevof.db2_variant(dtype, D, L, N) == db2
    assert fwd in tevof.FWD_VARIANTS and db2 in tevof.DB2_VARIANTS


# (the longest L, a multiple of 64, whose pair-bias strip [64, L] fits a
# row-walking forward CTA beside its tiles; the longest L the rule routes
# to it), by head dim and pair-bias dtype, from the launchers' sizes
# worked by hand.  Fit: (smem limit 232448 - the rest of the CTA) // (64 x
# 64 x the bias's bytes) key tiles, the wgmma kernel's rest 1024 + 8 x 64
# x D x 2 + 2048 static, the mma.sync kernel's 1024 + 2 stages of 3 x 64
# x (D padded + 8) x 2 + 256 bytes.  Routed: the wgmma kernel wherever it
# fits; the mma.sync kernel while two CTAs fit an SM's 233472 bytes, 1024
# reserved a CTA: (116736 - 1024 - the rest) // the tile's bytes
EVO_STRIP_LIMITS = {(8, "bf16"): (1600, 704), (8, "f32"): (768, 320),
                    (32, "bf16"): (1536, 1536), (32, "f32"): (768, 768),
                    (48, "bf16"): (1344, 448), (48, "f32"): (640, 192),
                    (64, "bf16"): (1280, 1280), (64, "f32"): (640, 640),
                    (128, "bf16"): (768, 768), (128, "f32"): (384, 384)}


@pytest.mark.parametrize("D,b2", list(EVO_STRIP_LIMITS),
                         ids=[f"d{d}-{b}" for d, b in EVO_STRIP_LIMITS])
def test_evoformer_forward_takes_the_row_kernels_while_the_strip_fits(D,
                                                                      b2):
    """One rule for the forward's long rows: a row-walking kernel takes
    (when named) every L whose strip fits (`fwd_smem` <= SMEM_MAX); the
    rule routes to it up to the longest L it is faster at (the wgmma
    kernel wherever it fits, the mma.sync one while ROWS_MIN_RESIDENT of
    its CTAs fit an SM), the first kernel from the next length on, and
    any L without a pair bias."""
    b2_dtype = torch.bfloat16 if b2 == "bf16" else torch.float32
    top, routed = EVO_STRIP_LIMITS[(D, b2)]
    new = "wgmma" if D in (32, 64, 128) else "rows"
    assert tevof.fwd_smem(new, D, top, b2_dtype) <= tevof.SMEM_MAX
    assert tevof.fwd_smem(new, D, top + 1, b2_dtype) > tevof.SMEM_MAX
    for L in (1, 100, min(256, routed), routed - 63, routed):
        assert tevof.fwd_variant(torch.bfloat16, D, L, b2_dtype) == new
    for L in (routed + 1, routed + 64, top + 1, 4096):
        assert tevof.fwd_variant(torch.bfloat16, D, L, b2_dtype) == "mma"
        assert tevof.fwd_variant(torch.bfloat16, D, L, None) == new
    q = torch.zeros(1, 1, top, 1, D, dtype=torch.bfloat16)
    assert tevof._route("fwd", new, q, b2_dtype) == new
    # the first kernel takes any L; a named row kernel past the limit
    # raises
    q = torch.zeros(1, 1, top + 1, 1, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"variant '{new}'"):
        tevof._route("fwd", new, q, b2_dtype)
    assert tevof._route("fwd", "mma", q, b2_dtype) == "mma"


@pytest.mark.parametrize("rule", ["fwd", "db2"])
def test_evoformer_forward_and_db2_variants_refuse_what_bwd_refuses(rule):
    rule = ((lambda dt, D, L: tevof.fwd_variant(dt, D, L, torch.bfloat16))
            if rule == "fwd" else
            (lambda dt, D, L: tevof.db2_variant(dt, D, L, 64)))
    for dtype in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(TypeError, match="bf16 or f32"):
            rule(dtype, 32, 256)
    for D in (4, 12, 136):
        with pytest.raises(ValueError, match="head dim"):
            rule(torch.bfloat16, D, 256)
    with pytest.raises(ValueError, match="length"):
        rule(torch.bfloat16, 32, 0)


@pytest.mark.parametrize("kernel,variant,D,L", [
    ("fwd", "wgmma", 8, 256), ("fwd", "rows", 32, 2048),
    ("fwd", "f32", 32, 256), ("db2", "wgmma", 24, 256),
    ("db2", "f32", 32, 256), ("db2", "mma_sync", 32, 256)])
def test_evoformer_named_variant_that_cannot_take_the_call_raises(
        kernel, variant, D, L):
    """A variant named by the caller must take the call: no other kernel
    is tried."""
    q = torch.zeros(1, 1, L, 1, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"variant '{variant}'"):
        tevof._route(kernel, variant, q, torch.float32)
    # the first kernels take every bf16 call
    assert tevof._route(kernel, "mma", q, torch.float32) == "mma"


def _split_ranges(N, splits):
    """The rows [n0, n1) of each split as the kernels cut them
    (`split_row`: split s starts at s N / splits)."""
    return [(s * N // splits, (s + 1) * N // splits) for s in range(splits)]


def _wave(kernel, D, L, sms=132):
    """One wave of the forward's or db2's new kernel at bf16 pair bias."""
    new = ("wgmma" if D in (32, 64, 128) else
           "rows" if kernel == "fwd" else "split")
    smem = (tevof.fwd_smem(new, D, L, torch.bfloat16) if kernel == "fwd"
            else tevof.db2_smem(new, D, torch.bfloat16))
    return sms * tevof.resident(kernel, new, D, smem)


@pytest.mark.parametrize("shape", EVO_SHAPES,
                         ids=["msa_row", "triangle", "extra_msa_row"])
def test_evoformer_db2_plan_fills_a_wave_and_covers_each_row_once(shape):
    """At 132 SMs each phase-12 shape's db2 grid fills one wave of resident
    CTAs (at least two CTAs an SM, as many as the kernel holds) to within
    one tile's splits and no further (a second partial wave measured
    slower on an H100), each split walks a contiguous run of rows in
    order, every row n in exactly one split, no split under
    MIN_SPLIT_ROWS rows."""
    B, N, L, H, D = shape
    splits = tevof.db2_plan(B, N, L, H, D, torch.bfloat16, 132)
    tiles = B * H * (L // 64) ** 2
    wave = _wave("db2", D, L)
    assert wave - tiles < tiles * splits <= wave
    assert tiles * splits >= 1.9 * 132
    assert splits > 1
    ranges = _split_ranges(N, splits)
    assert [n for n0, n1 in ranges for n in range(n0, n1)] == list(range(N))
    assert min(n1 - n0 for n0, n1 in ranges) >= tevof.MIN_SPLIT_ROWS
    before = tevof.db2_plan.cache_info().hits     # cached per shape
    tevof.db2_plan(B, N, L, H, D, torch.bfloat16, 132)
    assert tevof.db2_plan.cache_info().hits == before + 1


def test_evoformer_db2_plan_at_few_rows_and_many_tiles():
    """Fewer rows than MIN_SPLIT_ROWS, or more tiles than a wave: one
    split walking every row."""
    for shape in ((1, 3, 256, 8, 32), (4, 64, 1024, 16, 32)):
        assert tevof.db2_plan(*shape, torch.bfloat16, 132) == 1


@pytest.mark.parametrize("kernel,variant,D,b2,want", [
    ("fwd", "wgmma", 32, "bf16", 3), ("fwd", "wgmma", 64, "bf16", 2),
    ("fwd", "wgmma", 128, "bf16", 1), ("fwd", "rows", 8, "bf16", 4),
    ("fwd", "rows", 48, "bf16", 2), ("db2", "wgmma", 32, "bf16", 2),
    ("db2", "wgmma", 64, "bf16", 2), ("db2", "wgmma", 64, "f32", 1),
    ("db2", "wgmma", 128, "bf16", 1), ("db2", "split", 8, "f32", 4),
    ("db2", "split", 48, "bf16", 1)])
def test_evoformer_resident_ctas_follow_launch_bounds_and_smem(
        kernel, variant, D, b2, want):
    """CTAs an SM, as the plans count a wave, at L 256: the kernel's launch
    bound (forward wgmma 3/2/1 at D 32/64/128, db2 wgmma 2/2/1, the
    mma.sync kernels 4 at D 8 and 2 above), or fewer where shared memory
    holds fewer (db2 wgmma at D 64 with a f32 pair bias: 115 KB a CTA;
    the mma.sync db2 at D 48, three stages at width 64: 122 KB)."""
    b2_dtype = torch.bfloat16 if b2 == "bf16" else torch.float32
    smem = (tevof.fwd_smem(variant, D, 256, b2_dtype) if kernel == "fwd"
            else tevof.db2_smem(variant, D, b2_dtype))
    assert tevof.resident(kernel, variant, D, smem) == want


@pytest.mark.parametrize("shape", EVO_SHAPES + [(1, 16, 256, 8, 8),
                                                (1, 4, 100, 4, 32),
                                                (1, 32, 384, 8, 32),
                                                (2, 70000, 16, 1, 8)])
def test_evoformer_forward_plan_walks_each_row_once(shape):
    """The forward's groups cover every row n once (the last may hold
    fewer), at most FWD_MAX_ROWS rows a CTA, 4 at the phase-12 shapes,
    and fewer where that keeps the grid a wave of resident CTAs."""
    B, N, L, H, D = shape
    rows = tevof.fwd_plan(B, N, L, H, D, torch.bfloat16, 132)
    units = B * H * -(-L // 64)
    groups = -(-N // rows)
    assert 1 <= rows <= tevof.FWD_MAX_ROWS
    assert (groups - 1) * rows < N <= groups * rows
    if shape in EVO_SHAPES:
        assert rows == 4
    elif rows < tevof.FWD_MAX_ROWS:
        assert N * units < _wave("fwd", D, L) * (rows + 1)


def test_evoformer_forward_and_db2_counters_start_at_zero():
    """The forward and db2 keep a count per variant and of the padded
    pair-bias copies their TMA kernels read, all zero on the CPU, where
    they run their plain versions (a named variant is for the card)."""
    for fn, kinds in ((tevof.evoformer_flash_forward, tevof.FWD_VARIANTS),
                      (tevof.evoformer_flash_db2, tevof.DB2_VARIANTS)):
        assert tuple(fn.launches_by_variant) == kinds
        assert set(fn.launches_by_variant.values()) == {0}
        assert fn.pair_bias_copies == 0
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 5, 9, 2, 32, generator=g).bfloat16()
                   for _ in range(4))
    b2 = torch.randn(1, 1, 2, 9, 9, generator=g).bfloat16()
    out, lse = tevof.evoformer_flash_forward(
        q, k, v, None, b2, return_lse=True, variant="wgmma")
    ref, ref_lse = tevof.evoformer_flash_forward_reference(q, k, v, None, b2)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    _, delta = tevof.evoformer_flash_dq(q, k, v, None, b2, out, do, lse)
    db2 = tevof.evoformer_flash_db2(q, k, v, None, b2, do, lse, delta,
                                    variant="split")
    assert torch.equal(db2, tevof.evoformer_flash_db2_reference(
        q, k, v, None, b2, do, lse, delta))
    for fn in (tevof.evoformer_flash_forward, tevof.evoformer_flash_db2):
        assert fn.launches == 0
        assert set(fn.launches_by_variant.values()) == {0}


def _evo_bf16_inputs(B, N, L, H, D, seed):
    """bf16-representable f32 q, k, v, dO, a mask bias with ~15% of keys
    at -1e9 and row n = 1 at -1e30 on every key, a pair bias."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (_bf16(rng.randn(B, N, L, H, D).astype(np.float32))
                   for _ in range(4))
    b1 = np.where(rng.rand(B, N, 1, 1, L) < 0.15, -1e9, 0.0).astype(
        np.float32)
    b1[:, 1] = -1e30
    b2 = _bf16(rng.randn(B, 1, H, L, L).astype(np.float32))
    return q, k, v, do, b1, b2


def _evo_scores(q, k, b1, b2, b, n, h, scale):
    """s scale + b1 + b2 of row n, head h, in that order, f32 [L, L]."""
    s = (q[b, n, :, h] @ k[b, n, :, h].T).astype(np.float32)
    return ((s * np.float32(scale) + b1[b, n, 0, 0][None, :])
            + b2[b, 0, h]).astype(np.float32)


def _neg_lse2(lse):
    """The kernels' -lse log2(e): -inf at or below the mask level."""
    return np.where(lse > -5e29, -lse * np.float32(1.4426950408889634),
                    -np.inf).astype(np.float32)


def _emulate_evo_forward(q, k, v, b1, b2, scale, rows):
    """The row-walking forward in numpy f32, `rows` rows a CTA: each group's
    rows n in order, per row the online softmax over 64-key tiles (keys
    past L at -1e30), the running max m from -1e30, alpha = 2^((m_old -
    m_new) log2 e), p = 2^(x log2 e - m log2 e) (every p 0 while m is at
    the mask level), P rounded to bf16 before O += P V; out = O / max(l,
    1e-9), lse = m + log(max(l, 1e-9))."""
    B, N, L, H, D = q.shape
    log2e = np.float32(1.4426950408889634)
    out = np.zeros_like(q)
    lse = np.zeros((B, N, H, L), np.float32)
    seen = []
    for b in range(B):
        for grp in range(-(-N // rows)):
            for n in range(grp * rows, min(N, (grp + 1) * rows)):
                seen.append((b, n))
                for h in range(H):
                    x = _evo_scores(q, k, b1, b2, b, n, h, scale)
                    m = np.full(L, -1e30, np.float32)
                    l = np.zeros(L, np.float32)
                    O = np.zeros((L, D), np.float32)
                    for k0 in range(0, L, 64):
                        xt, vt = x[:, k0:k0 + 64], v[b, n, k0:k0 + 64, h]
                        m_new = np.maximum(m, xt.max(1))
                        alpha = np.exp2((m - m_new) * log2e)
                        nm = _neg_lse2(m_new)[:, None]
                        p = np.exp2(xt * log2e + nm).astype(np.float32)
                        l = l * alpha + p.sum(1)
                        O = O * alpha[:, None] + _bf16(p) @ vt
                        m = m_new
                    lsafe = np.maximum(l, np.float32(1e-9))
                    out[b, n, :, h] = O / lsafe[:, None]
                    lse[b, n, h] = m + np.log(lsafe)
    assert sorted(seen) == [(b, n) for b in range(B) for n in range(N)]
    return out, lse.reshape(B * N, H, L)


def _emulate_evo_db2(q, k, v, b1, b2, do, lse, delta, scale, splits):
    """The split db2 in numpy f32: per split, the f32 sum over its rows n
    in order of P (dP - delta), P = 2^(x log2 e - lse log2 e) (0 for a
    row whose lse is at the mask level); the splits' partials added in
    split order."""
    B, N, L, H, D = q.shape
    log2e = np.float32(1.4426950408889634)
    lse = lse.reshape(B, N, H, L)
    delta = delta.reshape(B, N, H, L)
    db2 = np.zeros((B, 1, H, L, L), np.float32)
    for b in range(B):
        for h in range(H):
            total = np.zeros((L, L), np.float32)
            for n0, n1 in _split_ranges(N, splits):
                part = np.zeros((L, L), np.float32)
                for n in range(n0, n1):
                    x = _evo_scores(q, k, b1, b2, b, n, h, scale)
                    nl = _neg_lse2(lse[b, n, h])[:, None]
                    p = np.exp2(x * log2e + nl)
                    dp = do[b, n, :, h] @ v[b, n, :, h].T
                    ds = p * (dp - delta[b, n, h][:, None])
                    part = part + ds.astype(np.float32)
                total = total + part
            db2[b, 0, h] = total
    return db2


@pytest.fixture
def _evo_interpret(monkeypatch):
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# the forward's limits (chip_smoke's): out |d| <= 0.02 + 2^-7 |JAX| (the
# emulation rounds P to bf16 before P V as the kernels do, the Pallas
# kernel keeps it f32), lse 1e-3; db2 within 2e-4 of max |JAX| (f32 sums
# of the same terms in another order, as the JAX package's kernel test)
EVO_DB2_REL = 2e-4


@pytest.mark.parametrize("shape,sms", [((1, 7, 96, 2, 32), 132),
                                       ((2, 5, 128, 1, 8), 1)],
                         ids=["L96-d32-rows1", "L128-d8-rows4"])
def test_evoformer_forward_walk_order_matches_the_pallas_kernel(
        _evo_interpret, shape, sms):
    """The row-walking forward's per-row online softmax over 64-key
    tiles (a ragged last tile, masked keys, a row masked everywhere with
    -1e30), emulated in numpy over its plan, against the JAX
    `evoformer_flash_forward` (its Pallas kernel in interpret mode) on
    the same bf16-representable inputs."""
    from deepspeed_tpu.ops import evoformer_flash as jef
    B, N, L, H, D = shape
    q, k, v, _, b1, b2 = _evo_bf16_inputs(B, N, L, H, D, seed=L + D)
    scale = 1.0 / np.sqrt(D)
    rows = tevof.fwd_plan(B, N, L, H, D, torch.bfloat16, sms)
    got, got_lse = _emulate_evo_forward(q, k, v, b1, b2, scale, rows)
    ref, ref_lse = (np.asarray(t) for t in jef.evoformer_flash_forward(
        *(jnp.asarray(a) for a in (q, k, v, b1, b2)), return_lse=True))
    assert (np.abs(got - ref) <= FWD_ATOL + FWD_RTOL * np.abs(ref)).all()
    assert np.abs(got_lse - ref_lse).max() <= FWD_LSE
    assert (got[:, 1] == 0).all() and (got_lse.reshape(B, N, H, L)[:, 1]
                                       <= -1e29).all()


@pytest.mark.parametrize("shape,sms", [((1, 13, 96, 2, 32), 12),
                                       ((1, 9, 128, 2, 8), 4)],
                         ids=["L96-d32-splits3", "L128-d8-splits2"])
def test_evoformer_db2_split_order_matches_the_pallas_kernel(
        _evo_interpret, shape, sms):
    """db2 as the split kernels sum it (f32 partials per split over its
    rows in order, added in split order; a row masked everywhere adds
    nothing), emulated in numpy over `db2_plan`'s splits, against the
    JAX `evoformer_flash_backward`'s db2 (its Pallas kernels in interpret
    mode) on the same inputs and residuals."""
    from deepspeed_tpu.ops import evoformer_flash as jef
    B, N, L, H, D = shape
    q, k, v, do, b1, b2 = _evo_bf16_inputs(B, N, L, H, D, seed=N + D)
    splits = tevof.db2_plan(B, N, L, H, D, torch.bfloat16, sms)
    assert splits > 1
    jargs = [jnp.asarray(a) for a in (q, k, v, b1, b2)]
    out, lse = jef.evoformer_flash_forward(*jargs, return_lse=True)
    ref = np.asarray(jef.evoformer_flash_backward(
        *jargs, out, jnp.asarray(do), lse)[4])
    out, lse = np.asarray(out), np.asarray(lse)
    delta = np.einsum("bnlhd,bnlhd->bnhl", do, out).reshape(B * N, H, L)
    got = _emulate_evo_db2(q, k, v, b1, b2, do, lse, delta,
                           1.0 / np.sqrt(D), splits)
    assert np.abs(got - ref).max() <= EVO_DB2_REL * np.abs(ref).max()
