"""The PyTorch port's multi-LoRA and merged-arena kernels against the JAX
package.

`deepspeed_tpu_torch/ops/lora_matmul.py` and `ops/paged_merged.py` run
their plain PyTorch versions for CPU tensors; here those versions are held
against the JAX functions — the jnp escape and the Pallas kernel in
interpret mode (passed explicitly: the merged and LoRA kernels take their
own `interpret` switch) — on the same inputs drawn with numpy from a fixed
seed, in f32.  The CUDA kernels are checked against the same plain
versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import lora_matmul as jlora
from deepspeed_tpu.ops import paged_merged as jmerged
from deepspeed_tpu_torch.ops import lora_matmul as tlora
from deepspeed_tpu_torch.ops import paged_attention as tdecode
from deepspeed_tpu_torch.ops import paged_merged as tmerged
from deepspeed_tpu_torch.ops import paged_prefill as tprefill

pytestmark = pytest.mark.kernels

# f32 on both sides, same math, another summation order over K (XLA's
# einsum, the Pallas kernel's dot, torch's einsum on the CPU): relative to
# the output's largest magnitude
LORA_REL = 1e-5
# f32 attention, as tests/test_torch_port_kernels.py
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _lora_inputs(S, K, N, r, slots, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(S, K).astype(np.float32)
    a = (rng.randn(slots, K, r) / np.sqrt(K)).astype(np.float32)
    b = rng.randn(slots, r, N).astype(np.float32)
    # unsorted ids with base rows (-1, -3) and an unused slot (slots - 1)
    ids = rng.randint(-1, slots - 1, S).astype(np.int32)
    ids[::7] = -3
    return x, a, b, ids


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ----------------------------------------------------------------------
# gather-LoRA delta
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K,N,r", [(128, 128, 4), (128, 256, 128),
                                   (256, 128, 128), (256, 256, 4)])
def test_lora_delta_matches_jax(K, N, r):
    S, slots = 24, 4
    x, a, b, ids = _lora_inputs(S, K, N, r, slots, seed=K + N + r)
    got = tlora.lora_delta(_t(x), _t(a), _t(b), ids).numpy()
    assert got.dtype == np.float32 and got.shape == (S, N)
    # base rows are exactly 0.0
    assert (got[ids < 0] == 0.0).all() and not np.signbit(got[ids < 0]).any()
    ref = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                      jnp.asarray(b), jnp.asarray(ids),
                                      impl="jnp"))
    assert _rel(got, ref) <= LORA_REL
    kern = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), jnp.asarray(ids),
                                       impl="pallas", interpret=True))
    assert _rel(got, kern) <= LORA_REL
    assert (kern[ids < 0] == 0.0).all()


def test_lora_delta_scaling_rows_and_bf16_rows_match_jax():
    """scaling != 1 multiplies the f32 result once; bf16 rows are widened
    exactly against the f32 factors (the JAX promotion); a `LoraRows`
    gives what its host ids give."""
    x, a, b, ids = _lora_inputs(16, 128, 128, 8, 3, seed=5)
    want = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), jnp.asarray(ids),
                                       scaling=0.25, impl="jnp"))
    got = tlora.lora_delta(_t(x), _t(a), _t(b), tlora.LoraRows(ids),
                           scaling=0.25).numpy()
    assert _rel(got, want) <= LORA_REL
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jlora.lora_delta(xb, jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(ids), impl="jnp"))
    got = tlora.lora_delta(_t(x).to(torch.bfloat16), _t(a), _t(b),
                           ids).numpy()
    assert _rel(got, want) <= LORA_REL


def test_lora_delta_never_multiplies_a_base_row():
    """A NaN in a base row's x stays out of its delta (a masked select,
    not 0 * x), and every-row-base gives all zeros."""
    x, a, b, ids = _lora_inputs(8, 64, 32, 4, 2, seed=6)
    x[ids < 0] = np.nan
    got = tlora.lora_delta(_t(x), _t(a), _t(b), ids).numpy()
    assert (got[ids < 0] == 0.0).all()
    assert np.isfinite(got).all()
    none = tlora.lora_delta(_t(x), _t(a), _t(b), np.full(8, -1)).numpy()
    assert (none == 0.0).all()


def test_lora_shape_helpers():
    # the port pads no rank (no 128-lane tile on the card)
    assert [tlora.pad_lora_rank(r) for r in (1, 16, 128)] == [1, 16, 128]
    with pytest.raises(ValueError):
        tlora.pad_lora_rank(0)
    assert tlora.lora_delta_supported(3, 100, 70, 1)
    assert not tlora.lora_delta_supported(0, 128, 128, 1)
    assert not tlora.lora_delta_supported(8, 128, 128, 0)
    x, a, b, ids = _lora_inputs(4, 8, 8, 2, 2, seed=7)
    with pytest.raises(ValueError, match="disagree"):
        tlora.lora_delta(_t(x), _t(a), _t(b[:, :1]), ids)


# ----------------------------------------------------------------------
# merged-arena attention
# ----------------------------------------------------------------------
def _merged_arena(rng, L, nb, bs, NKV, D):
    return (rng.randn(L, nb, bs, NKV * D).astype(np.float32),
            rng.randn(L, nb, bs, NKV * D).astype(np.float32))


def _tables(rng, B, MB, nb, bs, lens):
    perm = rng.permutation(nb)
    tables = rng.randint(-3, nb + 3, size=(B, MB)).astype(np.int32)
    used = 0
    for i in range(B):
        live = max(int(lens[i]), 0) // bs + 1
        tables[i, :live] = perm[used:used + live]
        used += live
    return tables


@pytest.mark.parametrize("NH", [2, 8], ids=["mha", "gqa"])
def test_merged_decode_matches_jax(NH):
    rng = np.random.RandomState(8)
    L, nb, bs, MB, NKV, D = 2, 16, 8, 6, 2, 64
    lens = np.asarray([0, -1, 47, 5, 20, -4], np.int32)
    q = rng.randn(lens.size, NH, D).astype(np.float32)
    ak, av = _merged_arena(rng, L, nb, bs, NKV, D)
    tables = _tables(rng, lens.size, MB, nb, bs, lens)
    args = (_t(q), _t(ak), _t(av), _t(tables), _t(lens))
    got = tmerged.merged_decode_attention(*args, layer_idx=1).numpy()
    assert (got[lens < 0] == 0).all()
    kern = jmerged.merged_decode_attention(
        jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
        jnp.asarray(tables), jnp.asarray(lens), layer_idx=1, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    # the same bytes through the 5-D wrapper
    five = tdecode.paged_decode_attention(
        args[0], tmerged.as_5d(args[1], D), tmerged.as_5d(args[2], D),
        args[3], args[4], layer_idx=1)
    assert torch.equal(torch.from_numpy(got), five)


@pytest.mark.parametrize("C,pos0,n_valid,window",
                         [(8, 13, 8, None), (32, 21, 19, None),
                          (12, 40, 12, 16)],
                         ids=["c8", "c32-nvalid", "c12-window"])
def test_merged_prefill_matches_jax(C, pos0, n_valid, window):
    rng = np.random.RandomState(9)
    L, nb, bs, MB, NH, NKV, D = 2, 24, 8, 12, 4, 2, 64
    q = rng.randn(C, NH, D).astype(np.float32)
    ak, av = _merged_arena(rng, L, nb, bs, NKV, D)
    table = _tables(rng, 1, MB, nb, bs, [pos0 + n_valid - 1])[0]
    args = (_t(q), _t(ak), _t(av), _t(table), pos0, n_valid)
    got = tmerged.merged_prefill_attention(
        *args, sliding_window=window, layer_idx=0).numpy()[:n_valid]
    kern = jmerged.merged_prefill_attention(
        jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
        jnp.asarray(table), pos0, n_valid, sliding_window=window,
        layer_idx=0, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern)[:n_valid], **TOL)
    five = tprefill.paged_prefill_attention(
        args[0], tmerged.as_5d(args[1], D), tmerged.as_5d(args[2], D),
        *args[3:], sliding_window=window, layer_idx=0)
    assert torch.equal(torch.from_numpy(got), five[:n_valid])


def test_merged_kernels_supported_and_views():
    assert tmerged.merged_kernels_supported(8, 2, 64)
    assert tmerged.merged_kernels_supported(32, 32, 128, op="prefill")
    assert tmerged.merged_kernels_supported(8, 2, 32)
    assert not tmerged.merged_kernels_supported(8, 2, 48)
    # groups above 8 run in passes of 8 heads (Falcon-7B: 71 on one)
    assert tmerged.merged_kernels_supported(32, 2, 64)         # group 16
    assert tmerged.merged_kernels_supported(71, 1, 64)
    assert not tmerged.merged_kernels_supported(8, 3, 64)      # NH % NKV
    assert tmerged.merged_kernels_supported(32, 2, 64, op="prefill")
    arena = torch.zeros(2, 3, 4, 2 * 64)
    view = tmerged.as_5d(arena, 64)
    assert view.shape == (2, 3, 4, 2, 64)
    assert view.data_ptr() == arena.data_ptr()        # no copy
    with pytest.raises(ValueError, match="multiple"):
        tmerged.as_5d(arena, 48)


def test_new_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    x = torch.empty(4, 16, device=meta)
    a = torch.empty(2, 16, 4, device=meta)
    b = torch.empty(2, 4, 8, device=meta)
    with pytest.raises(ValueError, match="no LoRA kernel"):
        tlora.lora_delta(x, a, b, np.zeros(4, np.int32))
    q3 = torch.empty(2, 2, 64, device=meta)
    arena = torch.empty(1, 4, 8, 128, device=meta)
    ints = torch.empty(2, 3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no merged decode kernel"):
        tmerged.merged_decode_attention(q3, arena, arena, ints, ints[:, 0],
                                        layer_idx=0)
    with pytest.raises(ValueError, match="no merged prefill kernel"):
        tmerged.merged_prefill_attention(q3, arena, arena, ints[0], 0, 2,
                                         layer_idx=0)
