"""The PyTorch port's block-sparse attention against the JAX package, on
the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both sides; the
port runs its plain versions (CPU tensors), the JAX side its jnp gather
path and its Pallas kernels in interpret mode.  Covered:

- the layouts of every sparsity config, their gather tables and reverse
  tables: identical to the JAX package's (Variable and BigBird draw from
  Python's `random.Random(0)` in the same order);
- the forward (the plain path of `block_sparse_attention`, which is the
  forward kernel's plain version with P rounded to the input dtype, and
  that plain version itself, with lse) against the JAX jnp path and the
  Pallas kernel, f32, 2e-5: the same math in another summation order;
- the gradients of both port paths (autograd through the plain path, and
  the `torch.autograd.Function` over the kernel wrappers, whose plain
  versions run here) against `jax.grad` through the jnp path and the
  Pallas kernels, 3e-4 as the JAX package's own test; a fully-masked row
  gives finite gradients and exactly 0 for its queries;
- `SparseSelfAttention`'s causal rule and its per-length table cache.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu.ops import sparse_flash as jsf

import deepspeed_tpu_torch.ops.sparse_attention as tsa
from deepspeed_tpu_torch.ops import sparse_flash as tsf

pytestmark = pytest.mark.kernels

S, H, BLOCK = 64, 4, 8
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=3e-4, atol=3e-4)


def _cfgs(mod):
    """The layout cases of tests/test_sparse_attention.py, then the three
    of chip_smoke's phase 10 at its length (4096 tokens, 16 heads)."""
    return [
        ("dense", mod.DenseSparsityConfig(num_heads=H, block=BLOCK), S),
        ("fixed", mod.FixedSparsityConfig(
            num_heads=H, block=BLOCK, num_local_blocks=2,
            num_global_blocks=1, attention="unidirectional"), S),
        ("fixed-bidir-perhead", mod.FixedSparsityConfig(
            num_heads=H, block=BLOCK, num_local_blocks=2,
            num_global_blocks=1, attention="bidirectional",
            different_layout_per_head=True,
            num_different_global_patterns=2), S),
        ("variable", mod.VariableSparsityConfig(
            num_heads=H, block=BLOCK, num_random_blocks=1,
            local_window_blocks=[1, 2], global_block_indices=[0],
            attention="unidirectional"), S),
        ("bigbird", mod.BigBirdSparsityConfig(
            num_heads=H, block=BLOCK, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1), S),
        ("bslongformer", mod.BSLongformerSparsityConfig(
            num_heads=H, block=BLOCK, num_sliding_window_blocks=3,
            global_block_indices=[0]), S),
        ("slidingwindow", mod.LocalSlidingWindowSparsityConfig(
            num_heads=H, block=BLOCK, num_sliding_window_blocks=2), S),
        ("variable-ends", mod.VariableSparsityConfig(
            num_heads=H, block=BLOCK, num_random_blocks=2,
            different_layout_per_head=True, local_window_blocks=[2, 1, 3],
            global_block_indices=[1, 5], global_block_end_indices=[3, 6],
            horizontal_global_attention=True), S),
        ("phase10-fixed16", mod.FixedSparsityConfig(
            num_heads=16, block=16, different_layout_per_head=True,
            num_local_blocks=4, num_global_blocks=1,
            attention="bidirectional", num_different_global_patterns=4),
         4096),
        ("phase10-bigbird64", mod.BigBirdSparsityConfig(num_heads=16,
                                                        block=64), 4096),
        ("phase10-fixed64-causal", mod.FixedSparsityConfig(
            num_heads=16, block=64, num_local_blocks=4,
            attention="unidirectional"), 4096),
    ]


CASES = list(zip(_cfgs(jsa), _cfgs(tsa)))


@pytest.mark.parametrize("jc,tc", CASES, ids=[c[0][0] for c in CASES])
def test_layouts_and_tables_match_jax(jc, tc):
    _, jcfg, seq = jc
    _, tcfg, _ = tc
    jl, tl = jcfg.make_layout(seq), tcfg.make_layout(seq)
    assert np.array_equal(jl, tl)
    jidx, tidx = jsa._layout_to_gather(jl), tsa._layout_to_gather(tl)
    assert tidx.dtype == np.int32 and np.array_equal(jidx, tidx)
    assert np.array_equal(jsf.reverse_gather(jidx), tsf.reverse_gather(tidx))


def test_all_zero_layout_row_is_refused():
    layout = np.zeros((1, 4, 4), bool)
    with pytest.raises(ValueError, match="all-zero"):
        tsa._layout_to_gather(layout)


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
@pytest.fixture
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _qkv(B=2, S=64, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _ragged_layout():
    layout = np.zeros((2, 8, 8), bool)
    for h in range(2):
        for i in range(8):
            layout[h, i, i] = True
    layout[0, 5, 0:4] = True
    return layout


def _fwd_cases():
    return {
        "fixed": (lambda m: m.FixedSparsityConfig(num_heads=2, block=16)
                  .make_layout(64), 16, True),
        "bigbird-perhead": (lambda m: m.BigBirdSparsityConfig(
            num_heads=2, block=8, different_layout_per_head=True,
            num_random_blocks=1).make_layout(64), 8, False),
        "longformer-bidir": (lambda m: m.BSLongformerSparsityConfig(
            num_heads=2, block=8).make_layout(64), 8, False),
        "ragged-rows": (lambda m: _ragged_layout(), 8, True),
    }


@pytest.mark.parametrize("name", list(_fwd_cases()))
def test_forward_matches_jax_jnp_and_pallas(_interpret, name):
    make, block, causal = _fwd_cases()[name]
    layout = make(jsa)
    q, k, v = _qkv()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(jsa.block_sparse_attention(jq, jk, jv, layout, block,
                                                causal=causal, impl="jnp"))
    kidx = jsa._layout_to_gather(layout)
    kern, kern_lse = jsf.block_sparse_flash_attention(
        jq, jk, jv, kidx, block, causal=causal, return_lse=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tsa.block_sparse_attention(tq, tk, tv, make(tsa), block,
                                     causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)
    out, lse = tsf.block_sparse_flash_attention(
        tq, tk, tv, tsa._layout_to_gather(make(tsa)), block, causal=causal,
        return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(kern_lse), **FWD_TOL)


def test_fully_masked_row_outputs_zero_and_finite_lse(_interpret):
    nb, block = 4, 8
    layout = np.zeros((1, nb, nb), bool)
    layout[0, 0, 0] = layout[0, 1, 1] = layout[0, 3, 3] = True
    q, k, v = _qkv(B=1, S=nb * block, H=1)
    kidx = jsa._layout_to_gather(layout)
    jout, jlse = jsf.block_sparse_flash_attention(
        *map(jnp.asarray, (q, k, v)), kidx, block, return_lse=True)
    out, lse = tsf.block_sparse_flash_attention(
        *map(torch.from_numpy, (q, k, v)), kidx, block, return_lse=True)
    assert (out[0, 2 * block:3 * block] == 0).all()
    assert torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6)
    plain = tsa.block_sparse_attention(*map(torch.from_numpy, (q, k, v)),
                                       layout, block)
    assert (plain[0, 2 * block:3 * block] == 0).all()


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
def _kernel_path(q, k, v, layout, block, causal):
    """The port's kernel-path autograd Function (its wrappers run their
    plain versions on these CPU tensors)."""
    kidx = tsa._layout_to_gather(layout)
    return tsa._SparseFlash.apply(q, k, v, tsa._device_tables(kidx, "cpu"),
                                  block, causal, 1.0 / np.sqrt(q.shape[-1]))


BWD_CASES = {
    "bigbird-perhead": (lambda m: m.BigBirdSparsityConfig(
        num_heads=2, block=8, different_layout_per_head=True,
        num_random_blocks=1).make_layout(64), False),
    "fixed-causal": (lambda m: m.FixedSparsityConfig(
        num_heads=2, block=16).make_layout(64), True),
    "longformer-bidir": (lambda m: m.BSLongformerSparsityConfig(
        num_heads=2, block=8).make_layout(64), False),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_gradients_match_jax(_interpret, monkeypatch, name):
    make, causal = BWD_CASES[name]
    monkeypatch.setattr(jsa, "_use_sparse_kernel",
                        lambda impl, block, D: impl != "jnp")
    layout = make(jsa)
    block = 64 // layout.shape[1]
    q, k, v = _qkv(S=64, H=2, D=64, seed=3)

    def jloss(impl):
        def f(q_, k_, v_):
            return jnp.sum(jsa.block_sparse_attention(
                q_, k_, v_, layout, block, causal=causal, impl=impl) ** 2)
        return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    want = {"jnp": jloss("jnp"), "pallas": jloss("auto")}
    for path in ("plain", "kernel"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if path == "plain":
            out = tsa.block_sparse_attention(*ts, make(tsa), block,
                                             causal=causal)
        else:
            out = _kernel_path(*ts, make(tsa), block, causal)
        (out ** 2).sum().backward()
        for ref in want.values():
            for t, r in zip(ts, ref):
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                           **BWD_TOL)


def test_fully_masked_row_gradients_are_finite_and_zero():
    nb, block = 4, 16
    layout = np.zeros((1, nb, nb), bool)
    layout[0, 0, 0] = layout[0, 1, 1] = layout[0, 3, 3] = True
    q, k, v = _qkv(B=1, S=nb * block, H=1)
    for path in ("plain", "kernel"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if path == "plain":
            out = tsa.block_sparse_attention(*ts, layout, block)
        else:
            out = _kernel_path(*ts, layout, block, True)
        (out ** 2).sum().backward()
        for t in ts:
            assert torch.isfinite(t.grad).all(), path
        assert (ts[0].grad[0, 2 * block:3 * block] == 0).all(), path


# ----------------------------------------------------------------------
# the module
# ----------------------------------------------------------------------
@pytest.mark.parametrize("attention,causal_arg", [
    ("unidirectional", None), ("bidirectional", None),
    ("unidirectional", False), ("bidirectional", True)])
def test_causal_rule_matches_jax(attention, causal_arg):
    def make(mod):
        return mod.SparseSelfAttention(mod.FixedSparsityConfig(
            num_heads=H, block=BLOCK, num_local_blocks=2,
            attention=attention), causal=causal_arg)
    assert make(tsa).causal == make(jsa).causal
    for cfg_cls in ("DenseSparsityConfig", "LocalSlidingWindowSparsityConfig"):
        j = jsa.SparseSelfAttention(getattr(jsa, cfg_cls)(num_heads=H))
        t = tsa.SparseSelfAttention(getattr(tsa, cfg_cls)(num_heads=H))
        assert t.causal == j.causal


def test_module_matches_jax_and_caches_its_tables():
    q, k, v = _qkv(B=2, S=S, H=H, D=16, seed=1)

    def make(mod):
        return mod.SparseSelfAttention(mod.FixedSparsityConfig(
            num_heads=H, block=BLOCK, num_local_blocks=2,
            attention="unidirectional"))
    want = np.asarray(make(jsa)(*map(jnp.asarray, (q, k, v))))
    attn = make(tsa)
    got = attn(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    kidx, (idx, rev) = attn.tables(S, "cpu")
    again = attn.tables(S, "cpu")
    assert again[0] is kidx and again[1][0] is idx and again[1][1] is rev
    assert idx.dtype == torch.int32 and rev.dtype == torch.int32
    assert attn.layout(S) is attn.layout(S)


def test_gate_and_wrappers_refuse_what_they_do_not_take():
    # "auto" sends every CUDA tensor to the kernels, whatever its block or
    # head dim (the wrappers raise on what they do not take)
    assert tsa._use_sparse_kernel("auto", "cuda")
    assert not tsa._use_sparse_kernel("jnp", "cuda")
    assert not tsa._use_sparse_kernel("auto", "cpu")
    with pytest.raises(ValueError, match="impl"):
        tsa._use_sparse_kernel("pallas", "cpu")
    meta = torch.empty(1, 32, 2, 64, device="meta")
    idx = np.zeros((2, 2, 1), np.int32)
    with pytest.raises(ValueError, match="no block-sparse attention kernel"):
        tsf.block_sparse_flash_attention(meta, meta, meta, idx, 16)
    lse = torch.empty(1, 2, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no block-sparse attention kernel"):
        tsf.block_sparse_flash_backward(meta, meta, meta, idx, idx, meta,
                                        meta, lse, 16)
