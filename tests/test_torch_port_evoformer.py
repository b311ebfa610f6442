"""The PyTorch port's Evoformer attention against the JAX package, on the
CPU.

Inputs are drawn with numpy from fixed seeds and fed to both sides; the
port runs its plain versions (CPU tensors), the JAX side its jnp path and
its Pallas kernels in interpret mode (patched as tests/test_evoformer.py
does).  Covered, all in f32:

- the forward: the port's plain path (`_evoformer_plain`) and the forward
  kernel's plain version, out and lse, against JAX `_evoformer_jnp`
  chunked and unchunked, and against the Pallas `evoformer_flash_forward`
  (D 64) and `evoformer_flash_forward_dmajor` (D 32), for every bias
  combination: 2e-5, the same math in another summation order;
- the backward kernels' plain versions against the Pallas
  `evoformer_flash_backward`, every cotangent, b1 partially masked at
  -1e9: 2e-4, as the JAX package's own kernel test;
- `evoformer_attention`'s autograd (the kernel-path Function over the
  plain versions, and the plain path) against `jax.grad` through
  `_evo_kernel_diff` with its Pallas backward and through `_evoformer_jnp`,
  with the biases requiring grad or not (db2 is not computed for a pair
  bias that does not);
- a fully masked row (out 0, finite gradients), bias order, the shape and
  chunk errors, and the impl gate.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.evoformer as jevo
from deepspeed_tpu.ops import evoformer_flash as jef

import deepspeed_tpu_torch.ops.evoformer as tevo
from deepspeed_tpu_torch.ops import evoformer_flash as tef

pytestmark = pytest.mark.kernels

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
WHICH = {"none": (False, False), "b1": (True, False), "b2": (False, True),
         "both": (True, True)}


@pytest.fixture
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl
    import deepspeed_tpu.ops.attention as attention_mod
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(attention_mod, "_on_tpu", lambda: True)


def _inputs(B, N, L, H, D, seed, scale=0.5, mask=False):
    """q, k, v, b1, b2 as numpy f32; with `mask`, b1 is 0 or -1e9 (about
    a fifth of the keys masked)."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * scale).astype(np.float32)
    q, k, v = mk(B, N, L, H, D), mk(B, N, L, H, D), mk(B, N, L, H, D)
    if mask:
        b1 = np.where(rng.rand(B, N, 1, 1, L) > 0.2, 0.0,
                      -1e9).astype(np.float32)
    else:
        b1 = mk(B, N, 1, 1, L)
    return q, k, v, b1, mk(B, 1, H, L, L)


def _pick(arrays, which):
    q, k, v, b1, b2 = arrays
    use1, use2 = WHICH[which]
    return q, k, v, b1 if use1 else None, b2 if use2 else None


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays, grad=()):
    """Tensors of the arrays; those at the indices in `grad` require
    grad."""
    return [None if a is None else
            torch.from_numpy(a).requires_grad_(i in grad)
            for i, a in enumerate(arrays)]


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", list(WHICH))
@pytest.mark.parametrize("chunk", [32, 8], ids=["unchunked", "chunked"])
def test_forward_matches_jax_jnp(which, chunk):
    arrays = _pick(_inputs(2, 3, 32, 4, 8, seed=0), which)
    want, want_lse = jevo._evoformer_jnp(*_jax(arrays), chunk,
                                         return_lse=True)
    t = _torch(arrays)
    for out, lse in (tevo._evoformer_plain(*t, chunk, return_lse=True),
                     tef.evoformer_flash_forward(*t, return_lse=True),
                     tef.evoformer_flash_forward_reference(*t)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   **FWD_TOL)


@pytest.mark.parametrize("which", list(WHICH))
@pytest.mark.parametrize("D", [64, 32], ids=["forward-d64", "dmajor-d32"])
def test_forward_matches_pallas_kernels(_interpret, which, D):
    arrays = _pick(_inputs(1, 2, 64, 2, D, seed=1, scale=1.0), which)
    jfn, tfn = ((jef.evoformer_flash_forward, tef.evoformer_flash_forward)
                if D == 64 else (jef.evoformer_flash_forward_dmajor,
                                 tef.evoformer_flash_forward_dmajor))
    want, want_lse = jfn(*_jax(arrays), return_lse=True)
    out, lse = tfn(*_torch(arrays), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("which", list(WHICH))
def test_backward_plain_versions_match_pallas(_interpret, which):
    arrays = _pick(_inputs(1, 3, 64, 2, 32, seed=5, scale=0.3, mask=True),
                   which)
    rng = np.random.RandomState(6)
    do = rng.randn(*arrays[0].shape).astype(np.float32)
    jq, jk, jv, jb1, jb2 = _jax(arrays)
    jout, jlse = jevo._evoformer_jnp(jq, jk, jv, jb1, jb2, 128,
                                     return_lse=True)
    want = jef.evoformer_flash_backward(jq, jk, jv, jb1, jb2, jout,
                                        jnp.asarray(do), jlse)
    q, k, v, b1, b2 = _torch(arrays)
    out, lse = torch.from_numpy(np.array(jout)), torch.from_numpy(
        np.array(jlse))
    tdo = torch.from_numpy(do)
    got = tef.evoformer_flash_backward(q, k, v, b1, b2, out, tdo, lse)
    ref = tef.evoformer_flash_backward_reference(q, k, v, b1, b2, out, tdo,
                                                 lse)
    for name, w, g, r in zip(("dq", "dk", "dv", "db1", "db2"), want, got,
                             ref):
        assert (w is None) == (g is None) == (r is None), name
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(r.numpy(), np.asarray(w), **BWD_TOL,
                                       err_msg=name)
    # the three kernels' plain versions compose to the same gradients
    dq, delta = tef.evoformer_flash_dq_reference(q, k, v, b1, b2, out, tdo,
                                                 lse)
    np.testing.assert_allclose(
        delta.numpy(), (do * np.asarray(jout)).sum(-1).transpose(
            0, 1, 3, 2).reshape(3, 2, 64), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dq.numpy(), got[0].numpy())


GRAD_CASES = {
    "both-all": ("both", True, True),
    "both-pair-only": ("both", False, True),
    "both-no-bias-grad": ("both", False, False),
    "mask-only": ("b1", True, False),
    "pair-only": ("b2", False, True),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_autograd_matches_jax_grad(_interpret, monkeypatch, case):
    which, g1, g2 = GRAD_CASES[case]
    arrays = _pick(_inputs(1, 3, 64, 2, 32, seed=7, scale=0.3, mask=True),
                   which)
    grad = (0, 1, 2) + ((3,) if g1 else ()) + ((4,) if g2 else ())
    jargs = _jax(arrays)

    def jgrads(fn):
        def loss(*diff):
            a = list(jargs)
            for i, x in zip(grad, diff):
                a[i] = x
            return jnp.sum(fn(*a, 128) ** 2)
        return jax.grad(loss, argnums=tuple(range(len(grad))))(
            *[jargs[i] for i in grad])

    wants = [jgrads(jevo._evo_kernel_diff), jgrads(jevo._evoformer_jnp)]
    db2_calls = []
    db2 = tef.evoformer_flash_db2
    monkeypatch.setattr(tef, "evoformer_flash_db2",
                        lambda *a, **kw: db2_calls.append(1) or db2(*a, **kw))
    for impl in ("auto", "jnp"):
        t = _torch(arrays, grad)
        out = tevo.evoformer_attention(t[0], t[1], t[2], (t[3], t[4]),
                                       impl=impl)
        (out ** 2).sum().backward()
        for want in wants:
            for i, w in zip(grad, want):
                np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(w),
                                           **BWD_TOL, err_msg=f"{impl} {i}")
        for i in (3, 4):
            if t[i] is not None and i not in grad:
                assert t[i].grad is None
    # the kernel path computes db2 only for a pair bias that requires grad
    assert len(db2_calls) == int(g2)


# ----------------------------------------------------------------------
# edge cases and errors
# ----------------------------------------------------------------------
def test_fully_masked_row_zero_output_finite_grads(_interpret):
    q, k, v, _, b2 = _inputs(1, 2, 64, 2, 32, seed=8, scale=1.0)
    b1 = np.zeros((1, 2, 1, 1, 64), np.float32)
    b1[0, 0] = -1e30
    jout = jevo._evoformer_jnp(*_jax((q, k, v, b1, b2)), 128)
    for impl in ("auto", "jnp"):
        t = _torch((q, k, v, b1, b2), grad=(0, 1, 2, 4))
        out = tevo.evoformer_attention(t[0], t[1], t[2], (t[3], t[4]),
                                       impl=impl)
        assert float(out.detach()[0, 0].abs().max()) == 0.0
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   **FWD_TOL)
        (out ** 2).sum().backward()
        for i in (0, 1, 2, 4):
            assert torch.isfinite(t[i].grad).all(), (impl, i)
        assert float(t[0].grad[0, 0].abs().max()) == 0.0, impl
    _, lse = tef.evoformer_flash_forward(*_torch((q, k, v, b1, b2)),
                                         return_lse=True)
    assert torch.isfinite(lse).all() and float(lse[0].max()) <= -1e29


def test_bias_order_free_and_ds4sci_entry():
    q, k, v, b1, b2 = _torch(_inputs(2, 3, 32, 4, 8, seed=2))
    a = tevo.evoformer_attention(q, k, v, [b1, b2])
    b = tevo.evoformer_attention(q, k, v, [b2, b1])
    c = tevo.DS4Sci_EvoformerAttention(q, k, v, [b2, None, b1])
    assert torch.equal(a, b) and torch.equal(a, c)


def test_bad_biases_chunks_and_impls_raise_as_in_jax():
    arrays = _inputs(2, 3, 48, 4, 8, seed=3)
    jq, jk, jv, jb1, jb2 = _jax(arrays)
    q, k, v, b1, b2 = _torch(arrays)
    bad = [
        ((jnp.zeros((2, 3, 48)),), (torch.zeros(2, 3, 48),)),
        ((jb1, jb1), (b1, b1)),
        ((jb2, jb2), (b2, b2)),
        ((jb1, jb2, jb1), (b1, b2, b1)),
    ]
    for jb, tb in bad:
        with pytest.raises(ValueError):
            jevo.evoformer_attention(jq, jk, jv, jb)
        with pytest.raises(ValueError):
            tevo.evoformer_attention(q, k, v, tb)
    # L = 48 > chunk 32 and not a multiple of it
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        jevo.evoformer_attention(jq, jk, jv, (jb1,), chunk_size=32)
    for impl in ("auto", "jnp"):
        with pytest.raises(ValueError, match="multiple of chunk_size"):
            tevo.evoformer_attention(q, k, v, (b1,), chunk_size=32,
                                     impl=impl)
    for impl in ("pallas", "triton"):
        with pytest.raises(ValueError, match="impl"):
            tevo.evoformer_attention(q, k, v, (b1,), impl=impl)
    # L = 48 <= chunk 128: accepted by both
    np.testing.assert_allclose(
        tevo.evoformer_attention(q, k, v, (b1, b2)).numpy(),
        np.asarray(jevo.evoformer_attention(jq, jk, jv, (jb1, jb2))),
        **FWD_TOL)


def test_wrappers_refuse_devices_without_the_kernel():
    meta = torch.empty(1, 2, 16, 2, 8, device="meta")
    rows = torch.empty(2, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no Evoformer attention kernel"):
        tef.evoformer_flash_forward(meta, meta, meta)
    with pytest.raises(ValueError, match="no Evoformer attention kernel"):
        tef.evoformer_flash_backward(meta, meta, meta, None, None, meta,
                                     meta, rows)
    with pytest.raises(ValueError, match="pair bias"):
        tef.evoformer_flash_db2(meta, meta, meta, None, None, meta, rows,
                                rows)
