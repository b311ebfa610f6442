"""The PyTorch port's attention kernels against the JAX package.

Each port kernel module (`deepspeed_tpu_torch/ops/{flash_attention,
paged_attention,paged_prefill}.py`) runs its plain PyTorch version for CPU
tensors; here that version is held against the JAX reference function and
against the JAX Pallas kernel in interpret mode, on the same inputs drawn
with numpy from a fixed seed, in f32.  The CUDA kernels themselves are
checked against the same plain versions on the card
(tests/test_torch_port_cuda.py and chip_smoke.py).

Also here: the port's isolation from JAX (no module imports `jax` or
`deepspeed_tpu`) and the wrappers' refusal to serve a device they have no
kernel for.
"""
import ast
import functools
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.ops import flash_attention as jflash
from deepspeed_tpu.ops import paged_attention as jdecode
from deepspeed_tpu.ops import paged_prefill as jprefill
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.ops import paged_attention as tdecode
from deepspeed_tpu_torch.ops import paged_prefill as tprefill

pytestmark = pytest.mark.kernels

REPO = pathlib.Path(__file__).resolve().parent.parent

# f32 on both sides, same math, different summation order (XLA's dot vs
# torch's einsum/matmul on the CPU): agreement to ~1e-6; 1e-5 leaves room
# for the softmax's exp.
TOL = dict(rtol=1e-5, atol=1e-5)
# the Pallas flash kernel in interpret mode runs its online softmax over
# key blocks, rescaling the partial sums per block; f32 throughout, but the
# reassociation costs a few ulps more than the dense reference does
FLASH_KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tables(rng, B, MB, nb, bs, lens):
    """Distinct live blocks per row; garbage (negative or past the arena)
    after each row's live blocks."""
    perm = rng.permutation(nb)
    tables = rng.randint(-3, nb + 3, size=(B, MB)).astype(np.int32)
    used = 0
    for b in range(B):
        live = max(int(lens[b]), 0) // bs + 1
        tables[b, :live] = perm[used:used + live]
        used += live
    return tables


# ----------------------------------------------------------------------
# flash forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("NH,NKV", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_flash_matches_jax(NH, NKV):
    rng = np.random.RandomState(0)
    B, S, D = 2, 128, 128
    q = rng.randn(B, S, NH, D).astype(np.float32)
    k = rng.randn(B, S, NKV, D).astype(np.float32)
    v = rng.randn(B, S, NKV, D).astype(np.float32)
    got, lse = tflash.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                      return_lse=True)
    assert got.shape == (B, S, NH, D) and lse.shape == (B, NH, S)
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    kern = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, block_q=64,
                                  block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                               **FLASH_KERNEL_TOL)
    # the model code's entry point is the same function
    np.testing.assert_array_equal(
        tattn.causal_attention(_t(q), _t(k), _t(v)).numpy(), got.numpy())


def test_flash_lse_is_row_logsumexp():
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(1, 37, 2, 64).astype(np.float32))
               for _ in range(3))
    _, lse = tflash.flash_attention(q, k, v, return_lse=True)
    s = torch.einsum("bqnd,bknd->bnqk", q, k) / 8.0
    s = s.masked_fill(~torch.ones(37, 37, dtype=torch.bool).tril(),
                      float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               **TOL)


# ----------------------------------------------------------------------
# paged decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("NH,NKV", [(8, 8), (8, 2)], ids=["mha", "gqa"])
def test_paged_decode_matches_jax(NH, NKV):
    rng = np.random.RandomState(2)
    L, nb, bs, MB, D = 2, 16, 8, 6, 64
    lens = np.asarray([0, -1, 47, 5, 20, -4], np.int32)
    B = lens.size
    q = rng.randn(B, NH, D).astype(np.float32)
    ak = rng.randn(L, nb, bs, NKV, D).astype(np.float32)
    av = rng.randn(L, nb, bs, NKV, D).astype(np.float32)
    tables = _tables(rng, B, MB, nb, bs, lens)
    got = tdecode.paged_decode_attention(_t(q), _t(ak), _t(av), _t(tables),
                                         _t(lens), layer_idx=1).numpy()
    assert (got[lens < 0] == 0).all()
    ref = jdecode.paged_decode_reference(
        jnp.asarray(q), jnp.asarray(ak[1]), jnp.asarray(av[1]),
        jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    kern = jdecode.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
        jnp.asarray(tables), jnp.asarray(lens), layer_idx=1)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


# ----------------------------------------------------------------------
# paged prefill
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "C,NH,NKV,pos0,n_valid,window",
    [(3, 4, 4, 0, 3, None), (8, 4, 2, 13, 8, None), (32, 4, 2, 21, 19, None),
     (32, 4, 4, 40, 32, 16), (8, 8, 2, 5, 8, 4)],
    ids=["c3-mha", "c8-gqa-pos0", "c32-gqa-nvalid", "c32-window",
         "c8-window-gqa"])
def test_paged_prefill_matches_jax(C, NH, NKV, pos0, n_valid, window):
    rng = np.random.RandomState(3)
    L, nb, bs, MB, D = 2, 24, 8, 12, 64
    q = rng.randn(C, NH, D).astype(np.float32)
    ak = rng.randn(L, nb, bs, NKV, D).astype(np.float32)
    av = rng.randn(L, nb, bs, NKV, D).astype(np.float32)
    table = _tables(rng, 1, MB, nb, bs, [pos0 + n_valid - 1])[0]
    got = tprefill.paged_prefill_attention(
        _t(q), _t(ak), _t(av), _t(table), pos0, n_valid,
        sliding_window=window, layer_idx=0).numpy()[:n_valid]
    ref = jprefill.paged_prefill_reference(
        jnp.asarray(q), jnp.asarray(ak[0]), jnp.asarray(av[0]),
        jnp.asarray(table), pos0, n_valid, sliding_window=window)
    np.testing.assert_allclose(got, np.asarray(ref)[:n_valid], **TOL)
    kern = jprefill.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
        jnp.asarray(table), pos0, n_valid, sliding_window=window,
        layer_idx=0)
    np.testing.assert_allclose(got, np.asarray(kern)[:n_valid], **TOL)


# ----------------------------------------------------------------------
# no fallback: a device without a kernel raises
# ----------------------------------------------------------------------
def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    q4 = torch.empty(1, 8, 2, 64, device=meta)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        tflash.flash_attention(q4, q4, q4)
    q3 = torch.empty(2, 2, 64, device=meta)
    arena = torch.empty(1, 4, 8, 2, 64, device=meta)
    ints = torch.empty(2, 3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no paged decode kernel"):
        tdecode.paged_decode_attention(q3, arena, arena, ints, ints[:, 0],
                                       layer_idx=0)
    with pytest.raises(ValueError, match="no paged prefill kernel"):
        tprefill.paged_prefill_attention(q3, arena, arena, ints[0], 0, 2,
                                         layer_idx=0)


# ----------------------------------------------------------------------
# isolation from JAX
# ----------------------------------------------------------------------
def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py"))
    files += sorted(REPO.glob("chip_*.py"))
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), m) for p in files
           for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu")]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch, "
            "deepspeed_tpu_torch.inference.v2, deepspeed_tpu_torch.models, "
            "deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.runtime.optimizers, "
            "deepspeed_tpu_torch.runtime.lr_schedules, "
            "deepspeed_tpu_torch.runtime.activation_checkpointing, "
            "deepspeed_tpu_torch.sequence.tiled, "
            "deepspeed_tpu_torch.config, deepspeed_tpu_torch.utils.tree, "
            "deepspeed_tpu_torch.serving.tenancy, "
            "deepspeed_tpu_torch.ops.lora_matmul, "
            "deepspeed_tpu_torch.ops.paged_merged; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
