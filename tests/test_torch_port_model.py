"""The PyTorch port's model code and serving steps against the JAX package.

Parameters come from the JAX model's own initializer and reach the port
through `models.convert.params_from_jax`; every other input (tokens, the
arena's prior contents, block tables) is drawn with numpy from a fixed
seed and handed to both.  Both sides run in f32 on the CPU: the port's
kernels run their plain PyTorch versions there, the JAX serving programs
their CPU paths.  The serving steps are compared on their logits AND on
the arena they leave behind, including the rule that padded rows (chunk
tails past n_valid, inactive rows) leave every arena slot unchanged.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import ragged_ops as jops
from deepspeed_tpu.models import Transformer
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import ragged_ops as tops
from deepspeed_tpu_torch.models import (get_model_config, init_params,
                                        params_from_jax)
from deepspeed_tpu_torch.models import transformer as ttf

pytestmark = pytest.mark.serving

# f32 on both sides, same arithmetic in another summation order (XLA's
# dot vs torch's matmul on the CPU), through 4 layers: logits agree to a
# few 1e-6 (measured); 1e-4 leaves room for the layers' compounding.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# arena rows are one layer's k/v projection of a residual stream that has
# been through at most 3 layers: as tight as the logits
ARENA_TOL = dict(rtol=1e-4, atol=1e-4)
# single elementwise ops (norm, rope, embed lookup): ulp-level
OP_TOL = dict(rtol=1e-6, atol=1e-6)

FAMILIES = ["llama", "gpt2"]
NB, BS, MB = 24, 8, 8


@functools.lru_cache(maxsize=None)
def _params(family, seed=0):
    """(jax cfg, port cfg, JAX params, port params); the tests only read
    them, so each family is built once per process."""
    jcfg = jax_model_config(family, "tiny", dtype=jnp.float32)
    tcfg = get_model_config(family, "tiny", dtype=torch.float32)
    jp = Transformer(jcfg).init_params(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _arena(rng, cfg):
    """Random prior arena contents (numpy), so that a write to a wrong slot
    and a write that should have been dropped both show."""
    shape = (cfg.num_layers, NB, BS, cfg.kv_heads, cfg.head_dim)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _run_jax(fn, jcfg, jp, ak, av, *args):
    arena = {"k": jnp.asarray(ak), "v": jnp.asarray(av)}
    logits, out = fn(jcfg, jp, arena, *(jnp.asarray(a) for a in args))
    return (np.asarray(logits), np.asarray(out["k"]), np.asarray(out["v"]))


def _run_torch(fn, tcfg, tp, ak, av, *args):
    arena = {"k": torch.from_numpy(ak.copy()),
             "v": torch.from_numpy(av.copy())}
    logits, out = fn(tcfg, tp, arena, *args)
    assert out is arena                  # updated in place, same dict back
    return logits.numpy(), out["k"].numpy(), out["v"].numpy()


def _check(jres, tres, ak, av, written):
    """Logits and arena equal; every slot outside `written` (a set of
    (block, offset)) holds its prior contents exactly."""
    np.testing.assert_allclose(tres[0], jres[0], **LOGIT_TOL)
    for t_arena, j_arena, prior in ((tres[1], jres[1], ak),
                                    (tres[2], jres[2], av)):
        np.testing.assert_allclose(t_arena, j_arena, **ARENA_TOL)
        keep = np.ones(prior.shape[1:3], bool)
        for blk, off in written:
            keep[blk, off] = False
        np.testing.assert_array_equal(t_arena[:, keep], prior[:, keep])


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES + ["qwen2"])
def test_params_from_jax_round_trips_keys_and_shapes(family):
    jcfg, tcfg, jp, tp = _params(family)
    host = jax.device_get(jp)
    assert sorted(tp) == sorted(host)
    assert sorted(tp["layers"]) == sorted(host["layers"])
    for key, val in host.items():
        pairs = (val.items() if isinstance(val, dict) else [(None, val)])
        for sub, leaf in pairs:
            got = tp[key][sub] if sub else tp[key]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    # the port's own initializer lays out the same keys and shapes
    mine = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == \
        {k: tuple(v.shape) for k, v in host["layers"].items()}
    assert {k: tuple(v.shape) for k, v in mine.items() if k != "layers"} == \
        {k: tuple(v.shape) for k, v in host.items() if k != "layers"}


def test_params_from_jax_refuses_a_mismatched_config():
    _, _, jp, _ = _params("llama")
    wrong = get_model_config("llama", "tiny", dtype=torch.float32,
                             num_kv_heads=8)
    with pytest.raises(ValueError, match="layers.wk"):
        params_from_jax(jax.device_get(jp), wrong, "cpu")


# ----------------------------------------------------------------------
# layer math
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 64).astype(np.float32) * 3
    scale = rng.randn(64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    want = jtf._norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                     kind, 1e-5)
    got = ttf._norm(torch.from_numpy(x), torch.from_numpy(scale),
                    torch.from_numpy(bias), kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("pct", [1.0, 0.5])
def test_rope_matches_jax(pct):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 32).astype(np.float32)
    pos = rng.randint(0, 4000, size=(2, 7)).astype(np.int32)
    want = jtf._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, pct)
    got = ttf._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, pct)
    # angles up to 4000 rad: sin/cos of a large f32 argument differ by
    # a few ulps of the argument between libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_embed_matches_jax(family):
    jcfg, tcfg, jp, tp = _params(family)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, jcfg.vocab_size, 9).astype(np.int32)
    # positions past max_seq_len clamp (prefill_full's padded bucket)
    pos = np.asarray([0, 1, 5, 100, 511, 512, 700, 3, 2], np.int32)
    want = jops._embed(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    got = tops._embed(tcfg, tp, torch.from_numpy(toks).long(),
                      torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ----------------------------------------------------------------------
# serving steps: logits and the arena they leave
# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_chunks_matches_jax(family):
    """Four chunk slots: two consecutive chunks of one prompt (the second
    with a padded tail), a continuation at pos0 > 0 over keys already in
    the arena, and an inactive slot whose table points at live blocks."""
    jcfg, tcfg, jp, tp = _params(family)
    rng = np.random.RandomState(3)
    ak, av = _arena(rng, jcfg)
    C = 16
    perm = rng.permutation(NB)
    tables = rng.randint(-2, NB + 2, size=(4, MB)).astype(np.int32)
    tables[0, :4] = tables[1, :4] = perm[:4]           # prompt A: 0..26
    tables[2, :4] = perm[4:8]                          # prompt B: 7..22
    tables[3, :4] = perm[:4]                           # inactive, aliases A
    tokens = rng.randint(0, jcfg.vocab_size, size=(4, C)).astype(np.int32)
    pos0s = np.asarray([0, C, 7, 3], np.int32)
    n_valids = np.asarray([C, 11, C, C], np.int32)
    active = np.asarray([True, True, True, False])
    args = (tokens, pos0s, n_valids, tables, active)
    jres = _run_jax(jops.prefill_chunks, jcfg, jp, ak, av, *args)
    tres = _run_torch(tops.prefill_chunks, tcfg, tp, ak, av, *args)
    written = {(tables[i, p // BS], p % BS) for i in range(3)
               for p in range(pos0s[i], pos0s[i] + n_valids[i])}
    assert len(written) == C + 11 + C
    # the inactive slot's logits are meaningless on both sides
    jres = (jres[0][:3],) + jres[1:]
    tres = (tres[0][:3],) + tres[1:]
    _check(jres, tres, ak, av, written)


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_full_matches_jax(family):
    """Fresh prompts of mixed lengths in one padded bucket, plus an
    inactive slot: only each active prompt's own positions are written."""
    jcfg, tcfg, jp, tp = _params(family)
    rng = np.random.RandomState(4)
    ak, av = _arena(rng, jcfg)
    S = 32
    perm = rng.permutation(NB)
    tables = rng.randint(-2, NB + 2, size=(4, MB)).astype(np.int32)
    lens = np.asarray([32, 5, 19, 12], np.int32)
    tables[0, :4], tables[1, :1], tables[2, :3] = perm[:4], perm[4:5], \
        perm[5:8]
    tables[3, :2] = perm[:2]                           # inactive, aliases 0
    tokens = rng.randint(0, jcfg.vocab_size, size=(4, S)).astype(np.int32)
    active = np.asarray([True, True, True, False])
    args = (tokens, lens, tables, active)
    jres = _run_jax(jops.prefill_full, jcfg, jp, ak, av, *args)
    tres = _run_torch(tops.prefill_full, tcfg, tp, ak, av, *args)
    written = {(tables[i, p // BS], p % BS) for i in range(3)
               for p in range(lens[i])}
    jres = (jres[0][:3],) + jres[1:]
    tres = (tres[0][:3],) + tres[1:]
    _check(jres, tres, ak, av, written)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_step_matches_jax(family):
    """Rows at mixed lengths (one at a block boundary) and two inactive
    rows whose tables alias live blocks: inactive rows write nothing."""
    jcfg, tcfg, jp, tp = _params(family)
    rng = np.random.RandomState(5)
    ak, av = _arena(rng, jcfg)
    perm = rng.permutation(NB)
    lens = np.asarray([0, 16, 37, 9, 50, 3], np.int32)
    active = np.asarray([True, True, True, False, True, False])
    tables = rng.randint(-2, NB + 2, size=(6, MB)).astype(np.int32)
    used = 0
    for b in range(6):
        live = lens[b] // BS + 1
        if active[b]:
            tables[b, :live] = perm[used:used + live]
            used += live
        else:
            tables[b, :live] = perm[:live]             # aliases row 0's
    tokens = rng.randint(0, jcfg.vocab_size, 6).astype(np.int32)
    args = (tokens, lens, tables, active)
    jres = _run_jax(jops.decode_step, jcfg, jp, ak, av, *args)
    tres = _run_torch(tops.decode_step, tcfg, tp, ak, av, *args)
    written = {(tables[b, lens[b] // BS], lens[b] % BS) for b in range(6)
               if active[b]}
    keep = active.nonzero()[0]
    jres = (jres[0][keep],) + jres[1:]
    tres = (tres[0][keep],) + tres[1:]
    _check(jres, tres, ak, av, written)
