"""The port's mistral, bloom, falcon, opt, phi, phi3 and gptneox serving,
and qwen2's per-layer windows, against the JAX package on the CPU.

- The engine of each tiny preset against the JAX engine: both built from
  the same parameters (the JAX initializer's, converted with
  `models.params_from_jax`), f32, fed the same numpy-drawn prompts through
  put -> step -> `decode_burst_step` (8 greedy tokens) ->
  `decode_multi_step(k=4)`.  Windows of 16 keys at block size 8 make
  rows cross them mid-block.  Logits within the engine tests' 1e-4,
  tokens equal, arenas allclose.  Also the merged arena, and LoRA
  adapter rows beside base rows.  Head dims 80 and 96: phi (80, 32
  rotated dims), Phi-3 (96) with longrope over an original context of
  32 tokens (prompts on both sides of it, a decode that crosses it, rows
  of both bands in one batch) and with a window, GPT-NeoX (96, 24 rotated
  dims) with its parallel and sequential blocks.
- The plain versions of the paged decode and prefill kernels (which the
  wrappers run for CPU tensors) with a window, ALiBi and a group of 12 q
  heads on one kv head: against the JAX Pallas prefill kernel in
  interpret mode where it takes the case (a window), and against a numpy
  softmax from first principles where it does not (ALiBi).
- The plain paged decode and prefill and the plain flash forward at head
  dims 80 and 96 against the JAX functions the reference runs there (its
  plain paged and attention references) and a numpy softmax.
- The plain `Transformer` forward of each preset against the JAX
  `Transformer`'s.
- The MoE architectures by their registry names (mixtral, qwen2_moe,
  qwen_v2_moe) serve and match the JAX engine (tests/
  test_torch_port_moe.py holds the rest of MoE serving).
- What stays refused, by name: tensor parallelism with each new block
  feature, training with each (and at head dims 80 and 96).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.models import Transformer as JaxTransformer
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.ops import paged_attention as jdecode
from deepspeed_tpu.ops import paged_prefill as jprefill
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.inference.v2.engine_v2 import LayoutNotCarried
from deepspeed_tpu_torch.models import (Transformer, get_model_config,
                                        params_from_jax)
from deepspeed_tpu_torch.models.transformer import (alibi_slopes,
                                                    layer_windows,
                                                    training_refusal)
from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.ops import paged_attention as tdecode
from deepspeed_tpu_torch.ops import paged_merged as tmerged
from deepspeed_tpu_torch.ops import paged_prefill as tprefill

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=16,
                 max_seqs=8, prefill_chunk_size=16,
                 max_prefill_tokens_per_step=32)
# 50 > the 32-token budget: that prompt is prefilled in chunks over steps
PROMPT_LENS = (5, 13, 29, 50)
# the engine tests' bound (tests/test_torch_port_engine.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# Phi-3-mini-128k's longrope at head dim 96 over an original context of 32
# tokens: 48 factors a band, rising from 1.0 as the published lists do,
# and the attention factor HF derives for a 4x context
LONGROPE_96 = ("longrope", float(np.sqrt(1 + np.log(4.0) / np.log(32.0))),
               32.0, tuple(1.0 + 0.02 * i for i in range(48)),
               tuple(1.0 + 0.25 * i for i in range(48)))
# (family, preset overrides): windows of 16 keys at block 8; the
# OPT-350m block (post-norm, a 128-wide embedding projected in and out,
# no final norm); qwen2 with full and windowed layers interleaved; head
# dims 80 (phi) and 96 (phi3, gptneox)
ARCHS = {
    "mistral": ("mistral", dict(sliding_window=16)),
    "bloom": ("bloom", {}),
    "falcon": ("falcon", {}),
    "falcon_alibi": ("falcon", dict(pos_emb="alibi", alibi_scaled=True)),
    "opt": ("opt", {}),
    "opt_350m_style": ("opt", dict(post_norm=True, final_norm=False,
                                   embed_proj_dim=128)),
    "qwen2_windows": ("qwen2", dict(vocab_size=2048,
                                    sliding_window_layers=(0, 16, 0, 16))),
    "llama_yarn": ("llama", dict(rope_scaling=(
        "yarn", 4.0, 0.1 * float(np.log(4.0)) + 1.0, 32.0, 1.0, 64.0))),
    "phi_d80": ("phi", dict(hidden_size=160, num_heads=2)),
    "phi3_longrope_d96": ("phi3", dict(hidden_size=384, num_heads=4,
                                       num_kv_heads=2,
                                       rope_scaling=LONGROPE_96)),
    "phi3_window_d96": ("phi3", dict(hidden_size=192, num_heads=2,
                                     num_kv_heads=2, sliding_window=16)),
    "gptneox_d96": ("gptneox", dict(hidden_size=192, num_heads=2)),
    "gptneox_sequential_d96": ("gptneox", dict(hidden_size=192, num_heads=2,
                                               parallel_residual=False)),
}


def _engines(name, **engine_kw):
    family, kw = ARCHS[name]
    ekw = dict(ENGINE_KW, **engine_kw)
    je = jax_build_engine(family, "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**ekw), **kw)
    te = build_engine(family, "tiny", params=jax.device_get(je.params),
                      engine_config=RaggedInferenceEngineConfig(**ekw),
                      device="cpu", dtype=torch.float32, **kw)
    return je, te


def _prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _same(out_j, out_t):
    assert sorted(out_t) == sorted(out_j)
    for u in out_j:
        np.testing.assert_allclose(out_t[u], out_j[u], **LOGIT_TOL)


def _same_state(je, te):
    assert sorted(te.state.seqs) == sorted(je.state.seqs)
    for uid, d in je.state.seqs.items():
        t = te.state.seqs[uid]
        assert t.blocks == d.blocks
        assert t.seen_tokens == d.seen_tokens
        assert list(t.generated) == list(d.generated)
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]


def _same_arena(je, te):
    """Every leased slot of the arena alike (layouts may differ: the JAX
    engine can merge kv heads into the minor dim; the bytes agree)."""
    bs = ENGINE_KW["block_size"]
    for name in ("k", "v"):
        ja = np.asarray(je.arena[name])
        ta = te.arena[name].numpy()
        ja = ja.reshape(ja.shape[:3] + (-1,))
        ta = ta.reshape(ta.shape[:3] + (-1,))
        for d in te.state.seqs.values():
            for pos in range(d.seen_tokens):
                blk = d.blocks[pos // bs]
                np.testing.assert_allclose(ta[:, blk, pos % bs],
                                           ja[:, blk, pos % bs],
                                           **LOGIT_TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_engine_matches_jax(name):
    """put -> step (chunked and, for the rope/learned pre-norm presets,
    full-prompt prefill) -> one decode step -> an 8-token greedy burst ->
    a k=4 greedy group: logits, tokens, state and arenas alike."""
    je, te = _engines(name)
    assert te._use_prefill_full == je._use_prefill_full
    prompts = _prompts(te.cfg.vocab_size)
    uids = list(range(len(prompts)))
    _same(je.put(uids, prompts), te.put(uids, prompts))
    while any(je.query(u) is None for u in uids):
        _same(je.step(), te.step())
    nxt = [np.asarray([int(np.argmax(je.query(u)))], np.int32)
           for u in uids]
    _same(je.put(uids, nxt), te.put(uids, nxt))
    for u in uids:
        first = int(np.argmax(je.query(u)))
        je.state.seqs[u].generated.append(first)
        te.state.seqs[u].generated.append(first)
    _same_state(je, te)

    want = je.decode_burst_step(uids=uids, n_steps=8)
    got = te.decode_burst_step(uids=uids, n_steps=8)
    assert sorted(got) == sorted(want)
    for u in uids:
        assert np.asarray(got[u]).tolist() == np.asarray(want[u]).tolist()
    _same_state(je, te)
    want = je.decode_multi_step(uids=uids, k=4)
    got = te.decode_multi_step(uids=uids, k=4)
    for u in uids:
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    _same_state(je, te)
    _same_arena(je, te)
    # the rows crossed their windows mid-block
    windows = [w for w in layer_windows(te.cfg) if w]
    if windows:
        assert max(d.seen_tokens for d in te.state.seqs.values()) > \
            2 * max(windows) + 1
    # longrope: prompts on both sides of the original context, and a row
    # whose decode crossed it (its band switched mid-sequence)
    scaling = te.cfg.rope_scaling
    if scaling is not None and scaling[0] == "longrope":
        orig = scaling[2]
        assert min(PROMPT_LENS) < orig < max(PROMPT_LENS)
        assert any(len(d.prompt) < orig < d.seen_tokens
                   for d in te.state.seqs.values())
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert te.free_blocks == je.free_blocks == ENGINE_KW["num_blocks"]
    te.audit_blocks()


def test_merged_arena_engine_matches_the_5d_engine():
    """The merged [L, nb, bs, NKV*D] arena with a window and ALiBi: the
    merged wrappers' plain versions give the 5-D engine's logits."""
    for name in ("mistral", "falcon_alibi"):
        family, kw = ARCHS[name]
        je, five = _engines(name)
        merged = build_engine(family, "tiny", params=jax.device_get(
            je.params), engine_config=RaggedInferenceEngineConfig(
                arena_merged=True, **ENGINE_KW), device="cpu",
            dtype=torch.float32, **kw)
        assert merged.arena["k"].dim() == 4
        prompts = _prompts(five.cfg.vocab_size)
        uids = list(range(len(prompts)))
        _same(five.put(uids, prompts), merged.put(uids, prompts))
        while any(five.query(u) is None for u in uids):
            _same(five.step(), merged.step())


@pytest.mark.parametrize("name", ["mistral", "falcon_alibi",
                                  "opt_350m_style"])
def test_lora_rows_match_jax(name):
    """Adapter rows beside a base row (rank 4 over the attention output,
    one adapter pool each): put/step logits and a greedy generate_batch
    as the JAX engine's."""
    from deepspeed_tpu.serving.tenancy import AdapterPool as JaxPool
    from deepspeed_tpu_torch.serving.tenancy import AdapterPool
    je, te = _engines(name)
    cfg = te.cfg
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size
    pools = (JaxPool(je, 3 * L), AdapterPool(te, 3 * L))
    for p in pools:
        for i in range(2):
            r = np.random.RandomState(10 + i)
            p.register(f"lx{i}", (r.randn(L, K, 4) / np.sqrt(K)).astype(
                np.float32), r.randn(L, 4, H).astype(np.float32))
    prompts = _prompts(cfg.vocab_size)
    plan = ["lx0", None, "lx1", "lx0"]
    uids = list(range(len(prompts)))
    for pool, eng in zip(pools, (je, te)):
        for u, aid in zip(uids, plan):
            if aid is not None:
                eng.set_adapter(u, pool.reserve(aid))
    _same(je.put(uids, prompts), te.put(uids, prompts))
    while any(je.query(u) is None for u in uids):
        _same(je.step(), te.step())
    for u in uids:
        je.flush(u)
        te.flush(u)
    for pool, eng in zip(pools, (je, te)):
        for u, aid in zip(uids, plan):
            if aid is not None:
                pool.release(aid)
                eng.set_adapter(u, pool.reserve(aid))
    want = je.generate_batch(prompts, max_new_tokens=6)
    got = te.generate_batch(prompts, max_new_tokens=6)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


# ----------------------------------------------------------------------
# the kernels' plain versions: window, ALiBi, a group of 12 on one kv head
# ----------------------------------------------------------------------
def _numpy_attention(q, k, v, q_pos, k_pos, slopes=None, window=None):
    """First-principles softmax attention in float64: q [Q, NH, D], k/v
    [K, NKV, D] at positions q_pos [Q] / k_pos [K]; ALiBi bias
    -slope (q_pos - k_pos); causal and window masks."""
    NH, NKV = q.shape[1], k.shape[1]
    k = np.repeat(k, NH // NKV, axis=1).astype(np.float64)
    v = np.repeat(v, NH // NKV, axis=1).astype(np.float64)
    s = np.einsum("qnd,knd->nqk", q.astype(np.float64), k) / np.sqrt(
        q.shape[-1])
    dist = q_pos[:, None] - k_pos[None, :]
    if slopes is not None:
        s = s - slopes[:, None, None].astype(np.float64) * dist[None]
    keep = dist >= 0
    if window is not None:
        keep &= dist < window
    s = np.where(keep[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("nqk,knd->qnd", p, v)


def _paged(rng, nb, bs, NKV, D):
    ak = rng.randn(nb, bs, NKV, D).astype(np.float32)
    av = rng.randn(nb, bs, NKV, D).astype(np.float32)
    return ak, av


@pytest.mark.parametrize("window,alibi", [(None, "bloom"), (16, None),
                                          (16, "falcon"), (1, "bloom"),
                                          (100, None)])
def test_plain_decode_window_alibi_group12(window, alibi):
    """Decode over a shuffled table at bs 16, 12 q heads on one kv head,
    rows before, inside and past the window, an inactive row."""
    rng = np.random.RandomState(7)
    NH, NKV, D, bs, nb = 12, 1, 32, 16, 40
    lens = np.asarray([5, 15, 16, 300, -1, 129], np.int32)
    B, MB = lens.size, 24
    ak, av = _paged(rng, nb, bs, NKV, D)
    q = rng.randn(B, NH, D).astype(np.float32)
    tables = np.stack([rng.permutation(nb)[:MB] for _ in range(B)]).astype(
        np.int32)
    slopes = _slopes(NH, D, alibi)
    got = tdecode.paged_decode_attention(
        *map(torch.from_numpy, (q, ak, av, tables, lens)),
        sliding_window=window,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    for b in range(B):
        if lens[b] < 0:
            assert not got[b].any()
            continue
        n = lens[b] + 1
        kk = ak[tables[b]].reshape(-1, NKV, D)[:n]
        vv = av[tables[b]].reshape(-1, NKV, D)[:n]
        want = _numpy_attention(q[b:b + 1], kk, vv, np.asarray([lens[b]]),
                                np.arange(n), slopes, window)
        np.testing.assert_allclose(got[b].numpy(), want[0], **KERNEL_TOL)
    # the merged view's plain version is the same function
    mk, mv = (torch.from_numpy(a.reshape(nb, bs, NKV * D)) for a in (ak, av))
    merged = tmerged.merged_decode_attention(
        torch.from_numpy(q), mk, mv, torch.from_numpy(tables),
        torch.from_numpy(lens), sliding_window=window,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    assert torch.equal(merged, got)


def _slopes(NH, D, alibi):
    if alibi is None:
        return None
    cfg = get_model_config("bloom", "tiny", hidden_size=NH * D,
                           num_heads=NH, alibi_scaled=alibi == "falcon")
    return alibi_slopes(cfg)


@pytest.mark.parametrize("pos0,n_valid,window,alibi", [
    (0, 40, None, "bloom"), (37, 27, 16, "falcon"), (100, 64, 1, None),
    (5, 11, 100, "bloom"), (200, 48, 16, None)])
def test_plain_prefill_window_alibi_group12(pos0, n_valid, window, alibi):
    """Prefill chunks at bs 16, 12 q heads on one kv head: against numpy
    from first principles, and against the JAX Pallas kernel (interpret
    mode) where it takes the case — windows without ALiBi."""
    rng = np.random.RandomState(pos0 + n_valid)
    NH, NKV, D, bs, nb, C = 12, 1, 32, 16, 24, 64
    ak, av = _paged(rng, nb, bs, NKV, D)
    q = rng.randn(C, NH, D).astype(np.float32)
    table = rng.permutation(nb)[:20].astype(np.int32)
    slopes = _slopes(NH, D, alibi)
    got = tprefill.paged_prefill_attention(
        *map(torch.from_numpy, (q, ak, av, table)), pos0, n_valid,
        sliding_window=window,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    got = got.numpy()[:n_valid]
    n_keys = pos0 + n_valid
    kk = ak[table].reshape(-1, NKV, D)[:n_keys]
    vv = av[table].reshape(-1, NKV, D)[:n_keys]
    want = _numpy_attention(q[:n_valid], kk, vv, pos0 + np.arange(n_valid),
                            np.arange(n_keys), slopes, window)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    if alibi is None:
        import jax.experimental.pallas as pl
        from deepspeed_tpu.ops import paged_prefill as jpp
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call",
                       functools.partial(pl.pallas_call, interpret=True))
            jax_out = np.asarray(jpp.paged_prefill_attention(
                *map(jnp.asarray, (q, ak, av, table)), pos0, n_valid,
                sliding_window=window))
        np.testing.assert_allclose(got, jax_out[:n_valid], **KERNEL_TOL)


def test_decode_work_list_starts_at_the_window():
    """The TMA kernel's work list walks a windowed row from the window's
    first key tile, covers the window's keys once, and splits a group of
    71 into 9 passes of the kv head."""
    lens = [4599, 4700, 100, -1]
    full = tdecode.decode_work(lens, 8, 128, 64, 132)
    win = tdecode.decode_work(lens, 8, 128, 64, 132, window=4096)
    assert sum(win.tiles_per_cta) < sum(full.tiles_per_cta)
    for (b, unit), segs in win.segments.items():
        k_lo = tdecode.window_tiles(lens[b], 4096)[0]
        assert segs[0][0] == k_lo // 64 * 64
        assert segs[-1][1] == lens[b] + 1
        assert all(a[1] == c[0] for a, c in zip(segs, segs[1:]))
    assert tdecode.group_passes(71) == (8, 9)
    assert tdecode.group_passes(4) == (4, 1)
    falcon = tdecode.decode_work([300, 5], 1, 32, 64, 16, G=71)
    assert sorted({u for _, u in falcon.segments}) == list(range(9))
    assert tdecode.decode_variant(torch.bfloat16, 64, 64, 71) == "tma"


# ----------------------------------------------------------------------
# head dims 80 and 96: the plain paged and flash versions against JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("NH,NKV", [(4, 4), (8, 2), (8, 1)])
def test_plain_decode_head_dims_80_96(D, NH, NKV):
    """The decode plain version at D 80 / 96 (groups 1, 4, 8) against the
    JAX reference's plain decode and a numpy softmax, the merged view
    equal to it."""
    rng = np.random.RandomState(D + NH)
    bs, nb = 16, 40
    lens = np.asarray([5, 15, 16, 300, -1, 129], np.int32)
    B, MB = lens.size, 24
    ak, av = _paged(rng, nb, bs, NKV, D)
    q = rng.randn(B, NH, D).astype(np.float32)
    tables = np.stack([rng.permutation(nb)[:MB] for _ in range(B)]).astype(
        np.int32)
    got = tdecode.paged_decode_attention(
        *map(torch.from_numpy, (q, ak, av, tables, lens)))
    want = np.asarray(jdecode.paged_decode_reference(
        *map(jnp.asarray, (q, ak, av, tables, lens))))
    live = lens >= 0
    np.testing.assert_allclose(got.numpy()[live], want[live], **KERNEL_TOL)
    assert not got[~torch.from_numpy(live)].any()
    for b in np.flatnonzero(live):
        n = lens[b] + 1
        kk = ak[tables[b]].reshape(-1, NKV, D)[:n]
        vv = av[tables[b]].reshape(-1, NKV, D)[:n]
        ref = _numpy_attention(q[b:b + 1], kk, vv, np.asarray([lens[b]]),
                               np.arange(n))
        np.testing.assert_allclose(got[b].numpy(), ref[0], **KERNEL_TOL)
    mk, mv = (torch.from_numpy(a.reshape(nb, bs, NKV * D)) for a in (ak, av))
    merged = tmerged.merged_decode_attention(
        torch.from_numpy(q), mk, mv, torch.from_numpy(tables),
        torch.from_numpy(lens))
    assert torch.equal(merged, got)
    assert tmerged.merged_kernels_supported(NH, NKV, D)
    assert tdecode.decode_variant(torch.bfloat16, D, 64, NH // NKV) == "tma"
    assert tdecode.library(D) == "paged_decode_wide"


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("pos0,n_valid,window", [(0, 40, None),
                                                  (37, 27, 16),
                                                  (100, 64, None)])
def test_plain_prefill_head_dims_80_96(D, pos0, n_valid, window):
    """The prefill plain version at D 80 / 96 (a group of 4) against the
    JAX reference's plain prefill and a numpy softmax."""
    rng = np.random.RandomState(D + pos0)
    NH, NKV, bs, nb, C = 8, 2, 16, 24, 64
    ak, av = _paged(rng, nb, bs, NKV, D)
    q = rng.randn(C, NH, D).astype(np.float32)
    table = rng.permutation(nb)[:20].astype(np.int32)
    got = tprefill.paged_prefill_attention(
        *map(torch.from_numpy, (q, ak, av, table)), pos0, n_valid,
        sliding_window=window).numpy()[:n_valid]
    want = np.asarray(jprefill.paged_prefill_reference(
        *map(jnp.asarray, (q, ak, av, table)), pos0, n_valid,
        sliding_window=window))[:n_valid]
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    n_keys = pos0 + n_valid
    kk = ak[table].reshape(-1, NKV, D)[:n_keys]
    vv = av[table].reshape(-1, NKV, D)[:n_keys]
    ref = _numpy_attention(q[:n_valid], kk, vv, pos0 + np.arange(n_valid),
                           np.arange(n_keys), None, window)
    np.testing.assert_allclose(got, ref, **KERNEL_TOL)
    assert tprefill.prefill_variant(torch.bfloat16, D, 64) == "tma"


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("NH,NKV", [(4, 4), (8, 2)])
def test_plain_flash_forward_head_dims_80_96(D, NH, NKV):
    """The flash forward's plain version at D 80 / 96 (the card's kernel
    takes them in bf16 and f32; its backward does not) against the JAX
    attention reference and a numpy softmax."""
    rng = np.random.RandomState(D * NH)
    B, S = 2, 37
    q = rng.randn(B, S, NH, D).astype(np.float32)
    k = rng.randn(B, S, NKV, D).astype(np.float32)
    v = rng.randn(B, S, NKV, D).astype(np.float32)
    out, lse = tflash.flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), causal=True)
    want = np.asarray(jattn.attention_reference(
        *map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(out.numpy(), want, **KERNEL_TOL)
    for b in range(B):
        ref = _numpy_attention(q[b], k[b], v[b], np.arange(S), np.arange(S))
        np.testing.assert_allclose(out[b].numpy(), ref, **KERNEL_TOL)
    assert lse.shape == (B, NH, S)
    assert D in tflash.HEAD_DIMS and D not in tflash.BWD_HEAD_DIMS


# ----------------------------------------------------------------------
# the plain Transformer forward against JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_plain_forward_matches_jax(name):
    family, kw = ARCHS[name]
    jcfg = jax_model_config(family, "tiny", dtype=jnp.float32, **kw)
    jmodel = JaxTransformer(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    cfg = get_model_config(family, "tiny", dtype=torch.float32, **kw)
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 40))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(ids, jnp.int32)))
    got = Transformer(cfg).forward(params, torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)


# ----------------------------------------------------------------------
# refusals by name
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral", "qwen2_moe", "qwen_v2_moe"])
def test_moe_architectures_serve_and_match_jax(arch):
    """The registry's MoE names build on both sides from the same
    parameters: put/step prefill, a decode step, an 8-token greedy burst
    and a k=4 greedy group give the JAX engine's logits and tokens."""
    ekw = dict(ENGINE_KW, max_seqs=4)
    je = jax_build_engine(arch, "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**ekw))
    te = build_engine(arch, "tiny", params=jax.device_get(je.params),
                      engine_config=RaggedInferenceEngineConfig(**ekw),
                      device="cpu", dtype=torch.float32)
    assert te.cfg.moe_experts > 1 and te.supports_moe
    prompts = _prompts(te.cfg.vocab_size)
    uids = list(range(len(prompts)))
    _same(je.put(uids, prompts), te.put(uids, prompts))
    while any(je.query(u) is None for u in uids):
        _same(je.step(), te.step())
    for u in uids:
        first = int(np.argmax(je.query(u)))
        je.state.seqs[u].generated.append(first)
        te.state.seqs[u].generated.append(first)
    _same(je.step(), te.step())
    for u in uids:
        first = int(np.argmax(je.query(u)))
        je.state.seqs[u].generated.append(first)
        te.state.seqs[u].generated.append(first)
    want = je.decode_burst_step(uids=uids, n_steps=8)
    got = te.decode_burst_step(uids=uids, n_steps=8)
    for u in uids:
        assert np.asarray(got[u]).tolist() == np.asarray(want[u]).tolist()
    want = je.decode_multi_step(uids=uids, k=4)
    got = te.decode_multi_step(uids=uids, k=4)
    for u in uids:
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    _same_state(je, te)


def test_training_takes_rope_scaling():
    """Training with scaled RoPE at a head dim the flash backward takes
    is carried (`_rope` is plain PyTorch on both sides): `initialize`
    builds the engine, and a step's loss equals the JAX model's."""
    family, kw = ARCHS["llama_yarn"]
    cfg = get_model_config(family, "tiny", dtype=torch.float32, **kw)
    assert training_refusal(cfg) is None
    jcfg = jax_model_config(family, "tiny", dtype=jnp.float32, **kw)
    jmodel = JaxTransformer(jcfg)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(2)))
    ids = np.random.RandomState(9).randint(0, cfg.vocab_size, (2, 40))
    want, _ = jmodel.loss_fn(jparams, {"input_ids": jnp.asarray(
        ids, jnp.int32)})
    eng = initialize(model=Transformer(cfg),
                     params=params_from_jax(jparams, cfg, "cpu"),
                     config={"train_micro_batch_size_per_gpu": 2},
                     device="cpu")
    got, _ = Transformer(cfg).loss_fn(eng.params, {
        "input_ids": torch.from_numpy(ids)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name,match", [
    ("mistral", "sliding windows"), ("qwen2_windows", "sliding windows"),
    ("bloom", "alibi"), ("falcon", "parallel-residual"),
    ("opt_350m_style", "post-norm"), ("phi_d80", "parallel-residual"),
    ("gptneox_d96", "parallel-residual")])
def test_tp_refuses_each_new_feature(name, match):
    """At tp 2 the fused programs refuse each block feature with the
    reference's reason, as NotImplementedError (and ValueError), before
    any process group is needed."""
    family, kw = ARCHS[name]
    cfg = get_model_config(family, "tiny", dtype=torch.float32, **kw)
    ecfg = RaggedInferenceEngineConfig(tensor_parallel_size=2,
                                       tp_collectives="fused", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match=match) as err:
        InferenceEngineV2(cfg, config=ecfg, device="cpu")
    assert isinstance(err.value, (LayoutNotCarried, ValueError))


@pytest.mark.parametrize("name,match", [
    ("mistral", "sliding windows"), ("qwen2_windows", "sliding windows"),
    ("bloom", "alibi"), ("falcon_alibi", "alibi"),
    ("falcon", "parallel residual"), ("opt_350m_style", "post_norm"),
    ("phi_d80", "head dim 80"), ("phi3_longrope_d96", "head dim 96"),
    ("gptneox_sequential_d96", "head dim 96")])
def test_training_refuses_each_new_feature(name, match):
    """Training these blocks is not carried (the flash kernels take no
    window and no bias, the flash backward no head dim 80 or 96):
    `initialize` refuses each by name, and so does the model's forward on
    a device other than the CPU."""
    family, kw = ARCHS[name]
    cfg = get_model_config(family, "tiny", dtype=torch.float32, **kw)
    assert match in training_refusal(cfg)
    with pytest.raises(NotImplementedError, match=match):
        initialize(model=Transformer(cfg),
                   config={"train_micro_batch_size_per_gpu": 1},
                   device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long, device="meta")
    with pytest.raises(NotImplementedError, match=match):
        Transformer(cfg).forward({}, ids)
    # the plain pre-norm presets still train
    assert training_refusal(get_model_config("opt", "tiny")) is None


def test_config_validates_the_new_fields_as_the_reference():
    with pytest.raises(ValueError, match="entries for 4 layers"):
        get_model_config("qwen2", "tiny", sliding_window_layers=(0, 16))
    with pytest.raises(ValueError, match="not both"):
        get_model_config("qwen2", "tiny", sliding_window=8,
                         sliding_window_layers=(0, 8, 0, 8))
    with pytest.raises(ValueError, match="sequential dense block"):
        get_model_config("opt", "tiny", post_norm=True,
                         parallel_residual=True)
    # rope scaling is carried now; an unknown kind raises where the
    # frequencies are made, as in the reference
    scaled = get_model_config("llama", "tiny", rope_scaling=("linear", 2.0))
    assert scaled.rope_scaling == ("linear", 2.0)
    assert training_refusal(scaled) is None
    from deepspeed_tpu_torch.models.transformer import _rope
    with pytest.raises(ValueError, match="rope_scaling kind"):
        _rope(torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, dtype=torch.long),
              1e4, scaling=("ntk", 2.0))
    cfg = get_model_config("qwen2", "tiny",
                           sliding_window_layers=(0, 16, 0, 16))
    assert layer_windows(cfg) == (None, 16, None, 16)
    assert layer_windows(get_model_config("mistral", "7b")) == (4096,) * 32
    # the slopes: bloom's after the scale, falcon-rw's divided by sqrt(D)
    bloom = alibi_slopes(get_model_config("bloom", "tiny"))
    rw = alibi_slopes(get_model_config("bloom", "tiny", alibi_scaled=True))
    np.testing.assert_allclose(rw, bloom / np.sqrt(32), rtol=1e-6)
    assert alibi_slopes(get_model_config("mistral", "tiny")) is None
