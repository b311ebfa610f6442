"""The port's MoE serving (mixtral, qwen2_moe) against the JAX package on
the CPU.

- `_moe_inference` of one layer, port against the JAX function on the
  same numpy-drawn rows and weights, f32: mixtral "tiny" (top-2 of 4,
  normalised weights) and qwen2_moe "tiny" (shared expert behind its
  sigmoid gate, `norm_topk_prob` False), unpaged and paged (slot stacks
  of 3 of 4 experts in permuted slots, so one expert's tokens reroute):
  outputs within 1e-5, census rows exactly equal.
- The plain grouped GEMM (what `ops.moe_grouped.grouped_matmul` runs for
  CPU tensors) against `jax.lax.ragged_dot`, empty groups included; the
  bf16 TMA kernels' order of sums (row tiles, K splits, 64-row stages
  summed apart), emulated in numpy over their plan, against it too; the
  sort-free group order against the reference's stable argsort.
- Engines built from the same JAX parameters (`params_from_jax`), f32:
  put/step (full-prompt and chunked prefill), a decode step,
  `decode_burst_step`, `decode_multi_step` and the verify span's logits
  within the engine tests' 1e-4, greedy tokens equal; a qwen2_moe stack
  with a dense layer between expert layers.
- The reference's engine-level expert-paging cases
  (tests/test_moe_serving.py): full residency bit for bit with the
  census draining, pressure with demote/promote/reserve/pin, the int8
  spill gate at 5%, the refusals; the census of a paged engine under
  pressure equal to the JAX engine's, rows and reroutes; the verify span
  refused while paging is on; MoE under the fused tensor-parallel ring
  refused with the reference's words.
- Training an MoE model stays refused by name.

The serve loop's MoE half (`MoeServingConfig`, `check_serving_moe`, the
serving/expert/* gauges) waits for the serve loop itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.inference.v2 import ragged_ops as jops
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
                                              build_engine, ragged_ops)
from deepspeed_tpu_torch.models import (Transformer, get_model_config,
                                        params_from_jax)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.transformer import training_refusal
from deepspeed_tpu_torch.ops import moe_grouped
from deepspeed_tpu_torch.serving import ExpertError, ExpertPool

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=16,
                 max_seqs=4, prefill_chunk_size=16,
                 max_prefill_tokens_per_step=32)
# 50 > the 32-token budget: that prompt is prefilled in chunks over steps
PROMPT_LENS = (5, 13, 29, 50)
# the engine tests' bound (tests/test_torch_port_engine.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# one layer's f32 MoE: the same products summed in another order
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
# qwen2_moe with layer 1 dense (a plain MLP of 192) between expert layers
QWEN_DENSE = dict(moe_dense_layers=(0, 1, 0, 0), dense_intermediate_size=192)
MODELS = {"mixtral": ("mixtral", {}),
          "qwen2_moe": ("qwen2_moe", QWEN_DENSE)}


def _engines(name, **engine_kw):
    family, kw = MODELS[name]
    ekw = dict(ENGINE_KW, **engine_kw)
    je = jax_build_engine(family, "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**ekw), **kw)
    te = build_engine(family, "tiny", params=jax.device_get(je.params),
                      engine_config=RaggedInferenceEngineConfig(**ekw),
                      device="cpu", dtype=torch.float32, **kw)
    return je, te


def _prompts(vocab, seed=1, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _same(out_j, out_t, **tol):
    assert sorted(out_t) == sorted(out_j)
    for u in out_j:
        np.testing.assert_allclose(out_t[u], out_j[u], **(tol or LOGIT_TOL))


def _same_state(je, te):
    assert sorted(te.state.seqs) == sorted(je.state.seqs)
    for uid, d in je.state.seqs.items():
        t = te.state.seqs[uid]
        assert t.blocks == d.blocks
        assert t.seen_tokens == d.seen_tokens
        assert list(t.generated) == list(d.generated)
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]


def _stage(engines, prompts):
    """put/step every prompt through prefill on each engine (logits
    compared), then stage the greedy first token as the pending input."""
    uids = list(range(len(prompts)))
    outs = [e.put(uids, [p.copy() for p in prompts], decode=False)
            for e in engines]
    for o in outs[1:]:
        _same(outs[0], o)
    while any(engines[0].query(u) is None for u in uids):
        outs = [e.step(decode=False) for e in engines]
        for o in outs[1:]:
            _same(outs[0], o)
    for u in uids:
        first = int(np.argmax(engines[0].query(u)))
        for e in engines:
            e.state.seqs[u].generated.append(first)
    return uids


# ----------------------------------------------------------------------
# one layer: _moe_inference
# ----------------------------------------------------------------------
def _layer(params, li=0):
    return {k: v[li] for k, v in params["layers"].items()}


def _page(lp, slot_map, mask):
    """The expert pool's view of one layer: slot stacks holding the
    resident experts at their slots, the map and the mask."""
    out = {k: v for k, v in lp.items()
           if k not in ("moe_w_up", "moe_w_down", "moe_w_gate_proj")}
    S = int(slot_map.max()) + 1
    for key in ("moe_w_up", "moe_w_down", "moe_w_gate_proj"):
        w = np.asarray(lp[key])
        slots = np.zeros((S,) + w.shape[1:], w.dtype)
        for e, s in enumerate(slot_map):
            if s >= 0:
                slots[s] = w[e]
        out[key + "_slots"] = slots
    out["moe_slot_map"] = slot_map
    out["moe_resident_mask"] = mask
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_inference_matches_jax(name, paged):
    family, kw = MODELS[name]
    jcfg = jax_model_config(family, "tiny", dtype=jnp.float32, **kw)
    cfg = get_model_config(family, "tiny", dtype=torch.float32, **kw)
    from deepspeed_tpu.models import Transformer as JaxTransformer
    jparams = jax.device_get(
        JaxTransformer(jcfg).init_params(jax.random.PRNGKey(7)))
    lp = {k: np.asarray(v) for k, v in _layer(jparams).items()}
    if paged:
        # experts 0, 2, 3 resident in slots 2, 0, 1; expert 1 demoted
        slot_map = np.asarray([2, -1, 0, 1], np.int32)
        lp = _page(lp, slot_map, slot_map >= 0)
    h = np.random.RandomState(3).randn(2, 9, cfg.hidden_size).astype(
        np.float32)
    want, wrow = jtf._moe_inference(
        jcfg, {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(h),
        with_census=True)
    got, row = ttf._moe_inference(
        cfg, {k: torch.from_numpy(np.asarray(v)) for k, v in lp.items()},
        torch.from_numpy(h), with_census=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    assert row.dtype == torch.int32
    assert row.tolist() == np.asarray(wrow).tolist()
    assert int(row[:-1].sum()) == cfg.moe_top_k * h.shape[0] * h.shape[1]
    if paged:
        assert int(row[-1]) > 0          # expert 1's tokens rerouted
    # no census: the same output
    plain = ttf._moe_inference(
        cfg, {k: torch.from_numpy(np.asarray(v)) for k, v in lp.items()},
        torch.from_numpy(h))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("sizes", [(3, 0, 5, 1), (0, 0, 7, 0), (1,),
                                   (2, 6, 0, 9, 0, 4, 3)],
                         ids=["some_empty", "one_group", "m1", "seven"])
def test_grouped_matmul_plain_matches_ragged_dot(sizes):
    rng = np.random.RandomState(len(sizes))
    M, K, N = sum(sizes), 24, 20
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randn(len(sizes), K, N).astype(np.float32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(sizes, jnp.int32),
                              preferred_element_type=jnp.float32)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32)
    got = moe_grouped.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                     offsets)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    # bf16 rows widen exactly: the same f32 product
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    np.testing.assert_allclose(
        moe_grouped.grouped_matmul(xb, wb, offsets).numpy(),
        moe_grouped.grouped_matmul(xb.float(), wb.float(), offsets).numpy(),
        rtol=0, atol=0)


# the bf16 kernels' order of sums vs ragged_dot, |emulation - ragged_dot|
# <= GROUPED_REL max|ragged_dot|: the same exact products (bf16 x bf16 is
# exact in f32) summed in f32 in another order (chip_smoke's MOE_REL)
GROUPED_REL = 2e-5


def _split_ranges(K, splits):
    """csrc/split_k.cuh `split_range`: split i sums K slots [i nkt //
    splits, (i + 1) nkt // splits) of SPLIT_KT rows."""
    kt, nkt = moe_grouped.SPLIT_KT, -(-K // moe_grouped.SPLIT_KT)
    return [(i * nkt // splits * kt, min(K, (i + 1) * nkt // splits * kt))
            for i in range(splits)]


def _kernel_order(x, w, sizes, plan):
    """The TMA kernels' sums, emulated: each group's rows in tiles of
    `plan.tok`, each split's K range in 64-row stages, each stage's
    products summed apart (the tensor cores' zeroed accumulators) and
    added to the split's running sum in f32, the splits' partials added
    in split order."""
    M, N = x.shape[0], w.shape[2]
    out = np.zeros((M, N), np.float32)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for g in range(len(sizes)):
        for r0 in range(off[g], off[g + 1], plan.tok):
            r1 = min(r0 + plan.tok, off[g + 1])
            total = None
            for k0, k1 in _split_ranges(x.shape[1], plan.splits):
                acc = np.zeros((r1 - r0, N), np.float32)
                for s in range(k0, k1, moe_grouped.SPLIT_KT):
                    e = min(s + moe_grouped.SPLIT_KT, k1)
                    acc += x[r0:r1, s:e] @ w[g, s:e]
                total = acc if total is None else total + acc
            out[r0:r1] = total
    return out


@pytest.mark.parametrize("sizes,K", [((5, 0, 9, 3, 0, 12), 200),
                                     ((40, 0, 70), 136)],
                         ids=["decode-stream-split4", "prefill-wgmma"])
def test_grouped_kernel_order_of_sums_matches_ragged_dot(sizes, K):
    """bf16 values through the TMA kernels' order of sums (the plan's row
    tile and K split, 64-row stages summed apart), against
    `jax.lax.ragged_dot` with f32 results, an empty group included."""
    rng = np.random.RandomState(K)
    M, G, N = sum(sizes), len(sizes), 24
    plan = moe_grouped.grouped_plan(M, K, N, G, torch.bfloat16)
    assert plan.variant in ("stream", "wgmma") and K % 64
    assert plan.splits > 1 or plan.variant == "wgmma"
    x, w = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .bfloat16().float().numpy() for shape in ((M, K), (G, K, N)))
    want = np.asarray(jax.lax.ragged_dot(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(sizes, jnp.int32), preferred_element_type=jnp.float32))
    got = _kernel_order(x, w, np.asarray(sizes), plan)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= GROUPED_REL * np.abs(want).max()


def test_sorted_slots_are_the_stable_argsort():
    """`_sorted_slots` puts assignment (t, j) where the reference's stable
    argsort of the flat ids puts it, and its offsets are the bincount's
    cumsum; `_in_group_order` lists each token's positions ascending."""
    rng = np.random.RandomState(0)
    T, k, G = 37, 4, 11
    gids = np.stack([rng.choice(G, k, replace=False) for _ in range(T)])
    pos, offsets = ttf._sorted_slots(torch.from_numpy(gids), G)
    order = np.argsort(gids.reshape(-1), kind="stable")
    want = np.empty(T * k, np.int64)
    want[order] = np.arange(T * k)
    assert pos.reshape(-1).tolist() == want.tolist()
    assert offsets.tolist() == [0] + np.cumsum(
        np.bincount(gids.reshape(-1), minlength=G)).tolist()
    ordered = ttf._in_group_order(pos, torch.from_numpy(gids)).numpy()
    assert (np.diff(ordered, axis=1) > 0).all()
    assert sorted(ordered.reshape(-1).tolist()) == list(range(T * k))


# ----------------------------------------------------------------------
# engines against the JAX engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_matches_jax(name):
    """put/step (fresh prompts through prefill_full, the long one
    chunked) -> a decode step -> an 8-token burst -> a k=4 group: logits,
    tokens and state as the JAX engine's."""
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
    want = je.decode_burst_step(uids=uids, n_steps=8)
    got = te.decode_burst_step(uids=uids, n_steps=8)
    for u in uids:
        assert np.asarray(got[u]).tolist() == np.asarray(want[u]).tolist()
    want = je.decode_multi_step(uids=uids, k=4)
    got = te.decode_multi_step(uids=uids, k=4)
    for u in uids:
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    _same_state(je, te)
    for u in uids:
        je.flush(u)
        te.flush(u)
    te.audit_blocks()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_verify_span_matches_jax(name):
    """The span forward's logits (`_span_core`) at every valid position
    against the JAX function's on the same arena, then a verify dispatch
    of greedy drafts on both engines: tokens and counts equal."""
    je, te = _engines(name)
    prompts = _prompts(te.cfg.vocab_size, seed=3, lens=(5, 27, 40))
    uids = _stage([je, te], prompts)
    B, S, V = ENGINE_KW["max_seqs"], 8, te.cfg.vocab_size
    MB = ENGINE_KW["max_blocks_per_seq"]
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, V, (B, S)).astype(np.int32)
    lens = np.zeros(B, np.int32)
    nval = np.asarray([8, 5, 1, 1], np.int32)
    tables = np.zeros((B, MB), np.int32)
    active = np.zeros(B, bool)
    max_lens = np.ones(B, np.int32)
    for i, u in enumerate(uids):
        d = te.state.seqs[u]
        lens[i] = d.seen_tokens
        max_lens[i] = d.seen_tokens + S
        for e in (je, te):
            e.state.ensure_capacity(e.state.seqs[u], d.seen_tokens + S)
        tables[i] = te.state.block_table(d)
        active[i] = True
    arena = {n: t.clone() for n, t in te.arena.items()}
    got, _ = ragged_ops._span_core(te.cfg, te.params, arena, tokens, lens,
                                   nval, tables, active, max_lens)
    want, _ = jops._span_core(je.cfg, je.params, je.arena,
                              jnp.asarray(tokens), jnp.asarray(lens),
                              jnp.asarray(nval), jnp.asarray(tables),
                              jnp.asarray(active), jnp.asarray(max_lens))
    want = np.asarray(want)
    for i in range(len(uids)):
        np.testing.assert_allclose(got[i, :nval[i]].numpy(),
                                   want[i, :nval[i]], **LOGIT_TOL)
    drafts = {u: [int(t) for t in rng.randint(0, V, 3)] for u in uids}
    want = je.decode_burst_step(uids=uids, drafts=drafts, draft_span=4)
    got = te.decode_burst_step(uids=uids, drafts=drafts, draft_span=4)
    for u in uids:
        assert got[u][0].tolist() == np.asarray(want[u][0]).tolist()
        assert got[u][1:] == tuple(int(x) for x in want[u][1:])
    _same_state(je, te)


def test_paged_census_under_pressure_matches_jax():
    """S = top_k + 1 of 4 experts on both engines: a burst and a group
    decode with reroutes; tokens equal, and the drained census (wanted
    counts and the reroute column) equal to the JAX engine's."""
    je, te = _engines("qwen2_moe")
    S = te.cfg.moe_top_k + 1
    jpool = je.enable_expert_paging(slots_per_layer=S)
    tpool = te.enable_expert_paging(slots_per_layer=S)
    uids = _stage([je, te], _prompts(te.cfg.vocab_size, seed=4))
    want = je.decode_burst_step(uids=uids, n_steps=6)
    got = te.decode_burst_step(uids=uids, n_steps=6)
    for u in uids:
        assert np.asarray(got[u]).tolist() == np.asarray(want[u]).tolist()
    want = je.decode_multi_step(uids=uids, k=3)
    got = te.decode_multi_step(uids=uids, k=3)
    for u in uids:
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    jc, tc = je.drain_moe_census(), te.drain_moe_census()
    assert tc.dtype == np.int32 and tc.tolist() == jc.tolist()
    assert tc[:, -1].sum() > 0
    # a dense layer counts nothing; an expert layer k per row per step
    assert tc[1].sum() == 0
    B, k = ENGINE_KW["max_seqs"], te.cfg.moe_top_k
    assert (tc[[0, 2, 3], :-1].sum(axis=1) == k * B * (6 + 3)).all()
    for pool in (jpool, tpool):
        pool.ingest_census(tc)
    assert tpool.rebalance(max_promotes=2) == jpool.rebalance(
        max_promotes=2) > 0
    assert tpool.stats() == jpool.stats()
    tpool.audit()


# ----------------------------------------------------------------------
# expert paging: the reference's engine-level cases
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_bundle():
    cfg = get_model_config("qwen2_moe", "tiny", dtype=torch.float32,
                           max_seq_len=128)
    params = Transformer(cfg).init_params(torch.Generator().manual_seed(0))
    return cfg, params


def _engine(cfg, params, **kw):
    base = dict(num_blocks=32, block_size=8, max_blocks_per_seq=8,
                max_seqs=4, prefill_chunk_size=16)
    base.update(kw)
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    # each engine its own copy: paging takes the expert stacks out
    own = {k: ({kk: vv.clone() for kk, vv in v.items()}
               if isinstance(v, dict) else v.clone())
           for k, v in params.items()}
    return InferenceEngineV2(cfg, params=own, device="cpu",
                             config=RaggedInferenceEngineConfig(**base))


def _prompt(cfg, seed=3, n=11):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, n).astype(np.int32)


def _greedy(eng, sid, prompt, steps=4):
    out = eng.put([sid], [prompt])
    logits = [np.asarray(out[sid])]
    tok = int(np.argmax(out[sid]))
    for _ in range(steps):
        out = eng.put([sid], [np.asarray([tok], np.int32)])
        logits.append(np.asarray(out[sid]))
        tok = int(np.argmax(out[sid]))
    return logits, tok


def test_full_residency_is_bit_exact_and_census_drains(moe_bundle):
    """S == E, spill='none': the paged engine is bit for bit the unpaged
    one, the full stacks leave the params, and the census counts every
    routed token and resets on drain."""
    cfg, params = moe_bundle
    prompt = _prompt(cfg)
    ref_logits, _ = _greedy(_engine(cfg, params), 1, prompt)

    eng = _engine(cfg, params)
    assert eng.supports_moe
    pool = eng.enable_expert_paging(slots_per_layer=cfg.moe_experts)
    assert isinstance(pool, ExpertPool)
    assert "moe_w_up" not in eng.params["layers"]
    assert eng.params["layers"]["moe_w_up_slots"].shape[1] == cfg.moe_experts
    paged_logits, _ = _greedy(eng, 1, prompt)
    for a, b in zip(ref_logits, paged_logits):
        assert np.array_equal(a, b), np.abs(a - b).max()

    pool.audit()
    fetches = eng.profile["d2h_fetches"]
    census = eng.drain_moe_census()
    assert eng.profile["d2h_fetches"] == fetches + 1
    assert census.shape == (cfg.num_layers, cfg.moe_experts + 1)
    # 4 decode steps of max_seqs rows, top_k each, every layer
    assert (census[:, :-1].sum(axis=1)
            == 4 * 4 * cfg.moe_top_k).all()
    assert census[:, -1].sum() == 0          # full residency: no reroutes
    pool.ingest_census(census)
    st = pool.stats()
    assert st["expert_routed"] > 0
    assert st["expert_rerouted"] == 0 and st["expert_drop_rate"] == 0.0
    assert st["expert_resident"] == cfg.num_layers * cfg.moe_experts
    # drain resets the device-side counters
    assert eng.drain_moe_census().sum() == 0


def test_pressure_demote_promote_reserve_pin(moe_bundle):
    """S = top_k + 1: demand exceeds residency, so the census shows
    reroutes, rebalance promotes the hottest spilled experts under a
    promote budget, reserve pins (and pinned demote refuses), and the
    conservation audit stays green through the reshuffle."""
    cfg, params = moe_bundle
    S = cfg.moe_top_k + 1
    eng = _engine(cfg, params)
    pool = eng.enable_expert_paging(slots_per_layer=S)
    _, tok = _greedy(eng, 2, _prompt(cfg), steps=3)
    pool.audit()
    pool.ingest_census(eng.drain_moe_census())
    st = pool.stats()
    assert st["expert_resident"] == S * cfg.num_layers
    assert st["expert_spilled"] == (cfg.moe_experts - S) * cfg.num_layers
    assert st["expert_routed"] > 0

    promoted = pool.rebalance(max_promotes=2)
    assert 0 <= promoted <= 2
    pool.audit()

    spilled = [e for e in range(cfg.moe_experts)
               if not pool.is_resident(0, e)]
    e0 = spilled[0]
    slots = eng.params["layers"]["moe_w_up_slots"]
    ptr = slots.data_ptr()
    slot = pool.reserve(0, e0)
    assert pool.is_resident(0, e0) and pool.pinned_count() == 1
    # written in place, from the canonical host copy
    assert slots.data_ptr() == ptr
    assert torch.equal(slots[0, slot], params["layers"]["moe_w_up"][0, e0])
    assert int(eng.params["layers"]["moe_slot_map"][0, e0]) == slot
    with pytest.raises(ExpertError):
        pool.demote(0, e0)
    pool.release(0, e0)
    assert pool.pinned_count() == 0
    pool.audit()
    # decode still healthy after the reshuffle
    out = eng.put([2], [np.asarray([tok], np.int32)])
    assert np.isfinite(np.asarray(out[2])).all()


def test_int8_spill_parity_gate(moe_bundle):
    """spill='int8' keeps lossy canonical host copies (opt-in); the gate:
    logits within 5% relative error of the exact engine, audit green."""
    cfg, params = moe_bundle
    prompt = _prompt(cfg)
    ref_logits, _ = _greedy(_engine(cfg, params), 1, prompt, steps=0)
    eng = _engine(cfg, params)
    pool = eng.enable_expert_paging(slots_per_layer=cfg.moe_experts,
                                    spill="int8")
    out = eng.put([3], [prompt])
    a, b = np.asarray(out[3]), ref_logits[0]
    err = np.abs(a - b).max() / (np.abs(b).max() + 1e-9)
    assert 0 < err < 5e-2, err
    pool.audit()


def test_enable_expert_paging_refusals(moe_bundle):
    cfg, params = moe_bundle
    eng = _engine(cfg, params)
    eng.enable_expert_paging(slots_per_layer=cfg.moe_experts)
    with pytest.raises(RuntimeError, match="already"):
        eng.enable_expert_paging(slots_per_layer=cfg.moe_experts)
    eng2 = _engine(cfg, params)
    eng2.put([9], [_prompt(cfg)])
    with pytest.raises(RuntimeError, match="live"):
        eng2.enable_expert_paging(slots_per_layer=cfg.moe_experts)
    eng3 = _engine(cfg, params)
    with pytest.raises(ValueError, match="slots_per_layer"):
        eng3.enable_expert_paging(slots_per_layer=cfg.moe_top_k - 1)
    with pytest.raises(RuntimeError, match="census rider"):
        eng3.drain_moe_census()
    dense = build_engine("llama", "tiny", device="cpu", dtype=torch.float32,
                         engine_config=RaggedInferenceEngineConfig(
                             num_blocks=8, block_size=8))
    assert not dense.supports_moe
    with pytest.raises(RuntimeError, match="MoE model"):
        dense.enable_expert_paging(slots_per_layer=2)
    with pytest.raises(ValueError, match="dense model"):
        ragged_ops.init_arena(dense.cfg, 4, 8, "cpu", moe_census=True)


def test_verify_with_paging_is_refused(moe_bundle):
    cfg, params = moe_bundle
    eng = _engine(cfg, params)
    eng.enable_expert_paging(slots_per_layer=cfg.moe_experts)
    eng.put([0], [_prompt(cfg)], decode=False)
    eng.state.seqs[0].generated.append(1)
    with pytest.raises(RuntimeError, match="expert paging"):
        eng.decode_burst_step(uids=[0], drafts={0: [2, 3]}, draft_span=4)


def test_moe_under_the_fused_ring_is_refused():
    """The fused tensor-parallel programs do not carry expert layers: the
    engine refuses before any process group is needed, with the
    reference's words."""
    with pytest.raises(ValueError, match="MoE layers are not wired"):
        build_engine("qwen2_moe", "tiny", device="cpu", dtype=torch.float32,
                     engine_config=RaggedInferenceEngineConfig(
                         tensor_parallel_size=2, tp_collectives="fused"))


def test_training_an_moe_model_is_refused():
    cfg = get_model_config("mixtral", "tiny", dtype=torch.float32)
    assert "mixture-of-experts layers" in training_refusal(cfg)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        initialize(model=Transformer(cfg),
                   config={"train_micro_batch_size_per_gpu": 1},
                   device="cpu")
    params = Transformer(cfg).init_params(torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        Transformer(cfg).forward(params, torch.zeros(1, 4, dtype=torch.long))


def test_params_from_jax_checks_the_moe_leaves():
    """The expert leaves' shapes are checked against the config: a stack
    of the wrong width, and a missing shared expert, are refused."""
    family, kw = MODELS["qwen2_moe"]
    jcfg = jax_model_config(family, "tiny", dtype=jnp.float32, **kw)
    cfg = get_model_config(family, "tiny", dtype=torch.float32, **kw)
    from deepspeed_tpu.models import Transformer as JaxTransformer
    tree = jax.device_get(
        JaxTransformer(jcfg).init_params(jax.random.PRNGKey(0)))
    got = params_from_jax(tree, cfg, "cpu")
    assert got["layers"]["moe_w_up"].shape == (
        4, cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size)
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["moe_w_down"] = bad["layers"]["moe_w_down"][:, :, :64]
    with pytest.raises(ValueError, match="moe_w_down"):
        params_from_jax(bad, cfg, "cpu")
    bad = dict(tree, layers=dict(tree["layers"]))
    del bad["layers"]["moe_shared_gate"]
    with pytest.raises(ValueError, match="moe_shared_gate"):
        params_from_jax(bad, cfg, "cpu")
