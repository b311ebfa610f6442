"""The port's speculative draft-and-verify against the JAX package on the
CPU.

- The prompt-lookup drafter and `span_bucket`: the reference test's
  cases, port and reference on the same inputs.
- `_spec_accept` (greedy) on seeded logits and drafts that match the
  argmax for a while: the JAX function's tokens and counts exactly.
- The engine's `decode_burst_step(drafts=, draft_span=)` against the JAX
  engine's, f32, both built from the JAX initializer's parameters and fed
  the same prompts: llama (GQA), gpt2 (learned positions), mistral with
  a window of 16 keys at block size 8, bloom (ALiBi), phi at head dim 80
  and Phi-3 at 96 with longrope, on the 5-D and the merged arenas.  A
  perfect draft (the greedy chain), a half-right one, a garbage one and
  none share a dispatch, then prompt-lookup drafts: tokens, drafted and
  accepted counts, state (blocks, lengths, fetches) and arenas alike
  (logits of the engine tests' 1e-4).
- `_span_core`'s logits against the JAX `_span_core`'s on the same
  arena, at 1e-4; longrope's band: the port passes no `regime_len`, so a
  row's band is its last span position + 1, as the reference's, and a
  span across the original context takes the long band.
- Spec-on greedy chains against the port's sequential bursts and the JAX
  chain; perfect drafts accepted whole, garbage rejected at position 0;
  a span past the lease cap keeps its in-lease tokens exact.
- Rejection sampling on torch's generator (its stream is not
  jax.random's, so the rules are held, not the stream): counts in [1,
  n_valid], a rejected draft token never its own replacement, the first
  emitted token distributed as p whatever the draft (20000 seeded rows
  on a vocabulary of 6, each frequency within 0.02 of p: five standard
  deviations).
- The refusals: seeds with drafts, adapter rows with drafts, draft_span
  missing or below 1, and the grammar operands by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.inference.v2 import ragged_ops as jops
from deepspeed_tpu.serving import speculative as jspec
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
                                              build_engine, ragged_ops)
from deepspeed_tpu_torch.serving import (PromptLookupDrafter, span_bucket,
                                         speculative)

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=16,
                 max_seqs=4, prefill_chunk_size=16,
                 max_prefill_tokens_per_step=32)
# 50 > the 32-token budget: that prompt is prefilled in chunks over steps
PROMPT_LENS = (5, 13, 29, 50)
# the engine tests' bound (tests/test_torch_port_engine.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SPAN = 8
LONGROPE_96 = ("longrope", float(np.sqrt(1 + np.log(4.0) / np.log(32.0))),
               32.0, tuple(1.0 + 0.02 * i for i in range(48)),
               tuple(1.0 + 0.25 * i for i in range(48)))
ARCHS = {
    "llama_gqa": ("llama", dict(vocab_size=2048)),
    "gpt2": ("gpt2", {}),
    "mistral_window": ("mistral", dict(vocab_size=2048, sliding_window=16)),
    "bloom_alibi": ("bloom", {}),
    "phi_d80": ("phi", dict(hidden_size=160, num_heads=2)),
    "phi3_longrope_d96": ("phi3", dict(hidden_size=384, num_heads=4,
                                       num_kv_heads=2,
                                       rope_scaling=LONGROPE_96)),
}


def _engines(name, merged=False, **engine_kw):
    family, kw = ARCHS[name]
    ekw = dict(ENGINE_KW, arena_merged=merged, **engine_kw)
    je = jax_build_engine(family, "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**ekw), **kw)
    te = build_engine(family, "tiny", params=jax.device_get(je.params),
                      engine_config=RaggedInferenceEngineConfig(**ekw),
                      device="cpu", dtype=torch.float32, **kw)
    return je, te


def _prompts(vocab, seed=1, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _stage(engines, prompts):
    """Prefill every prompt and stage its greedy first token (the first
    engine's argmax) as the pending input of each engine."""
    uids = list(range(len(prompts)))
    for e in engines:
        e.put(uids, [p.copy() for p in prompts], decode=False)
        while any(e.query(u) is None for u in uids):
            e.step(decode=False)
    for u in uids:
        first = int(np.argmax(engines[0].query(u)))
        for e in engines:
            e.state.seqs[u].generated.append(first)
    return uids


def _same_state(je, te):
    assert sorted(te.state.seqs) == sorted(je.state.seqs)
    for uid, d in je.state.seqs.items():
        t = te.state.seqs[uid]
        assert t.blocks == d.blocks
        assert t.seen_tokens == d.seen_tokens
        assert list(t.generated) == list(d.generated)
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]


def _same_arena(je, te):
    """Every written slot of the two arenas alike (the layouts may differ
    in their minor dims; the bytes agree)."""
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


def _same_dispatch(got, want):
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u][0].tolist() == np.asarray(want[u][0]).tolist(), u
        assert got[u][1:] == tuple(int(x) for x in want[u][1:]), u


# ----------------------------------------------------------------------
# the drafter
# ----------------------------------------------------------------------
DRAFT_CASES = [
    # (ngram, max_draft, context, max_draft argument)
    (3, 4, [5, 6, 7, 9, 1, 5, 6, 7], -1),
    (3, 4, [5, 6, 7, 9, 1, 5, 6, 7], 2),
    (3, 4, [5, 6, 7, 9, 1, 5, 6, 7], 0),
    (2, 3, [3, 4, 7, 0, 3, 4, 8, 2, 3, 4], -1),
    (3, 4, [9, 8, 9, 8, 9, 8, 9, 8], -1),
    (3, 3, [6, 1, 2, 3, 6], -1),
    (3, 4, [1, 2, 3, 4, 5, 5, 5], -1),
    (3, 4, [1, 2, 3, 4], -1),
    (3, 4, [9], -1),
    (1, 7, [2, 2, 2, 2], -1),
]


@pytest.mark.parametrize("case", range(len(DRAFT_CASES)))
def test_prompt_lookup_matches_reference(case):
    """The reference test's drafter cases (match and cap, the most recent
    match, a cyclic context's full span, n-gram back-off, tiled short
    continuations, no match): the port's drafts equal the reference's."""
    ngram, max_draft, ctx, arg = DRAFT_CASES[case]
    ctx = np.asarray(ctx, np.int32)
    want = jspec.PromptLookupDrafter(ngram, max_draft).draft(ctx, arg)
    got = PromptLookupDrafter(ngram, max_draft).draft(ctx, arg)
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist()


def test_prompt_lookup_reference_values_and_span_bucket():
    d = PromptLookupDrafter(ngram=3, max_draft=4)
    ctx = np.asarray([5, 6, 7, 9, 1, 5, 6, 7], np.int32)
    assert list(d.draft(ctx)) == [9, 1, 5, 6]
    assert list(PromptLookupDrafter(3, 4).draft(
        np.asarray([9, 8, 9, 8, 9, 8, 9, 8], np.int32))) == [9, 8, 9, 8]
    ns = (1, 2, 3, 4, 5, 8, 9, 16, 17)
    assert [span_bucket(n) for n in ns] == [jspec.span_bucket(n)
                                            for n in ns]
    assert [span_bucket(n) for n in ns[:7]] == [2, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError):
        span_bucket(0)
    with pytest.raises(ValueError, match="ngram"):
        PromptLookupDrafter(ngram=0)
    with pytest.raises(ValueError, match="max_draft"):
        PromptLookupDrafter(max_draft=-1)


def test_filter_draft_matches_reference():
    class Automaton:
        trans = np.full((3, 10), -1, np.int32)
    Automaton.trans[0, 4] = 1
    Automaton.trans[1, 5] = 2
    Automaton.trans[2, 4] = 0
    for draft, state in (([4, 5, 4, 4, 5], 0), ([5, 4], 0), ([5, 4, 5], 1),
                         ([], 2)):
        want = jspec.filter_draft(draft, Automaton, state)
        got = speculative.filter_draft(draft, Automaton, state)
        assert got.tolist() == want.tolist()


# ----------------------------------------------------------------------
# acceptance
# ----------------------------------------------------------------------
def test_spec_accept_greedy_matches_jax():
    """Seeded [B, S, V] logits; drafts that follow the argmax for 0 to
    S-1 positions and then differ, and rows of every draft length: the
    JAX function's emitted tokens and counts exactly (the argmax of the
    same f32 logits; padded columns never read)."""
    rng = np.random.RandomState(4)
    B, S, V = 24, 8, 50
    logits = rng.randn(B, S, V).astype(np.float32)
    tgt = logits.argmax(-1)
    tokens = rng.randint(0, V, (B, S)).astype(np.int32)
    n_valids = rng.randint(1, S + 1, B).astype(np.int32)
    for b in range(B):
        good = rng.randint(0, S)
        tokens[b, 1:1 + good] = tgt[b, :good]
        tokens[b, n_valids[b]:] = 0
    want_e, want_n = jops._spec_accept(jnp.asarray(logits),
                                       jnp.asarray(tokens),
                                       jnp.asarray(n_valids), None, "greedy",
                                       None, None)
    got_e, got_n = ragged_ops._spec_accept(torch.from_numpy(logits), tokens,
                                           n_valids, None, "greedy", None,
                                           None)
    assert got_e.dtype == got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert 1 <= got_n.min() and (got_n.numpy() <= n_valids).all()


def test_scale_topk_per_row_matches_jax_on_span_rows():
    """The per-row temperature and top-k step on the [B*S, V] rows the
    verify passes (each row's values repeated S times): the JAX
    function's values."""
    from deepspeed_tpu.inference.sampling import scale_topk_per_row as jst
    from deepspeed_tpu_torch.inference.sampling import scale_topk_per_row
    rng = np.random.RandomState(2)
    B, S, V = 6, 4, 40
    logits = rng.randn(B * S, V).astype(np.float32) * 3
    t = np.repeat(np.asarray([0.0, 0.5, 1.0, 0.9, 2.0, 0.7], np.float32), S)
    k = np.repeat(np.asarray([0, 0, 5, 1, 40, 39], np.int32), S)
    want = np.asarray(jst(jnp.asarray(logits), jnp.asarray(t),
                          jnp.asarray(k)))
    got = scale_topk_per_row(torch.from_numpy(logits), torch.from_numpy(t),
                             torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6, atol=0)


def test_spec_accept_first_token_follows_p():
    """Rejection sampling against a point-mass draft: whatever the draft
    (a likely token, an unlikely one, one outside top_k), the first
    emitted token is distributed as p = softmax(scale_topk(logits)); a
    rejected draft token is never its own replacement; counts in [1,
    n_valid]."""
    from deepspeed_tpu_torch.inference.sampling import scale_topk_per_row
    N, S, V = 20000, 3, 6
    base = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 0.3])
    gen = torch.Generator().manual_seed(7)
    for temp, top_k, draft in ((1.0, 0, 0), (0.7, 0, 4), (1.3, 4, 2),
                               (1.0, 3, 5)):
        logits = base.expand(N, S, V).contiguous()
        tokens = np.zeros((N, S), np.int32)
        tokens[:, 1] = draft
        tokens[:, 2] = 1
        n_valids = np.full(N, S, np.int32)
        em, n = ragged_ops._spec_accept(
            logits, tokens, n_valids, gen, "per_row",
            torch.full((N,), temp), torch.full((N,), top_k,
                                               dtype=torch.int64), )
        p = torch.softmax(scale_topk_per_row(
            base[None], torch.tensor([temp]),
            torch.tensor([top_k]))[0], dim=-1).numpy()
        freq = np.bincount(em[:, 0].numpy(), minlength=V) / N
        assert np.abs(freq - p).max() < 0.02, (temp, top_k, draft, freq, p)
        n = n.numpy()
        assert n.min() >= 1 and n.max() <= S
        rejected = n == 1
        assert rejected.any() and (em[rejected, 0].numpy() != draft).all()


# ----------------------------------------------------------------------
# the engine: against the JAX engine
# ----------------------------------------------------------------------
def _chains(name, prompts, merged, n=SPAN):
    """The JAX engine's greedy chain of `n` tokens after each staged
    first token (a third engine, driven by sequential bursts)."""
    family, kw = ARCHS[name]
    jc = jax_build_engine(family, "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**dict(
                              ENGINE_KW, arena_merged=merged)), **kw)
    uids = _stage([jc], prompts)
    got = jc.decode_burst_step(uids=uids, n_steps=n)
    return {u: [int(jc.state.seqs[u].generated[-n - 1])]
            + np.asarray(got[u]).tolist() for u in uids}


@pytest.mark.parametrize("merged", [False, True], ids=["5d", "merged"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_verify_matches_jax(name, merged):
    """Two dispatches on each engine: a perfect draft (the greedy chain),
    a half-right one, a garbage one and none; then prompt-lookup drafts
    bucketed by `span_bucket`.  Tokens, drafted and accepted counts,
    state, fetches and arenas as the JAX engine's; the perfect draft is
    accepted whole and the garbage one rejected at position 0."""
    je, te = _engines(name, merged)
    assert te.supports_draft_verify and je.supports_draft_verify
    assert (te.arena["k"].dim() == 4) == merged
    vocab = te.cfg.vocab_size
    prompts = _prompts(vocab)
    uids = _stage([je, te], prompts)
    chain = _chains(name, prompts, merged)
    for u in uids:
        assert chain[u][0] == te.state.seqs[u].generated[-1]
    drafts = {0: chain[0][1:SPAN],
              1: chain[1][1:3] + [(t + 1) % vocab for t in chain[1][3:6]],
              2: [(t + 7) % vocab for t in chain[2][1:5]],
              3: []}
    want = je.decode_burst_step(uids=uids, drafts=drafts, draft_span=SPAN)
    got = te.decode_burst_step(uids=uids, drafts=drafts, draft_span=SPAN)
    _same_dispatch(got, want)
    assert got[0][0].tolist() == chain[0][1:SPAN + 1]
    assert got[0][1:] == (SPAN - 1, SPAN - 1)
    assert got[1][1:] == (5, 2) and got[1][0].tolist() == chain[1][1:4]
    assert got[2][1:] == (4, 0) and got[2][0].tolist() == [chain[2][1]]
    assert got[3][1:] == (0, 0) and got[3][0].tolist() == [chain[3][1]]
    _same_state(je, te)
    drafter = PromptLookupDrafter(ngram=3, max_draft=7)
    for _ in range(2):
        ctx = {u: np.concatenate([te.state.seqs[u].prompt,
                                  te.state.seqs[u].generated])
               for u in uids}
        drafts = {u: drafter.draft(c) for u, c in ctx.items()}
        span = span_bucket(1 + max(len(d) for d in drafts.values()))
        want = je.decode_burst_step(uids=uids, drafts=drafts,
                                    draft_span=span)
        got = te.decode_burst_step(uids=uids, drafts=drafts,
                                   draft_span=span)
        _same_dispatch(got, want)
        _same_state(je, te)
    _same_arena(je, te)
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert te.free_blocks == je.free_blocks == ENGINE_KW["num_blocks"]
    te.audit_blocks()


@pytest.mark.parametrize("name", ["llama_gqa", "bloom_alibi",
                                  "phi3_longrope_d96"])
def test_span_core_logits_match_jax(name):
    """The span forward's logits at every valid position of the active
    rows, port against the JAX `_span_core`, on the same arena and
    operands (the port's arena a clone: it writes in place), at 1e-4;
    the port's written slots as the JAX arena's.  Rows 0-2 at lengths
    on both sides of Phi-3's original context (32): row 1's span starts
    below it and ends above it, so its band is the long one (no
    `regime_len`: max span position + 1, as the reference's)."""
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
    assert lens[1] < 32 < lens[1] + S and lens[0] + S < 32 < lens[2]
    arena = {n: t.clone() for n, t in te.arena.items()}
    got, arena = ragged_ops._span_core(te.cfg, te.params, arena, tokens,
                                       lens, nval, tables, active, max_lens)
    want, jarena = jops._span_core(je.cfg, je.params, je.arena,
                                   jnp.asarray(tokens), jnp.asarray(lens),
                                   jnp.asarray(nval), jnp.asarray(tables),
                                   jnp.asarray(active),
                                   jnp.asarray(max_lens))
    want = np.asarray(want)
    assert got.shape == (B, S, V) and got.dtype == torch.float32
    for i in range(len(uids)):
        np.testing.assert_allclose(got[i, :nval[i]].numpy(),
                                   want[i, :nval[i]], **LOGIT_TOL)
    bs = ENGINE_KW["block_size"]
    for name_ in ("k", "v"):
        ja = np.asarray(jarena[name_])
        ta = arena[name_].numpy()
        for i, u in enumerate(uids):
            d = te.state.seqs[u]
            for pos in range(lens[i], lens[i] + nval[i]):
                blk = d.blocks[pos // bs]
                np.testing.assert_allclose(ta[:, blk, pos % bs],
                                           ja[:, blk, pos % bs],
                                           **LOGIT_TOL)


def _tiny(name="llama_gqa", params=None, **engine_kw):
    """A port engine of the preset (random weights from its seeded
    generator, or `params`)."""
    family, kw = ARCHS[name]
    return build_engine(family, "tiny", params=params,
                        engine_config=RaggedInferenceEngineConfig(
                            **dict(ENGINE_KW, **engine_kw)),
                        device="cpu", dtype=torch.float32, **kw)


def test_spec_chain_equals_sequential_bursts_and_jax():
    """Greedy, prompt-lookup drafts over prompts that repeat a passage:
    the port's spec-on chains of 24 tokens equal its sequential bursts'
    and the JAX engine's sequential chains, and the drafts were accepted
    somewhere (fewer dispatches than tokens)."""
    je, te = _engines("llama_gqa")
    seq = _tiny(params=jax.device_get(je.params))
    rng = np.random.RandomState(9)
    passage = rng.randint(0, 2048, 12).astype(np.int32)
    prompts = [np.concatenate([passage, rng.randint(0, 2048, 3), passage[:4]]
                              ).astype(np.int32),
               np.tile(passage[:5], 4).astype(np.int32),
               rng.randint(0, 2048, 9).astype(np.int32)]
    n_new = 24
    uids = _stage([je, te, seq], prompts)
    want = {u: [] for u in uids}
    while min(len(v) for v in want.values()) < n_new:
        got = je.decode_burst_step(uids=uids, n_steps=8)
        mine = seq.decode_burst_step(uids=uids, n_steps=8)
        for u in uids:
            assert np.asarray(got[u]).tolist() == mine[u].tolist()
            want[u] += np.asarray(got[u]).tolist()
    drafter = PromptLookupDrafter(ngram=3, max_draft=7)
    spec = {u: [] for u in uids}
    dispatches = accepted = 0
    while min(len(v) for v in spec.values()) < n_new:
        drafts = {}
        for u in uids:
            d = te.state.seqs[u]
            drafts[u] = drafter.draft(np.concatenate([d.prompt,
                                                      d.generated]))
        span = span_bucket(1 + max(len(d) for d in drafts.values()))
        got = te.decode_burst_step(uids=uids, drafts=drafts, draft_span=span)
        dispatches += 1
        for u in uids:
            spec[u] += got[u][0].tolist()
            accepted += got[u][2]
    for u in uids:
        assert spec[u][:n_new] == want[u][:n_new]
    assert accepted > 0 and dispatches < n_new


def test_overshooting_draft_keeps_in_lease_tokens_exact():
    """A draft longer than the remaining lease (a cap 2 tokens past the
    pending position, a perfect draft of 7): only the in-lease tokens
    come back, equal to the sequential chain; the span positions past
    the cap wrote nothing."""
    eng = _tiny()
    prompt = np.arange(1, 10, dtype=np.int32)
    want = list(eng.generate(prompt, max_new_tokens=10, uid=99))
    eng2 = _tiny()
    out = eng2.put([7], [prompt])
    while 7 not in out:
        out.update(eng2.step())
    t0 = int(eng2.sample_tokens_batch(out[7][None])[0])
    eng2.state.seqs[7].generated.append(t0)
    assert t0 == want[0]
    d = eng2.state.seqs[7]
    cap = d.seen_tokens + 2
    bs = ENGINE_KW["block_size"]
    snap = {n: t.clone() for n, t in eng2.arena.items()}
    got = eng2.decode_burst_step(
        uids=[7], mode="greedy", max_tokens={7: cap},
        drafts={7: np.asarray(want[1:8], np.int32)}, draft_span=8)
    toks, drafted, accepted = got[7]
    assert drafted == 7 and accepted == 1
    assert [t0] + toks.tolist() == want[:3]
    assert d.seen_tokens == cap
    # the lease covers the cap only; no slot past it was written
    assert len(d.blocks) * bs >= cap
    for pos in range(cap, len(d.blocks) * bs):
        blk = d.blocks[pos // bs]
        for n in ("k", "v"):
            assert torch.equal(eng2.arena[n][:, blk, pos % bs],
                               snap[n][:, blk, pos % bs])


def test_span_crossing_max_tokens_per_seq():
    """A sequence whose pending token sits three positions below the
    engine's ceiling (max_blocks_per_seq * block_size): a span of 8 with
    a perfect draft is cut at the ceiling, the three tokens it keeps
    equal the sequential burst's, and it leases no block past the
    table."""
    kw = dict(max_blocks_per_seq=4)
    spec, seq = _tiny(**kw), _tiny(**kw)
    limit = spec.max_tokens_per_seq
    assert limit == 32
    prompt = (np.arange(limit - 3) % 50 + 3).astype(np.int32)
    uids = _stage([spec, seq], [prompt])
    want = seq.decode_burst_step(uids=uids, n_steps=8)[0].tolist()
    got = spec.decode_burst_step(uids=uids, drafts={0: want[:7]},
                                 draft_span=8)[0]
    assert got[0].tolist() == want[:3] and got[1:] == (7, 2)
    assert spec.state.seqs[0].seen_tokens == limit
    assert len(spec.state.seqs[0].blocks) == 4


def test_stochastic_verify_rules_on_the_engine():
    """per_row and sample dispatches at temperature 0.9: each row emits 1
    to n_valid tokens; a rejected draft token is never its own
    replacement; a temperature-0 row in a per_row dispatch verifies
    greedily (its tokens are a greedy engine's at the same state); each
    dispatch reads the device once."""
    eng, greedy = _tiny(), _tiny()
    prompts = _prompts(2048, seed=4, lens=(7, 11, 3))
    uids = _stage([eng, greedy], prompts)
    gen = torch.Generator().manual_seed(3)
    for trial in range(6):
        drafts = {}
        for u in uids:
            pending = eng.state.seqs[u].generated[-1]
            drafts[u] = [(pending + 63 * (j + 1)) % 2048 for j in range(3)]
        f0 = eng.profile["d2h_fetches"]
        if trial % 2 == 0:
            kw = dict(mode="per_row", temperature={0: 0.9, 1: 0.9, 2: 0.0},
                      top_k={0: 0, 1: 5, 2: 0})
        else:
            kw = dict(mode="sample", temperature=0.9, top_k=0)
        got = eng.decode_burst_step(uids=uids, rng=gen, drafts=drafts,
                                    draft_span=4, **kw)
        assert eng.profile["d2h_fetches"] == f0 + 1
        for u in uids:
            toks, drafted, accepted = got[u]
            assert drafted == 3 and 1 <= len(toks) <= 4
            assert len(toks) == accepted + 1
            if accepted < drafted:
                assert int(toks[accepted]) != drafts[u][accepted]
        if trial == 0:
            g = greedy.decode_burst_step(uids=[2], drafts={2: drafts[2]},
                                         draft_span=4)
            assert g[2][0].tolist() == got[2][0].tolist()


def test_verify_refusals():
    """The reference's refusals with its words: seeds with drafts, LoRA
    adapter rows with drafts, draft_span missing or below 1; the grammar
    operands by name (structured generation is not carried)."""
    from deepspeed_tpu_torch.serving.tenancy import AdapterPool
    eng = _tiny()
    uids = _stage([eng], _prompts(2048, lens=(6, 9)))
    with pytest.raises(RuntimeError, match="seeded sampling streams"):
        eng.decode_burst_step(mode="sample", seeds={0: 1},
                              seed_positions={0: 1}, drafts={0: [1]},
                              draft_span=2)
    for span in (None, 0):
        with pytest.raises(ValueError, match="draft_span >= 1"):
            eng.decode_burst_step(drafts={0: [1]}, draft_span=span)
    with pytest.raises(NotImplementedError, match="grammar"):
        eng.decode_burst_step(drafts={0: [1]}, draft_span=2, fsm=object(),
                              fsm_states={0: 0})
    with pytest.raises(NotImplementedError, match="grammar"):
        ragged_ops.verify_tokens(eng.cfg, eng.params, eng.arena,
                                 np.zeros((4, 2), np.int32), np.zeros(4),
                                 np.ones(4), np.zeros((4, 16), np.int32),
                                 np.zeros(4, bool), None,
                                 fsm_mask=np.zeros((2, 8), bool))
    with pytest.raises(ValueError, match="unknown sampling mode"):
        eng.decode_burst_step(drafts={0: [1]}, draft_span=2, mode="beam")
    # nothing moved
    assert [len(eng.state.seqs[u].generated) for u in uids] == [1, 1]
    # LoRA adapter rows
    cfg = eng.cfg
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size
    lora_eng = _tiny()
    pool = AdapterPool(lora_eng, 3 * L)
    r = np.random.RandomState(1)
    pool.register("a", (r.randn(L, K, 4) / np.sqrt(K)).astype(np.float32),
                  r.randn(L, 4, H).astype(np.float32))
    lora_eng.set_adapter(0, pool.reserve("a"))
    _stage([lora_eng], _prompts(2048, lens=(6, 9)))
    with pytest.raises(RuntimeError, match="LoRA adapter rows"):
        lora_eng.decode_burst_step(drafts={0: [1]}, draft_span=2)
    # an adapter row the span would serve without a draft of its own
    with pytest.raises(RuntimeError, match="LoRA adapter rows"):
        lora_eng.decode_burst_step(drafts={1: [1]}, draft_span=2)
    # a base row of the same engine verifies
    got = lora_eng.decode_burst_step(uids=[1], drafts={1: [1]},
                                     draft_span=2)
    assert got[1][1] == 1
