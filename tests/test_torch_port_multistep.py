"""The PyTorch port's seeded sampling streams and multi-step decode groups
against the JAX package.

- `philox_word` (Philox4x64-10 in int64 lanes) bit for bit against
  numpy's `Philox(key=[seed, position])` and the JAX `philox_word`;
  `seeded_uniform24` in every f32 bit against JAX's; `_seeded_pick`
  against JAX's on random logits away from the bin edges.
- The tiny llama engines in f32 on the CPU (the port's built from the JAX
  engine's parameters, as tests/test_torch_port_engine.py builds them):
  `decode_multi_step` groups at k 1 and 8 — greedy, EOS and `max_tokens`
  stops inside a group, seeded rows (with the reference test's host chain
  as a third side), a mixed batch, LoRA rows — and seeded
  `decode_burst_step`, with the same packed counts, sequence state, block
  tables and device-to-host fetches (one a group) after every call, and
  the arena equal at every leased slot after a mid-group stop.
- The device-planned burst against the host-planned one bit for bit,
  padded rows pointing at a live row's block included.
- The guards, and the refusal under tensor parallelism (two gloo ranks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.inference.v2 import ragged_ops as jro
from deepspeed_tpu.models.transformer import _forward
from deepspeed_tpu.serving.streaming import seeded_sample
from deepspeed_tpu.serving.tenancy import AdapterPool as JaxPool
from deepspeed_tpu_torch.comm import spawn_ranks
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.inference.v2 import ragged_ops as tro
from deepspeed_tpu_torch.serving.tenancy import AdapterPool

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_blocks=64, block_size=16, max_blocks_per_seq=16,
                 max_seqs=8, prefill_chunk_size=32,
                 max_prefill_tokens_per_step=64)
PROMPT_LENS = (5, 17, 40, 23)
# f32 engines agree on logits to about 1e-6 (tests/test_torch_port_model
# .py); 1e-4 is the bound asserted there
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# a greedy step is decided the same way by both engines when the top two
# logits are further apart than both engines' error together
MIN_TOP2_GAP = 2 * LOGIT_TOL["atol"]
# _seeded_pick: torch's and XLA's f32 cumsums sum in different orders, so
# a draw is held equal only where u * total lies further than this share
# of the total from every bin edge
PICK_MARGIN = 1e-6
SEEDS = (0, 1, 2 ** 32 - 1, 2 ** 63, 2 ** 64 - 1,
         *np.random.RandomState(5).randint(0, 2 ** 63, 4, dtype=np.int64))
POSITIONS = (0, 1, 2 ** 31 - 1)
TEMP, TOPK = 0.9, 20
RANK = 4
RANK_TIMEOUT_S = 180


# ----------------------------------------------------------------------
# the Philox stream
# ----------------------------------------------------------------------
def _numpy_word(seed, pos):
    return int(np.random.Philox(key=np.array([seed, pos], dtype=np.uint64)
                                ).random_raw(1)[0])


@pytest.mark.parametrize("seed", [int(s) for s in SEEDS])
def test_philox_word_matches_numpy_and_jax(seed):
    pos = np.asarray(POSITIONS, np.int64)
    hi, lo = tro.philox_word(seed >> 32, seed & 0xFFFFFFFF,
                             torch.from_numpy(pos >> 32),
                             torch.from_numpy(pos & 0xFFFFFFFF))
    got = [(int(h) << 32) | int(l) for h, l in zip(hi, lo)]
    assert got == [_numpy_word(seed, int(p)) for p in pos]
    jh, jl = jro.philox_word(
        jnp.full(pos.shape, seed >> 32, jnp.uint32),
        jnp.full(pos.shape, seed & 0xFFFFFFFF, jnp.uint32),
        jnp.asarray(pos >> 32, jnp.uint32),
        jnp.asarray(pos & 0xFFFFFFFF, jnp.uint32))
    assert hi.tolist() == np.asarray(jh).astype(np.int64).tolist()
    assert lo.tolist() == np.asarray(jl).astype(np.int64).tolist()


def test_philox_word_random_keys_match_numpy():
    """200 random (seed, position) keys in one vectorized call."""
    rng = np.random.RandomState(7)
    seeds = rng.randint(0, 2 ** 63, 200, dtype=np.int64).astype(np.uint64) \
        * np.uint64(2) + rng.randint(0, 2, 200).astype(np.uint64)
    pos = rng.randint(0, 2 ** 31, 200, dtype=np.int64)
    hi, lo = tro.philox_word(torch.from_numpy((seeds >> np.uint64(32))
                                              .astype(np.int64)),
                             torch.from_numpy((seeds & np.uint64(0xFFFFFFFF))
                                              .astype(np.int64)),
                             torch.zeros(200, dtype=torch.int64),
                             torch.from_numpy(pos))
    for i in range(200):
        assert (int(hi[i]) << 32) | int(lo[i]) == _numpy_word(
            int(seeds[i]), int(pos[i]))


def test_seeded_uniform24_matches_jax_bit_for_bit():
    rng = np.random.RandomState(8)
    seeds = [int(s) for s in SEEDS] + [int(s) for s in rng.randint(
        0, 2 ** 63, 40, dtype=np.int64)]
    pos = rng.randint(0, 2 ** 31, len(seeds), dtype=np.int64)
    pos[:3] = POSITIONS
    hi = np.asarray([s >> 32 for s in seeds], np.int64)
    lo = np.asarray([s & 0xFFFFFFFF for s in seeds], np.int64)
    got = tro.seeded_uniform24(torch.from_numpy(hi), torch.from_numpy(lo),
                               torch.from_numpy(pos))
    want = np.asarray(jro.seeded_uniform24(jnp.asarray(hi, jnp.uint32),
                                           jnp.asarray(lo, jnp.uint32),
                                           jnp.asarray(pos, jnp.int32)))
    assert got.dtype == torch.float32
    assert got.numpy().view(np.int32).tolist() == \
        want.view(np.int32).tolist()
    # the host's 53-bit draw truncated to its top 24 bits
    for s, p, u in zip(seeds, pos, got.tolist()):
        u53 = float(np.random.Generator(np.random.Philox(
            key=np.array([s, int(p)], dtype=np.uint64))).random())
        assert int(u * 2 ** 24) == int(u53 * 2 ** 24)


@pytest.mark.parametrize("top_k", [0, 20])
def test_seeded_pick_matches_jax_away_from_bin_edges(top_k):
    rng = np.random.RandomState(9 + top_k)
    B, V = 64, 300
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    u = rng.rand(B).astype(np.float32)
    t = torch.full((B,), TEMP)
    kv = torch.full((B,), top_k, dtype=torch.int64)
    from deepspeed_tpu.inference.sampling import scale_topk_per_row as jscale
    from deepspeed_tpu_torch.inference.sampling import scale_topk_per_row
    scaled = scale_topk_per_row(torch.from_numpy(logits), t, kv)
    jscaled = jscale(jnp.asarray(logits), jnp.full((B,), TEMP),
                     jnp.full((B,), top_k, jnp.int32))
    got = tro._seeded_pick(scaled, torch.from_numpy(u)).numpy()
    want = np.asarray(jro._seeded_pick(jscaled, jnp.asarray(u)))
    # the draws' distance to every bin edge, in f64
    p = np.exp(np.asarray(jscaled, np.float64)
               - np.asarray(jscaled, np.float64).max(-1, keepdims=True))
    cdf = np.cumsum(p, -1)
    total = cdf[:, -1]
    gap = np.abs(cdf - (u * total)[:, None]).min(-1) / total
    clear = gap > PICK_MARGIN
    assert clear.sum() >= B - 2
    assert (got[clear] == want[clear]).all()
    assert ((got >= 0) & (got < V)).all()


# ----------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------
def _engines(**engine_kw):
    kw = dict(ENGINE_KW, **engine_kw)
    je = jax_build_engine("llama", "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**kw))
    te = build_engine("llama", "tiny", params=jax.device_get(je.params),
                      engine_config=RaggedInferenceEngineConfig(**kw),
                      device="cpu", dtype=torch.float32)
    return je, te


def _prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _same_state(je, te):
    assert sorted(te.state.seqs) == sorted(je.state.seqs)
    for uid, d in je.state.seqs.items():
        t = te.state.seqs[uid]
        assert t.blocks == d.blocks
        assert t.seen_tokens == d.seen_tokens
        assert list(t.generated) == list(d.generated)
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]
    assert te.free_blocks == je.free_blocks


def _staged(je, te, prompts):
    """Prefill both engines and stage each request's greedy first token as
    its pending input (the state a serve loop hands to a group)."""
    uids = list(range(len(prompts)))
    je.put(uids, prompts)
    te.put(uids, prompts)
    while any(je.query(u) is None for u in uids):
        je.step()
        te.step()
    for u in uids:
        first = int(np.argmax(je.query(u)))
        np.testing.assert_allclose(te.query(u), je.query(u), **LOGIT_TOL)
        je.state.seqs[u].generated.append(first)
        te.state.seqs[u].generated.append(first)
    _same_state(je, te)
    return uids


def _same_groups(got, want):
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].dtype == np.int32
        assert got[u].tolist() == np.asarray(want[u]).tolist()


def _assert_greedy_unambiguous(je, prompt, chain):
    """The dense JAX forward over prompt + chain has a top-2 gap above
    MIN_TOP2_GAP at every generated position and picks the chain there."""
    seq = np.concatenate([prompt, chain[:-1]])[None].astype(np.int32)
    logits = np.asarray(_forward(je.cfg, je.params, jnp.asarray(seq))[0][0])
    rows = logits[len(prompt) - 1:]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MIN_TOP2_GAP
    assert rows.argmax(-1).tolist() == list(chain)


@pytest.mark.parametrize("k", [1, 8])
def test_greedy_groups_match_jax(k):
    """Three greedy groups: tokens, packed counts, generated,
    seen_tokens, block tables and d2h_fetches after every group."""
    je, te = _engines()
    prompts = _prompts(te.cfg.vocab_size)
    uids = _staged(je, te, prompts)
    assert te.supports_multi_step and te.supports_seeded_sampling
    for _ in range(3):
        fetches = te.profile["d2h_fetches"]
        want = je.decode_multi_step(uids=uids, k=k)
        got = te.decode_multi_step(uids=uids, k=k)
        _same_groups(got, want)
        assert all(len(got[u]) == k for u in uids)
        assert te.profile["d2h_fetches"] == fetches + 1
        _same_state(je, te)
    for u, p in zip(uids, prompts):
        d = je.state.seqs[u]
        _assert_greedy_unambiguous(je, p, np.asarray(d.generated))
        je.flush(u)
        te.flush(u)
    assert te.free_blocks == je.free_blocks == ENGINE_KW["num_blocks"]
    te.audit_blocks()


def _first_new(chain):
    """The first step j >= 1 whose token is not among the chain's earlier
    ones (an EOS there stops the row at step j exactly)."""
    return next(j for j in range(1, len(chain)) if chain[j] not in chain[:j])


def test_eos_and_budget_stop_inside_a_group_and_arena_matches():
    """Row 0 samples its EOS mid-group, row 1 meets a max_tokens budget of
    3; both stop there, the other rows run the whole group, and the arena
    after the group equals JAX's at every leased slot."""
    K = 8
    je0, te0 = _engines()
    prompts = _prompts(te0.cfg.vocab_size, seed=2)
    uids = _staged(je0, te0, prompts)
    free = je0.decode_multi_step(uids=uids, k=K)
    j = _first_new(list(free[0]))
    eos = int(free[0][j])

    je, te = _engines()
    _staged(je, te, prompts)
    seen = {u: te.state.seqs[u].seen_tokens for u in uids}
    kw = dict(uids=uids, k=K, eos_ids={0: eos},
              max_tokens={1: seen[1] + 3})
    want = je.decode_multi_step(**kw)
    got = te.decode_multi_step(**kw)
    _same_groups(got, want)
    assert got[0].tolist() == list(free[0][:j + 1])      # through its EOS
    assert got[1].tolist() == list(free[1][:3])          # its budget
    for u in uids[2:]:
        assert got[u].tolist() == list(free[u])
    assert te.state.seqs[0].seen_tokens == seen[0] + j + 1
    assert te.state.seqs[1].seen_tokens == seen[1] + 3
    _same_state(je, te)
    jk, jv = (np.asarray(je.arena[n]) for n in ("k", "v"))
    for u in uids:
        blocks = te.state.seqs[u].blocks
        for name, ja in (("k", jk), ("v", jv)):
            np.testing.assert_allclose(te.arena[name][:, blocks].numpy(),
                                       ja[:, blocks], **LOGIT_TOL)
    # slots past a stopped row's last token stay untouched (zero)
    for u, n in ((0, j + 1), (1, 3)):
        d = te.state.seqs[u]
        bs = ENGINE_KW["block_size"]
        for pos in range(d.seen_tokens, len(d.blocks) * bs):
            slot = te.arena["k"][:, d.blocks[pos // bs], pos % bs]
            assert not slot.any()
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert te.free_blocks == je.free_blocks == ENGINE_KW["num_blocks"]


def _host_chain(prompt, seed, first_pos, n):
    """The reference test's host chain: per-token logits from the JAX
    engine, f64 top-k (ties survive) softmax, `seeded_sample`."""
    je, _ = _engines()
    je.put([0], [prompt])
    while je.query(0) is None:
        je.step()
    je.state.seqs[0].generated.append(int(np.argmax(je.query(0))))
    out = []
    for j in range(n):
        logits = je.put([], [])[0]
        z = np.asarray(logits, np.float64) / TEMP
        kth = np.sort(z)[-min(TOPK, len(z))]
        z = np.where(z < kth, -np.inf, z)
        z -= z.max()
        p = np.exp(z)
        out.append(seeded_sample(seed, first_pos + j, p / p.sum()))
        je.state.seqs[0].generated.append(out[-1])
    return out


@pytest.mark.parametrize("k", [1, 8])
def test_seeded_groups_match_jax_and_the_host_chain(k):
    SEED, N = 777, 8
    je, te = _engines()
    prompts = _prompts(te.cfg.vocab_size, seed=3)[:1]
    _staged(je, te, prompts)
    kw = dict(uids=[0], temperature={0: TEMP}, top_k={0: TOPK},
              seeds={0: SEED})
    got_all, want_all = [], []
    for g in range(N // k):
        pos = 1 + g * k
        want = je.decode_multi_step(k=k, seed_positions={0: pos}, **kw)
        got = te.decode_multi_step(k=k, seed_positions={0: pos}, **kw)
        _same_groups(got, want)
        _same_state(je, te)
        got_all += got[0].tolist()
        want_all += want[0].tolist()
    assert got_all == _host_chain(prompts[0], SEED, 1, N)


def test_seeded_burst_matches_jax():
    SEED, N = 4242, 6
    je, te = _engines()
    prompts = _prompts(te.cfg.vocab_size, seed=4)
    uids = _staged(je, te, prompts)
    seeds = {0: SEED, 2: 2 ** 64 - 1}
    pos = {0: 1, 2: 5}
    for mode, temp, top_k in (("sample", TEMP, TOPK),
                              ("per_row", {0: TEMP, 1: 0.0, 2: 1.1},
                               {0: TOPK, 2: 0})):
        kw = dict(uids=[0, 1, 2], n_steps=N, mode=mode, temperature=temp,
                  top_k=top_k, seeds=seeds, seed_positions=pos)
        want = je.decode_burst_step(**kw)
        got = te.decode_burst_step(**kw)
        for u in (0, 2):
            assert got[u].tolist() == np.asarray(want[u]).tolist()
        if mode == "per_row":                 # row 1 is greedy there
            assert got[1].tolist() == np.asarray(want[1]).tolist()
        assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]
        pos = {u: p + N for u, p in pos.items()}
        if mode == "sample":
            # row 1 drew from each engine's own generator: realign it
            for e in (je, te):
                d = e.state.seqs[1]
                d.generated[-N:] = [int(t) for t in want[1]]
    _same_state(je, te)


def test_mixed_greedy_seeded_and_unseeded_rows():
    """Greedy and seeded rows token for token; the unseeded stochastic
    row (each engine's own generator) in count and termination only."""
    K = 8
    je, te = _engines()
    prompts = _prompts(te.cfg.vocab_size, seed=5)
    uids = _staged(je, te, prompts)
    seen = te.state.seqs[3].seen_tokens
    kw = dict(uids=uids, k=K, temperature={1: TEMP, 2: 1.0, 3: 1.0},
              top_k={1: TOPK}, seeds={1: 99, 2: 2 ** 63},
              seed_positions={1: 1, 2: 1}, max_tokens={3: seen + 5})
    want = je.decode_multi_step(**kw)
    got = te.decode_multi_step(**kw)
    for u in (0, 1, 2):
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    assert len(got[3]) == len(want[3]) == 5            # its budget
    assert ((got[3] >= 0) & (got[3] < te.cfg.vocab_size)).all()
    for u, d in je.state.seqs.items():
        assert te.state.seqs[u].seen_tokens == d.seen_tokens
        assert te.state.seqs[u].blocks == d.blocks
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]


def _adapters(cfg, n=2, seed=3):
    rng = np.random.RandomState(seed)
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size
    return {f"lx{i}": ((rng.randn(L, K, RANK) / np.sqrt(K)).astype(
        np.float32), rng.randn(L, RANK, H).astype(np.float32))
        for i in range(n)}


@pytest.mark.parametrize("k", [1, 8])
def test_lora_rows_in_groups_match_jax(k):
    """Adapter rows and base rows in one group (held as the multi-tenant
    engine tests hold them): tokens, state and fetches as JAX's, and the
    adapter rows move off the base model's chain."""
    je, te = _engines(full_prompt_prefill=False)
    L = te.cfg.num_layers
    pools = (JaxPool(je, 3 * L), AdapterPool(te, 3 * L))
    for pool in pools:
        for aid, (a, b) in _adapters(te.cfg).items():
            pool.register(aid, a, b)
    plan = {0: "lx0", 2: "lx1", 3: "lx0"}
    for pool, eng in zip(pools, (je, te)):
        for u, aid in plan.items():
            eng.set_adapter(u, pool.reserve(aid))
    prompts = _prompts(te.cfg.vocab_size, seed=6)
    uids = _staged(je, te, prompts)
    got_all = {u: [] for u in uids}
    for _ in range(8 // k):
        want = je.decode_multi_step(uids=uids, k=k, temperature={2: TEMP},
                                    seeds={2: 5}, seed_positions={
                                        2: len(got_all[2]) + 1})
        got = te.decode_multi_step(uids=uids, k=k, temperature={2: TEMP},
                                   seeds={2: 5}, seed_positions={
                                       2: len(got_all[2]) + 1})
        _same_groups(got, want)
        _same_state(je, te)
        for u in uids:
            got_all[u] += got[u].tolist()
    base_je, base_te = _engines(full_prompt_prefill=False)
    _staged(base_je, base_te, prompts)
    base = base_te.decode_multi_step(uids=uids, k=8)
    assert got_all[1] == base[1].tolist()
    assert got_all[0] != base[0].tolist()


# ----------------------------------------------------------------------
# the device-planned group against the host-planned burst
# ----------------------------------------------------------------------
def test_device_planned_burst_equals_host_planned_burst():
    """`decode_tokens` (planned on the device) against `decode_loop` over
    `_decode_core` (planned on the host) bit for bit: tokens and the whole
    arena, with padded rows whose zero block tables point at block 0 —
    the block a live row writes at offset 0 (position 16)."""
    from deepspeed_tpu_torch.models import get_model_config, init_params
    cfg = get_model_config("llama", "tiny", dtype=torch.float32,
                           num_layers=2, vocab_size=512)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                         torch.float32)
    B, MB, bs, nb = 6, 4, 16, 16
    arena = tro.init_arena(cfg, nb, bs, "cpu")
    gen = torch.Generator().manual_seed(2)
    for name in ("k", "v"):
        arena[name].normal_(generator=gen)
    tables = np.zeros((B, MB), np.int32)
    tables[0] = [5, 0, 6, 7]               # position 16 is block 0, slot 0
    tables[2] = [1, 2, 3, 4]
    tables[4] = [8, 9, 10, 11]
    active = np.array([1, 0, 1, 0, 1, 0], bool)
    lens = np.array([16, 0, 30, 0, 3, 0], np.int32)
    max_len = np.array([64, 1, 33, 1, 64, 1], np.int32)
    tokens = np.array([3, 0, 7, 0, 11, 0], np.int32)
    out = {}
    for name in ("device", "host"):
        a = {n: t.clone() for n, t in arena.items()}
        if name == "device":
            toks, a = tro.decode_tokens(cfg, params, a, tokens, lens, tables,
                                        active, None, max_len=max_len,
                                        n_steps=6)
        else:
            def core(a, t, ln):
                return tro._decode_core(cfg, params, a, t, ln, tables,
                                        active)
            toks, a = tro.decode_loop(core, a, torch.from_numpy(tokens),
                                      lens, None, max_len=max_len,
                                      n_steps=6)
        out[name] = (toks, a)
    assert torch.equal(out["device"][0][active], out["host"][0][active])
    for n in ("k", "v"):
        assert torch.equal(out["device"][1][n], out["host"][1][n])
    # the group wrote what a lockstep burst writes, nowhere else
    assert not torch.equal(out["device"][1]["k"], arena["k"])


def test_write_rows_keep_padded_rows_out():
    rows = tro.write_rows(np.array([0, 1, 0, 1, 1, 0], bool))
    assert rows.tolist() == [1, 3, 4, 1, 1, 1]
    assert tro.write_rows(np.zeros(3, bool)).tolist() == [0, 0, 0]


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------
def test_guards():
    _, te = _engines()
    prompts = _prompts(te.cfg.vocab_size)[:1]
    te.put([0], prompts)
    while te.query(0) is None:
        te.step()
    te.state.seqs[0].generated.append(int(np.argmax(te.query(0))))
    with pytest.raises(ValueError, match="k >= 1"):
        te.decode_multi_step(k=0)
    with pytest.raises(ValueError, match="seed_positions"):
        te.decode_multi_step(uids=[0], k=2, temperature={0: 1.0},
                             seeds={0: 1})
    with pytest.raises(ValueError, match="seed_positions"):
        te.decode_burst_step(uids=[0], n_steps=2, mode="sample",
                             seeds={0: 1})
    with pytest.raises(ValueError, match="greedy"):
        te.decode_burst_step(uids=[0], n_steps=2, mode="greedy",
                             seeds={0: 1}, seed_positions={0: 1})
    with pytest.raises(NotImplementedError, match="fsm"):
        te.decode_multi_step(uids=[0], k=2, fsm=object(),
                             fsm_states={0: 0})
    with pytest.raises(ValueError, match="per_row"):
        tro.sample_tokens_compiled(torch.zeros(2, 8), None, 1.0,
                                   seed_hi=torch.zeros(2), mode="sample")
    # nothing above touched the sequence
    assert te.state.seqs[0].seen_tokens == len(prompts[0])
    with pytest.raises(ValueError, match="per_row"):
        tro.decode_tokens(te.cfg, te.params, te.arena, [0], [1],
                          np.zeros((1, 16), np.int32), [True], None,
                          mode="sample", seed_hi=[0], seed_lo=[0],
                          seed_pos=[0], has_seed=[True])


def test_multi_step_and_seeds_refused_under_tp(tmp_path):
    """At tp 2 (two gloo ranks) the engine says it serves neither, and
    decode_multi_step raises the reference's RuntimeError, a seeded
    burst a RuntimeError too."""
    from deepspeed_tpu.models import Transformer as JaxTransformer
    from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
    model_kw = dict(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=128,
                    pos_emb="rope", norm="rmsnorm", activation="swiglu")
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, **model_kw))
    params = jax.device_get(model.init_params(jax.random.PRNGKey(3)))
    engine_kw = dict(num_blocks=64, block_size=8, max_blocks_per_seq=16,
                     max_seqs=4, prefill_chunk_size=16,
                     max_prefill_tokens_per_step=64,
                     full_prompt_prefill=False)
    outs = spawn_ranks(ranks.multistep_refused_tp, 2,
                       str(tmp_path / "store"),
                       args=(params, dict(model_kw, dtype=torch.float32),
                             engine_kw), timeout_s=RANK_TIMEOUT_S)
    for out in outs:
        assert out["supports"] == (False, False)
        assert "fused-TP" in out["multi_step"]
        assert "fused-TP" in out["seeded"]
