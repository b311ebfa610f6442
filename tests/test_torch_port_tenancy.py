"""The PyTorch port's multi-tenant serving against the JAX package.

- The port's `AdapterPool` and the JAX one, each over a stub engine with
  the multi-LoRA contract, driven through the same register / demote /
  promote / drop / reserve sequence: equal slots, counters, epoch, slot
  stacks and host spill (the int8 codes bit for bit).
- The tiny llama and gpt2 engines in f32 on the CPU, the port's built
  from the JAX engine's parameters, with the same adapters registered in
  each engine's own pool: mixed base and adapter rows, each request alone
  against all together, the merged [L, nb, bs, NKV*D] arena, and KV block
  read/write round trips.  The engines must make the same scheduling
  decisions (block tables and device-to-host fetches after every step)
  and the same greedy token chains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.serving.tenancy import AdapterPool as JaxPool
from deepspeed_tpu.serving.tenancy import AdapterUnavailable as JaxUnavail
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
                                              build_engine)
from deepspeed_tpu_torch.serving.tenancy import (AdapterError, AdapterPool,
                                                 AdapterUnavailable)

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_blocks=64, block_size=16, max_blocks_per_seq=16,
                 max_seqs=8, prefill_chunk_size=32,
                 max_prefill_tokens_per_step=64)
# 100 > the 64-token budget: that prompt is prefilled in 32-token chunks
PROMPT_LENS = (5, 17, 40, 100)
MAX_NEW = 8
# f32 engines agree on logits to ~1e-6 (tests/test_torch_port_engine.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
RANK = 4


# ----------------------------------------------------------------------
# the adapter pool
# ----------------------------------------------------------------------
class _StubEngine:
    """The multi-LoRA engine contract the pools probe for, recording what
    they attach; `device` is read by the port's pool only."""
    device = "cpu"

    def __init__(self):
        self.lora = None
        self.bindings = {}

    def attach_lora(self, lora):
        self.lora = lora

    def set_adapter(self, uid, slot):
        if slot < 0:
            self.bindings.pop(uid, None)
        else:
            self.bindings[uid] = slot


def _pool_state(pool):
    host = {aid: {k: (np.asarray(v) if k != "n" else v)
                  for k, v in e.items()} for aid, e in pool._host.items()}
    return dict(resident=dict(pool._resident), free=list(pool._free_slots),
                pins=dict(pool._pins), lru=list(pool._lru), host=host,
                stats=pool.stats(), epoch=pool.epoch, digest=pool.digest(),
                snapshot=pool.snapshot(), audit=pool.audit(),
                a=np.asarray(pool.engine.lora["a"]),
                b=np.asarray(pool.engine.lora["b"]))


def _assert_same_pool(jp, tp):
    js, ts = _pool_state(jp), _pool_state(tp)
    for key in ("a", "b"):
        np.testing.assert_array_equal(ts.pop(key), js.pop(key))
    jh, th = js.pop("host"), ts.pop("host")
    assert ts == js
    assert sorted(th) == sorted(jh)
    for aid in jh:
        assert sorted(th[aid]) == sorted(jh[aid])
        for k in jh[aid]:
            np.testing.assert_array_equal(th[aid][k], jh[aid][k])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_adapter_pool_matches_jax(quant):
    # L=2, K=4, r=2, H=4: 16 elements a layer = 1 page at block_elems=16,
    # so 2 blocks an adapter: 4 pool blocks are 2 slots, 4 host blocks
    # hold 2 spilled adapters
    rng = np.random.RandomState(0)
    factors = {f"a{i}": (rng.randn(2, 4, 2).astype(np.float32),
                         rng.randn(2, 2, 4).astype(np.float32))
               for i in range(4)}
    pools = [P(_StubEngine(), 4, block_elems=16, host_blocks=4, quant=quant)
             for P in (JaxPool, AdapterPool)]

    def both(op, *args, **kw):
        return [getattr(p, op)(*args, **kw) for p in pools]

    both("register", "a0", *factors["a0"])
    both("register", "a1", *factors["a1"], scaling=0.5)
    _assert_same_pool(*pools)
    both("register", "a2", *factors["a2"])              # demotes a0
    _assert_same_pool(*pools)
    assert pools[1].demotes == 1
    slots = both("reserve", "a0")                       # promotes a0
    assert slots[0] == slots[1]
    _assert_same_pool(*pools)
    assert pools[1].promotes == 1
    both("reserve", "a2")
    both("release", "a0")
    both("register", "a3", *factors["a3"])              # demotes a0
    _assert_same_pool(*pools)
    both("drop", "a1")                                  # from the host
    both("drop", "a3")                                  # resident
    _assert_same_pool(*pools)
    assert [p.can_reserve("a0") for p in pools] == [True, True]
    assert both("reserve", "a0")[0] == pools[1].slot_of("a0")
    _assert_same_pool(*pools)
    with pytest.raises(JaxUnavail):
        pools[0].reserve("a1")
    with pytest.raises(AdapterUnavailable):
        pools[1].reserve("a1")
    with pytest.raises(AdapterError, match="pinned"):
        pools[1].drop("a2")
    both("release", "a0")
    both("release", "a2")
    _assert_same_pool(*pools)
    assert pools[1]._pins == {}
    assert pools[1]._slot_a.dtype == torch.float32


# ----------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------
def _engines(arch, **engine_kw):
    kw = dict(ENGINE_KW, **engine_kw)
    je = jax_build_engine(arch, "tiny", dtype=jnp.float32,
                          engine_config=JaxCfg(**kw))
    te = build_engine(arch, "tiny", params=jax.device_get(je.params),
                      engine_config=RaggedInferenceEngineConfig(**kw),
                      device="cpu", dtype=torch.float32)
    return je, te


def _adapters(cfg, n=2, seed=3):
    """Rank-4 factors over the attention output projection: a scaled by
    1/sqrt(K), b unit normal, so each adapter moves the greedy chains."""
    rng = np.random.RandomState(seed)
    L, K, H = cfg.num_layers, cfg.num_heads * cfg.head_dim, cfg.hidden_size
    return {f"lx{i}": ((rng.randn(L, K, RANK) / np.sqrt(K)).astype(
        np.float32), rng.randn(L, RANK, H).astype(np.float32))
        for i in range(n)}


def _pools(je, te, adapters):
    """One pool per engine (3 slots, no host tier), the same adapters."""
    L = te.cfg.num_layers
    pools = (JaxPool(je, 3 * L), AdapterPool(te, 3 * L))
    for p in pools:
        for aid, (a, b) in adapters.items():
            p.register(aid, a, b)
    return pools


def _prompts(vocab, lens=PROMPT_LENS, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _bind(pools, engines, plan, first_uid=0):
    """Reserve and bind adapter `plan[i]` (None = base) to uid
    first_uid + i in each engine; returns the reservations to release."""
    held = []
    for i, aid in enumerate(plan):
        if aid is None:
            continue
        for pool, eng in zip(pools, engines):
            eng.set_adapter(first_uid + i, pool.reserve(aid))
        held.append(aid)
    return held


def _release(pools, held):
    for pool in pools:
        for aid in held:
            pool.release(aid)
        pool.audit()
        assert pool._pins == {}


def _same_state(je, te, out_j, out_t):
    assert sorted(out_t) == sorted(out_j)
    for uid in out_j:
        np.testing.assert_allclose(out_t[uid], out_j[uid], **LOGIT_TOL)
    assert sorted(te.state.seqs) == sorted(je.state.seqs)
    for uid, d in je.state.seqs.items():
        assert te.state.seqs[uid].blocks == d.blocks
        assert te.state.seqs[uid].seen_tokens == d.seen_tokens
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]


def _stepwise(je, te, prompts):
    """put/step both engines to first-token logits, then one decode step
    per call, checking the same state after every call."""
    uids = list(range(len(prompts)))
    _same_state(je, te, je.put(uids, prompts), te.put(uids, prompts))
    while any(je.query(u) is None for u in uids):
        _same_state(je, te, je.step(), te.step())
    firsts = [np.asarray([int(np.argmax(je.query(u)))], np.int32)
              for u in uids]
    _same_state(je, te, je.put(uids, firsts), te.put(uids, firsts))


def _generate(je, te, pools, prompts, plan):
    held = _bind(pools, (je, te), plan)
    want = je.generate_batch(prompts, max_new_tokens=MAX_NEW)
    got = te.generate_batch(prompts, max_new_tokens=MAX_NEW)
    _release(pools, held)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]
    assert te._adapter_slots == {} and je._adapter_slots == {}
    te.audit_blocks()
    return [g.tolist() for g in got]


PLAN = ["lx0", None, "lx1", "lx0"]      # the 100-token prompt is lx0's


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_mixed_adapter_and_base_rows_match_jax(arch):
    je, te = _engines(arch)
    pools = _pools(je, te, _adapters(te.cfg))
    prompts = _prompts(te.cfg.vocab_size)
    held = _bind(pools, (je, te), PLAN)
    _stepwise(je, te, prompts)
    for u in range(len(prompts)):
        je.flush(u)
        te.flush(u)
    _release(pools, held)
    lora = _generate(je, te, pools, prompts, PLAN)
    # the base row serves the base model's chain; adapter rows move
    base = [g.tolist() for g in te.generate_batch(prompts,
                                                  max_new_tokens=MAX_NEW)]
    assert lora[1] == base[1]
    assert all(lora[i] != base[i] for i in (0, 2, 3))


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_adapter_rows_alone_equal_together(arch):
    """Each request served alone through the port's engine gives what it
    gives in the mixed batch (which is the JAX engine's)."""
    je, te = _engines(arch)
    pools = _pools(je, te, _adapters(te.cfg))
    prompts = _prompts(te.cfg.vocab_size)
    together = _generate(je, te, pools, prompts, PLAN)
    for i, (aid, p) in enumerate(zip(PLAN, prompts)):
        held = _bind(pools[1:], (te,), [aid])
        alone = te.generate_batch([p], max_new_tokens=MAX_NEW)[0]
        _release(pools[1:], held)
        assert alone.tolist() == together[i]
    assert len({tuple(t) for t in together}) == len(PLAN)


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_merged_arena_matches_jax(arch):
    je, te = _engines(arch, arena_merged=True)
    cfg = te.cfg
    assert tuple(te.arena["k"].shape) == tuple(je.arena["k"].shape) == (
        cfg.num_layers, ENGINE_KW["num_blocks"], ENGINE_KW["block_size"],
        cfg.kv_heads * cfg.head_dim)
    pools = _pools(je, te, _adapters(cfg))
    prompts = _prompts(cfg.vocab_size)
    merged = _generate(je, te, pools, prompts, PLAN)
    # the same bytes as the 5-D arena's engine
    five = build_engine(arch, "tiny", params=te.params,
                        engine_config=RaggedInferenceEngineConfig(
                            **ENGINE_KW), device="cpu", dtype=torch.float32)
    pool5 = AdapterPool(five, 3 * cfg.num_layers)
    for aid, (a, b) in _adapters(cfg).items():
        pool5.register(aid, a, b)
    held = _bind((pool5,), (five,), PLAN)
    got5 = five.generate_batch(prompts, max_new_tokens=MAX_NEW)
    _release((pool5,), held)
    assert [g.tolist() for g in got5] == merged


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_kv_block_round_trips_match_jax(arch):
    """After prefill, each sequence's KV blocks are read out (one block,
    then spans), zeroed, and written back; decoding then continues as if
    nothing had moved, in both engines alike."""
    je, te = _engines(arch)
    prompts = _prompts(te.cfg.vocab_size, lens=(17, 40))
    uids = [0, 1]
    for e in (je, te):
        e.put(uids, prompts)
        while any(e.query(u) is None for u in uids):
            e.step()
    blocks = te.state.seqs[1].blocks
    assert blocks == je.state.seqs[1].blocks and len(blocks) >= 2
    kj, vj = je.read_kv_block(blocks[0])
    kt, vt = te.read_kv_block(blocks[0])
    assert tuple(kt.shape) == kj.shape == (
        te.cfg.num_layers, ENGINE_KW["block_size"], te.cfg.kv_heads,
        te.cfg.head_dim)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **LOGIT_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **LOGIT_TOL)
    for e in (je, te):
        for uid in uids:
            span = e.state.seqs[uid].blocks
            k, v = e.read_kv_blocks(span)
            assert tuple(k.shape)[:2] == (te.cfg.num_layers, len(span))
            e.write_kv_blocks(span, np.zeros_like(np.asarray(k)),
                              np.zeros_like(np.asarray(v)))
            e.write_kv_blocks(span, k, v)
        k1, v1 = e.read_kv_block(blocks[1])
        e.write_kv_block(blocks[1], k1, v1)
    je.read_kv_block(blocks[0])
    k_back, _ = te.read_kv_block(blocks[0])
    assert torch.equal(k_back, kt)
    assert te.profile["d2h_fetches"] == je.profile["d2h_fetches"]
    firsts = [np.asarray([int(np.argmax(je.query(u)))], np.int32)
              for u in uids]
    _same_state(je, te, je.put(uids, firsts), te.put(uids, firsts))
    # the reference's refusals
    for e in (je, te):
        k, v = e.read_kv_blocks(blocks[:2])
        with pytest.raises(ValueError, match="duplicate"):
            e.write_kv_blocks([blocks[0], blocks[0]], k, v)
        with pytest.raises(ValueError, match="does not fit|do not fit"):
            e.write_kv_blocks(blocks[:1], k, v)
        with pytest.raises(ValueError, match="bad block id"):
            e.read_kv_block(ENGINE_KW["num_blocks"])


def test_engine_lora_contract_refusals():
    """attach_lora's shape checks and set_adapter's two refusals, as in
    the reference."""
    _, te = _engines("gpt2")
    L = te.cfg.num_layers
    with pytest.raises(RuntimeError, match="attach_lora first"):
        te.set_adapter(0, 0)
    a = torch.zeros(L, 2, 8, RANK)
    with pytest.raises(ValueError, match="stack"):
        te.attach_lora({"a": a, "b": torch.zeros(L, 2, RANK + 1, 8)})
    with pytest.raises(ValueError, match="layers"):
        te.attach_lora({"a": a[:1], "b": torch.zeros(1, 2, RANK, 8)})
    te.attach_lora({"a": a, "b": torch.zeros(L, 2, RANK, 8)})
    te.put([0], [np.arange(5, dtype=np.int32)])
    with pytest.raises(RuntimeError, match="began prefill"):
        te.set_adapter(0, 1)
    te.set_adapter(7, 1)
    assert te._batch_adapter_ids([te.state.seqs[0]], 4) is None
    te.set_adapter(7, -1)
    te.set_adapter(0, -1)
    te.flush(0)
    assert te._adapter_slots == {}
    assert te.supports_lora
