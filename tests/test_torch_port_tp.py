"""The PyTorch port's fused tensor-parallel serving against the JAX package.

Counterparts of tests/test_tp_inference.py.  The JAX side runs here, on
the harness's 8 virtual CPU devices; the port's ranks run in processes of
their own (`comm.spawn_ranks`, start method "spawn", gloo, one thread
each), meeting at a file store in the test's tmp_path, and are joined
under a time limit of their own: a rank that hangs fails its test.  The
rank functions live in tests/_torch_tp_ranks.py, which imports the port
only.  Inputs come from numpy seeds; parameters are the JAX initializer's,
handed to both sides as numpy arrays.

On the CPU the tile GEMM is its plain version (the f32 product of the
exactly widened inputs) and attention the paged kernels' plain versions;
tests/test_torch_port_cuda.py holds the kernel on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_tp_ranks as ranks
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.models import Transformer as JaxTransformer
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.comm import spawn_ranks
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import ragged_ops
from deepspeed_tpu_torch.inference.v2.tp_ragged import \
    tp_fused_unsupported_reason
from deepspeed_tpu_torch.models import (TransformerConfig, get_model_config,
                                        init_params, shard_params_tp)
from deepspeed_tpu_torch.models.convert import TP_SPLIT_DIMS
from deepspeed_tpu_torch.models.transformer import quantize_serving_weights
from deepspeed_tpu_torch.ops import tp_matmul as ttm

pytestmark = pytest.mark.serving

# the reference test's tiny f32 Llama (`_model`) and engine (`_engine`)
MODEL_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=128, pos_emb="rope",
                norm="rmsnorm", activation="swiglu")
ENGINE_KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=16,
                 max_seqs=4, prefill_chunk_size=16,
                 max_prefill_tokens_per_step=64, full_prompt_prefill=False)
# tp vs tp1 and vs JAX, f32: the ring reorders f32 sums (the reference's
# bound)
TP_TOL = dict(rtol=2e-4, atol=2e-4)
# spawned ranks: import torch and the port (~3 s each), then a tiny model
RANK_TIMEOUT_S = 180


def _jax_model():
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, **MODEL_KW))
    return model, jax.device_get(model.init_params(jax.random.PRNGKey(3)))


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 128, n).astype(np.int32) for n in (25, 7)]


def _spawn(tmp_path, fn, world, *args):
    return spawn_ranks(fn, world, str(tmp_path / "store"), args=args,
                       timeout_s=RANK_TIMEOUT_S)


# ----------------------------------------------------------------------
# ops/tp_matmul.py
# ----------------------------------------------------------------------
def test_tile_matmul_plain_matches_jax(monkeypatch):
    """The plain version against the Pallas tile kernel in interpret mode
    (patched as the reference test does, multi-block K included) and
    against the jnp escape at shapes the TPU tile rule refuses."""
    import jax.experimental.pallas as pl
    import deepspeed_tpu.ops.attention as attention_mod
    import deepspeed_tpu.ops.tp_matmul as jtm
    monkeypatch.setattr(jtm.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(attention_mod, "_on_tpu", lambda: True)
    rng = np.random.RandomState(0)
    for (M, K, N) in ((16, 256, 128), (8, 512, 384), (64, 128, 128)):
        x = rng.randn(M, K).astype(np.float32)
        w = rng.randn(K, N).astype(np.float32)
        want = np.asarray(jtm.tile_matmul(jnp.asarray(x), jnp.asarray(w),
                                          impl="pallas"))
        got = ttm.tile_matmul(torch.from_numpy(x), torch.from_numpy(w))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # shapes with no MXU tiling (local ffn 2752 at Llama-2-7B tp 4, an
    # odd vocabulary chunk, one row) and bf16 inputs
    for (M, K, N) in ((1, 2752, 1001), (5, 100, 60)):
        assert not jtm.tile_matmul_supported(M, K, N)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            x = rng.randn(M, K).astype(np.float32)
            w = rng.randn(K, N).astype(np.float32)
            want = np.asarray(jtm.tile_matmul(
                jnp.asarray(x, jdt), jnp.asarray(w, jdt), impl="jnp"))
            got = ttm.tile_matmul(torch.from_numpy(x).to(dt),
                                  torch.from_numpy(w).to(dt))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-4)
    # the kernel is asked for where there is none: refused, no fallback
    with pytest.raises(ValueError, match="kernel"):
        ttm.tile_matmul(torch.zeros(2, 3), torch.zeros(3, 4), impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ttm.tile_matmul(torch.zeros(2, 3), torch.zeros(3, 4), impl="pallas")
    with pytest.raises(ValueError, match="w \\[K, N\\]"):
        ttm.tile_matmul(torch.zeros(2, 3), torch.zeros(4, 4))


def test_ring_matches_twins_and_overlaps(tmp_path, devices8):
    """tp 4 on gloo: the fused ring and its unfused twins against the
    replicated product and JAX's ring on the same block; the all-gather
    matmul and the reduce-scatter matmul each take tp-1 hops, tp GEMMs,
    and issue each hop's GEMM before its wait."""
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.ops.tp_matmul import ag_matmul, matmul_rs, tile_matmul
    from deepspeed_tpu.parallel.mesh import AXIS_TP, make_mesh
    from deepspeed_tpu.utils.jax_compat import shard_map
    tp = 4
    rng = np.random.RandomState(0)
    S, H, F = 16, 32, 64
    x = rng.randn(S, H).astype(np.float32)
    w1 = rng.randn(H, F).astype(np.float32)
    w2 = rng.randn(F, H).astype(np.float32)
    ref = np.asarray(jnp.tanh(jnp.asarray(x) @ w1) @ w2)
    topo = make_mesh(dp=1, tp=tp, devices=devices8[:tp])

    def f(x, w1, w2):
        y = ag_matmul(x, AXIS_TP, tp, lambda c: tile_matmul(
            c, w1, impl="jnp").astype(x.dtype))
        return matmul_rs(jnp.tanh(y), AXIS_TP, tp,
                         lambda c: tile_matmul(c, w2, impl="jnp"))
    jax_ring = np.asarray(jax.jit(shard_map(
        f, mesh=topo.mesh, axis_names={AXIS_TP},
        in_specs=(P(AXIS_TP, None), P(None, AXIS_TP), P(AXIS_TP, None)),
        out_specs=P(AXIS_TP, None), check_vma=False))(x, w1, w2))

    res = _spawn(tmp_path, ranks.ring_block, tp, x, w1, w2)
    fused = np.concatenate([r[0] for r in res])
    twin = np.concatenate([r[1] for r in res])
    for got in (fused, twin):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jax_ring, rtol=1e-5, atol=1e-5)
    for _, _, log_ag, log_rs in res:
        for log in (log_ag, log_rs):
            assert log.count("hop") == tp - 1
            assert log.count("mm") == tp
            hops = [i for i, e in enumerate(log) if e == "hop"]
            for h in hops:
                after = log[h + 1:]
                assert "mm" in after and "wait" in after
                assert after.index("mm") < after.index("wait")


# ----------------------------------------------------------------------
# engine parity and refusals
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tp2_served(tmp_path_factory):
    """The JAX tp 2 fused engine (here), the port at tp 1 (here) and at
    tp 2 (two gloo ranks) through the same greedy drive."""
    model, params = _jax_model()
    prompts = _prompts()
    jeng = JaxEngine(model, params=params,
                     config=JaxCfg(tensor_parallel_size=2,
                                   tp_collectives="fused", **ENGINE_KW))
    jax_out = ranks._drive(jeng, prompts)
    cfg_kw = dict(MODEL_KW, dtype=torch.float32)
    port1 = ranks._drive(ranks.engine(params, cfg_kw, ENGINE_KW),
                         prompts)
    port2 = spawn_ranks(ranks.serve_tp, 2,
                        str(tmp_path_factory.mktemp("tp2") / "store"),
                        args=(params, cfg_kw, ENGINE_KW, prompts),
                        timeout_s=RANK_TIMEOUT_S)
    return jax_out, port1, port2


def test_tp2_greedy_serving_parity(tp2_served):
    """Port tp 2 against port tp 1 and the JAX tp 2 fused engine: prefill
    and continuation logits within 2e-4, burst, verify dispatch (tokens,
    drafted and accepted counts) and generate_batch greedy chains token
    for token, every rank alike."""
    jax_out, port1, port2 = tp2_served
    for out in port2:
        assert out["arena"] == (2, 64, 8, 1, 16)       # NKV/tp local heads
        for want in (port1, jax_out):
            for key in ("prefill", "cont"):
                assert sorted(out[key]) == sorted(want[key])
                for u in want[key]:
                    np.testing.assert_allclose(out[key][u], want[key][u],
                                               **TP_TOL)
            for u in (0, 1):
                np.testing.assert_array_equal(out["burst"][u],
                                              want["burst"][u])
            assert out["verify"] == want["verify"]
            assert out["chains"] == want["chains"]


def test_tp2_verify_spans_give_tp1_tokens(tp2_served):
    """Verify spans over the fused ring at tp 2: the greedy dispatch's
    tokens and counts equal tp 1's and the JAX tp 2 engine's (in the
    drive above); a per_row dispatch at temperature 0.9 takes the same
    decisions on both ranks, each row emitting 1 to 4 tokens, a rejected
    draft token never its own replacement."""
    jax_out, port1, port2 = tp2_served
    for out in port2:
        assert out["verify"] == port1["verify"] == jax_out["verify"]
    assert port2[0]["sampled"] == port2[1]["sampled"]
    for d in port2[0]["sampled"]:
        for u, (toks, accepted) in d.items():
            assert 1 <= len(toks) == accepted + 1 <= 4
            if u == 20 and accepted < 3:
                assert toks[accepted] != [1, 2, 3][accepted]


# Phi-3 at head dim 96 with longrope over an original context of 12: the
# 25-token prompt embeds in the long band, the 7-token one in the short
# band until its decode crosses position 12
PHI3_KW = dict(vocab_size=128, hidden_size=384, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=256, max_seq_len=256,
               pos_emb="rope", norm="rmsnorm", activation="swiglu",
               tie_embeddings=False,
               rope_scaling=("longrope",
                             float(np.sqrt(1 + np.log(8.0) / np.log(12.0))),
                             12.0, tuple(1.0 + 0.05 * i for i in range(48)),
                             tuple(1.0 + 0.5 * i for i in range(48))))


def test_tp2_phi3_longrope_d96_gives_tp1_tokens(tmp_path):
    """The fused ring at tp 2 serves a Phi-3 block at head dim 96 with
    longrope: the same greedy drive as tp 1's, logits within 2e-4,
    tokens equal, on both ranks."""
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, **PHI3_KW))
    params = jax.device_get(model.init_params(jax.random.PRNGKey(5)))
    cfg_kw = dict(PHI3_KW, dtype=torch.float32)
    prompts = _prompts()
    port1 = ranks._drive(ranks.engine(params, cfg_kw, ENGINE_KW), prompts)
    port2 = _spawn(tmp_path, ranks.serve_tp, 2, params, cfg_kw, ENGINE_KW,
                   prompts)
    for out in port2:
        assert out["arena"] == (2, 64, 8, 1, 96)
        for key in ("prefill", "cont"):
            for u in port1[key]:
                np.testing.assert_allclose(out[key][u], port1[key][u],
                                           **TP_TOL)
        for u in (0, 1):
            np.testing.assert_array_equal(out["burst"][u], port1["burst"][u])
        assert out["verify"] == port1["verify"]
        assert out["chains"] == port1["chains"]
        assert out["tile_launches"] == 0     # the CPU runs the plain GEMM


def test_tp_fused_refuses_unsupported_layouts(tp2_served):
    """The reference's refusals, each by name: layouts the fused forward
    does not serve (its reasons), "fused" at tp 1, the GSPMD "xla" mode
    at tp > 1 (not carried), fp8 weight dicts (the reference's reason),
    and on a built tp engine LoRA adapters and KV block IO."""
    _, params = _jax_model()
    cfg = TransformerConfig(dtype=torch.float32, **MODEL_KW)

    def build(cfg=cfg, **kw):
        return InferenceEngineV2(cfg, params=params, device="cpu",
                                 config=RaggedInferenceEngineConfig(
                                     **dict(ENGINE_KW, **kw)))

    fused2 = dict(tensor_parallel_size=2, tp_collectives="fused")
    with pytest.raises(ValueError, match="tensor_parallel_size > 1"):
        build(tp_collectives="fused")
    with pytest.raises(ValueError, match="tp_collectives"):
        build(tensor_parallel_size=2, tp_collectives="ring")
    with pytest.raises(NotImplementedError, match="'xla'"):
        build(tensor_parallel_size=2)
    with pytest.raises(ValueError, match="max_seqs=3 must divide by tp=2"):
        build(max_seqs=3, **fused2)
    with pytest.raises(ValueError, match="merged"):
        build(arena_merged=True, **fused2)
    fp8 = quantize_serving_weights(init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="fp8 serving-weight dicts are not "
                                         "TP-sharded"):
        InferenceEngineV2(cfg, params=fp8, device="cpu",
                          config=RaggedInferenceEngineConfig(
                              **dict(ENGINE_KW, **fused2)))
    with pytest.raises(ValueError, match="kv_heads=1 must divide by tp=2"):
        build(cfg=TransformerConfig(dtype=torch.float32,
                                    **dict(MODEL_KW, num_kv_heads=1)),
              **fused2)
    # the port's config refuses post-norm blocks itself (it is frozen and
    # validates on construction); the fused-TP reason is the reference's
    # all the same
    post = TransformerConfig(dtype=torch.float32, **MODEL_KW)
    object.__setattr__(post, "post_norm", True)
    meta = {"k": torch.empty(2, 4, 8, 2, 16, device="meta")}
    tp2 = RaggedInferenceEngineConfig(**dict(ENGINE_KW, **fused2))
    assert "post-norm / parallel-residual" in tp_fused_unsupported_reason(
        post, tp2, params, meta)
    with pytest.raises(ValueError, match="post-norm"):
        build(cfg=post, **fused2)
    # a layout it serves, with no process group: refused by name
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        build(**fused2)
    for out in tp2_served[2]:
        for what, msg in out["refused"].items():
            assert msg is not None, f"{what} was not refused"
            assert "not carried by the PyTorch port" in msg


def test_tp1_default_engine_untouched():
    """tp 1 builds no process group and no TP programs, and its serving
    calls are exactly the ragged_ops programs: its logits equal theirs
    on the same host metadata."""
    _, params = _jax_model()
    cfg = TransformerConfig(dtype=torch.float32, **MODEL_KW)
    eng = InferenceEngineV2(cfg, params=params, device="cpu",
                            config=RaggedInferenceEngineConfig(**ENGINE_KW))
    assert eng.tp == 1 and eng._tpp is None and eng.topology is None
    assert eng.config.tp_collectives == "xla"
    assert not dist.is_initialized()
    assert eng.arena["k"].shape == (2, 64, 8, 2, 16)
    prompts = _prompts()
    snap = {k: v.clone() for k, v in eng.arena.items()}
    out = eng.put([0, 1], prompts)              # one chunked-prefill call
    C = ENGINE_KW["prefill_chunk_size"]
    NC = 4                                      # 25 -> 16 + 9, 7: 3 slots
    tokens = np.zeros((NC, C), np.int32)
    pos0s, nval = np.zeros(NC, np.int32), np.zeros(NC, np.int32)
    tables = np.zeros((NC, ENGINE_KW["max_blocks_per_seq"]), np.int32)
    active = np.zeros(NC, bool)
    for i, (u, start, n) in enumerate(((0, 0, 16), (0, 16, 9), (1, 0, 7))):
        tokens[i, :n] = prompts[u][start:start + n]
        pos0s[i], nval[i], active[i] = start, n, True
        tables[i] = eng.state.block_table(eng.state.seqs[u])
    want, _ = ragged_ops.prefill_chunks(cfg, eng.params, snap, tokens,
                                        pos0s, nval, tables, active)
    assert torch.equal(torch.from_numpy(out[0]), want[1])
    assert torch.equal(torch.from_numpy(out[1]), want[2])
    assert torch.equal(snap["k"], eng.arena["k"])
    assert torch.equal(snap["v"], eng.arena["v"])


# ----------------------------------------------------------------------
# weights carried across
# ----------------------------------------------------------------------
def test_tp_split_dims_are_the_reference_rules():
    """The port's copy of the partition rules says what the reference's
    `_TP_RULES` say for every dense leaf (MoE leaves are refused)."""
    from deepspeed_tpu.models.transformer import _TP_RULES
    from deepspeed_tpu.parallel.mesh import AXIS_TP
    dense = {k: spec for k, spec in _TP_RULES.items()
             if not k.startswith("moe_")}
    assert set(dense) == set(TP_SPLIT_DIMS)
    for name, spec in dense.items():
        assert list(spec).index(AXIS_TP) == TP_SPLIT_DIMS[name]


@pytest.mark.parametrize("arch", ["llama", "qwen2"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_tp_reassembles(arch, tp):
    """Each rank's shard, concatenated along the split dims, is the full
    tree exactly (torch and numpy leaves); every other leaf is kept
    whole."""
    cfg = get_model_config(arch, "tiny", dtype=torch.float32,
                           vocab_size=512)
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for tree, cat in ((full, torch.cat),
                      ({k: ({kk: vv.numpy() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.numpy())
                        for k, v in full.items()}, np.concatenate)):
        shards = [shard_params_tp(tree, tp, r) for r in range(tp)]
        for key, val in full.items():
            leaves = val if isinstance(val, dict) else {key: val}
            for name, want in leaves.items():
                got = [s[key][name] if isinstance(val, dict) else s[key]
                       for s in shards]
                dim = TP_SPLIT_DIMS.get(name)
                if dim is None:
                    kept = (tree[key][name] if isinstance(val, dict)
                            else tree[key])
                    assert all(g is kept for g in got)
                    continue
                assert got[0].shape[dim] * tp == want.shape[dim]
                whole = cat(got, dim) if cat is np.concatenate \
                    else cat(got, dim=dim)
                np.testing.assert_array_equal(np.asarray(whole),
                                              want.numpy())
    assert "bq" in full["layers"] or arch == "llama"
    with pytest.raises(ValueError, match="divisible"):
        shard_params_tp(full, 3, 0)
