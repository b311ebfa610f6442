"""The port's fp8 serving weights against the JAX package on the CPU.

- `quantize_serving_weights`: the codes (compared as uint8) and scales
  bit for bit the JAX function's, at column and group granularity (a
  last dim that the group size divides and one it does not).
- `resolve_weight`: the reference test's round trip (within 7% of the
  weights' max, e4m3's two digits).
- `_dense` on fp8 dicts against the JAX `_dense`: f32 rows at 1e-5 of
  the output's max; bf16 rows within one bf16 ulp of it (the column
  scale multiplies the f32 product, which is rounded once).
- swiglu and GQA leaves (every matmul key a dict) and the plain forward
  on fp8 weights against JAX's at 1e-4 (the reference test's bound on the
  quantization error, 0.5, and its near-tie rule for a flipped argmax,
  are held against the unquantized forward).
- The engine on fp8 parameters carried by `params_from_jax`: codes keep
  their byte and scales f32, and put/step, a burst, a step group and a
  verify dispatch give the JAX engine's logits (1e-4) and tokens.
- `q_bits=6` raises, as the reference; a dict of other keys is refused;
  fp8 under the fused ring raises the reference's reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxCfg
from deepspeed_tpu.inference.v2 import build_engine as jax_build_engine
from deepspeed_tpu.inference.v2 import ragged_ops as jops
from deepspeed_tpu.models import Transformer as JaxTransformer
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import (Transformer, get_model_config,
                                        params_from_jax)
from deepspeed_tpu_torch.models import transformer as ttr

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_blocks=64, block_size=8, max_blocks_per_seq=16,
                 max_seqs=4, prefill_chunk_size=16,
                 max_prefill_tokens_per_step=32)
KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate")
# the engine tests' bound (tests/test_torch_port_engine.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _codes(x):
    """fp8 codes as uint8 bytes (JAX's ml_dtypes array or torch's)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("granularity", ["column", "group"])
@pytest.mark.parametrize("shape", [(2, 256, 384), (3, 96, 200)])
def test_quantize_matches_jax_bit_for_bit(granularity, shape):
    """Codes and scales equal the JAX function's, with outliers in the
    weights and a last dim of 200 (no 128-group: one group a row)."""
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[0, 1, 2] = 3.0
    w[-1, -1, -1] = -1e-7
    want = jtr.quantize_serving_weights(
        {"layers": {"wq": jnp.asarray(w), "x": jnp.ones(2)}},
        granularity=granularity)
    got = ttr.quantize_serving_weights(
        {"layers": {"wq": torch.from_numpy(w), "x": torch.ones(2)}},
        granularity=granularity)
    key = "q_col_scales" if granularity == "column" else "q_scales"
    a, b = want["layers"]["wq"], got["layers"]["wq"]
    assert sorted(b) == sorted(a) == sorted(["q_codes", key])
    assert b["q_codes"].dtype == torch.float8_e4m3fn
    assert b[key].dtype == torch.float32
    np.testing.assert_array_equal(_codes(b["q_codes"]), _codes(a["q_codes"]))
    np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]))
    assert torch.equal(got["layers"]["x"], torch.ones(2))


def test_resolve_weight_roundtrip():
    w = torch.from_numpy(np.random.RandomState(1).randn(4, 256, 384)
                         .astype(np.float32)) * 0.1
    pq = ttr.quantize_serving_weights({"layers": {"wq": w}}, group_size=128,
                                      granularity="group")
    back = ttr.resolve_weight(pq["layers"]["wq"], torch.float32)
    assert back.shape == w.shape
    np.testing.assert_allclose(back.numpy(), w.numpy(),
                               atol=float(w.abs().max()) * 0.07)
    # and as JAX resolves the same codes
    jq = jtr.quantize_serving_weights({"layers": {"wq": jnp.asarray(
        w.numpy())}}, group_size=128, granularity="group")
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jtr.resolve_weight(jq["layers"]["wq"],
                                                    jnp.float32)))


@pytest.mark.parametrize("granularity", ["column", "group"])
def test_fp8_dense_matches_jax(granularity):
    """`_dense` of rows [N, H] on one layer's fp8 dict (and a bias):
    f32 rows against the JAX `_dense` at 1e-5 of the output's max, bf16
    rows within one bf16 ulp of it; the plain-weight `_dense` is
    unchanged (the f32 product of the same weights)."""
    rng = np.random.RandomState(2)
    w = (rng.randn(1, 128, 96) * 0.05).astype(np.float32)
    h = rng.randn(17, 128).astype(np.float32)
    b = rng.randn(96).astype(np.float32)
    jq = jtr.quantize_serving_weights({"layers": {"wq": jnp.asarray(w)}},
                                      granularity=granularity)
    jw = {k: v[0] for k, v in jq["layers"]["wq"].items()}
    tq = ttr.quantize_serving_weights({"layers": {"wq": torch.from_numpy(
        w)}}, granularity=granularity)
    tw = ttr._layer_params(tq["layers"], 0)["wq"]
    for jdt, tdt, rel in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)):
        want = np.asarray(jops._dense(jnp.asarray(h, jdt), jw,
                                      jnp.asarray(b, jdt)).astype(
                                          jnp.float32))
        got = ttr._dense(torch.from_numpy(h).to(tdt), tw,
                         torch.from_numpy(b).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * float(np.abs(want).max()))
    plain = ttr._dense(torch.from_numpy(h), torch.from_numpy(w[0]))
    np.testing.assert_allclose(plain.numpy(), h @ w[0], rtol=1e-5,
                               atol=1e-5)


def test_swiglu_gqa_leaves_and_forward_match_jax():
    """Llama tiny (swiglu, GQA): every matmul key becomes a dict; the
    port's forward on the JAX fp8 tree (through `params_from_jax`)
    equals the JAX forward at 1e-4, and both stay within the reference
    test's 0.5 of the unquantized logits (an argmax flipped only
    between near-tied tokens)."""
    cfg = jax_model_config("llama", "tiny", dtype=jnp.float32,
                           vocab_size=2048)
    m = JaxTransformer(cfg)
    p = m.init_params(jax.random.PRNGKey(2))
    pq = jtr.quantize_serving_weights(p)
    for k in KEYS:
        assert isinstance(pq["layers"][k], dict), k
    tcfg = get_model_config("llama", "tiny", dtype=torch.float32,
                            vocab_size=2048)
    tp = params_from_jax(jax.device_get(pq), tcfg, "cpu")
    for k in KEYS:
        assert tp["layers"][k]["q_codes"].dtype == torch.float8_e4m3fn
        assert tp["layers"][k]["q_col_scales"].dtype == torch.float32
    ids = np.random.RandomState(1).randint(0, 2048, (2, 16)).astype(
        np.int32)
    want = np.asarray(m.forward(pq, jnp.asarray(ids)))
    got = Transformer(tcfg).forward(tp, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)
    full = np.asarray(m.forward(p, jnp.asarray(ids)))
    got = got.detach().numpy()
    eps = float(np.abs(got - full).max())
    assert eps < 0.5
    # an argmax may flip only between tokens whose unquantized logits sit
    # within the fp8 perturbation (the reference test's rule)
    for i in range(got.shape[0]):
        a, b = int(full[i, -1].argmax()), int(got[i, -1].argmax())
        assert full[i, -1, a] - full[i, -1, b] <= 2 * eps


def _fp8_engines(granularity, family="llama", **kw):
    ekw = dict(ENGINE_KW)
    base = jax_build_engine(family, "tiny", dtype=jnp.float32,
                            engine_config=JaxCfg(**ekw), **kw)
    pq = jtr.quantize_serving_weights(base.params, granularity=granularity)
    je = JaxEngine(base.cfg, params=pq, config=JaxCfg(**ekw))
    te = InferenceEngineV2(get_model_config(family, "tiny",
                                            dtype=torch.float32, **kw),
                           params=jax.device_get(pq),
                           config=RaggedInferenceEngineConfig(**ekw),
                           device="cpu")
    return je, te


@pytest.mark.parametrize("family,kw", [("llama", dict(vocab_size=2048)),
                                       ("gpt2", {})], ids=["llama", "gpt2"])
@pytest.mark.parametrize("granularity", ["column", "group"])
def test_fp8_engine_matches_jax(granularity, family, kw):
    """The engine on the JAX fp8 tree: codes 1 byte and scales f32 on the
    engine; put/step logits (1e-4), a greedy burst, a greedy step group
    and a verify dispatch (tokens and counts) as the JAX engine's."""
    je, te = _fp8_engines(granularity, family, **kw)
    key = "q_col_scales" if granularity == "column" else "q_scales"
    for k, leaf in te.params["layers"].items():
        if k in KEYS:
            assert leaf["q_codes"].dtype == torch.float8_e4m3fn
            assert leaf["q_codes"].element_size() == 1
            assert leaf[key].dtype == torch.float32
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, te.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 40)]
    uids = [0, 1, 2]
    for got, want in ((te.put(uids, prompts), je.put(uids, prompts)),):
        for u in want:
            np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    while any(je.query(u) is None for u in uids):
        want, got = je.step(), te.step()
        assert sorted(got) == sorted(want)
        for u in want:
            np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    for u in uids:
        first = int(np.argmax(je.query(u)))
        for e in (je, te):
            e.state.seqs[u].generated.append(first)
    want = je.decode_burst_step(uids=uids, n_steps=4)
    got = te.decode_burst_step(uids=uids, n_steps=4)
    for u in uids:
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    want = je.decode_multi_step(uids=uids, k=3)
    got = te.decode_multi_step(uids=uids, k=3)
    for u in uids:
        assert got[u].tolist() == np.asarray(want[u]).tolist()
    drafts = {0: [1, 2, 3], 1: [], 2: [int(te.state.seqs[2].generated[-1])]}
    want = je.decode_burst_step(uids=uids, drafts=drafts, draft_span=4)
    got = te.decode_burst_step(uids=uids, drafts=drafts, draft_span=4)
    for u in uids:
        assert got[u][0].tolist() == np.asarray(want[u][0]).tolist()
        assert got[u][1:] == tuple(int(x) for x in want[u][1:])
    assert te.profile == je.profile


def test_fp8_refusals():
    """q_bits != 8 raises with the reference's words; a dict leaf of
    other keys is refused by name; an fp8 tree under the fused ring
    raises the reference's reason (no process group needed)."""
    with pytest.raises(NotImplementedError, match="fp8"):
        ttr.quantize_serving_weights({"layers": {"wq": torch.zeros(
            2, 64, 128)}}, q_bits=6)
    with pytest.raises(NotImplementedError, match="fp8"):
        jtr.quantize_serving_weights({"layers": {"wq": jnp.zeros(
            (2, 64, 128))}}, q_bits=6)
    with pytest.raises(ValueError, match="granularity"):
        ttr.quantize_serving_weights({"layers": {"wq": torch.zeros(
            2, 64, 128)}}, granularity="row")
    cfg = get_model_config("llama", "tiny", dtype=torch.float32,
                           vocab_size=2048)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    odd = dict(params, layers=dict(params["layers"], wq={
        "codes": params["layers"]["wq"]}))
    with pytest.raises(NotImplementedError, match="q_codes"):
        InferenceEngineV2(cfg, params=odd, device="cpu")
    pq = ttr.quantize_serving_weights(params)
    with pytest.raises(ValueError, match="fp8 serving-weight dicts are not "
                                         "TP-sharded"):
        InferenceEngineV2(cfg, params=pq, device="cpu",
                          config=RaggedInferenceEngineConfig(
                              tensor_parallel_size=2,
                              tp_collectives="fused", **ENGINE_KW))
    # the port's own transform serves too (no JAX tree involved)
    eng = InferenceEngineV2(cfg, params=pq, device="cpu",
                            config=RaggedInferenceEngineConfig(**ENGINE_KW))
    assert eng.params["layers"]["w_gate"]["q_codes"].dtype == \
        torch.float8_e4m3fn
    out = eng.put([0], [np.arange(1, 9, dtype=np.int32)])
    assert np.isfinite(out[0]).all()
