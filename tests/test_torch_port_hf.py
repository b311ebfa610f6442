"""HF checkpoints through the port: `models.hf_loader` and
`inference.v2.build_hf_engine`, against the JAX package's loader and the
HF torch forward, on the CPU.

HF models are built from a config in memory (no download), as
tests/test_hf_loader.py builds them.  For each: the port's converted
parameters equal the JAX loader's exactly, and the port's engine (f32,
paged prefill and decode through the kernels' plain versions) gives the
HF forward's logits within 2e-4 — at a prompt's last token and at two
decode steps after it.  The models: each dense family at the JAX tests'
head dim 16, mixtral and qwen2_moe (its shared expert, `norm_topk_prob`
off and on, and a stack whose `mlp_only_layers` and
`decoder_sparse_step` make dense layers), phi, phi3 and gpt_neox also
at head dims 80 and 96, llama
with linear, llama3 and yarn `rope_scaling` (yarn with the paper's
attention factor and with an mscale pair), phi3 with longrope in its
short and its long band and with a 4k-style window.  Also: the MoE model
types' configs as the JAX loader's, the RoPE kinds the port does not
serve refused by name, a
config and state dict convert without `transformers` (the card has
none), and `build_hf_engine` serves on the card by default.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.hf_loader import load_hf_model as jax_load_hf
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceEngineConfig,
                                              build_hf_engine)
from deepspeed_tpu_torch.models import (convert_state_dict, hf_to_config,
                                        load_hf_model)
from deepspeed_tpu_torch.models.hf_loader import SUPPORTED_MODEL_TYPES

transformers = pytest.importorskip("transformers")

pytestmark = pytest.mark.serving

V, S = 99, 24
# the reference test's tolerance (tests/test_hf_loader.py)
HF_TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(num_blocks=32, block_size=8, max_blocks_per_seq=8,
                 max_seqs=2, prefill_chunk_size=16)


def _hf(config_cls, **kw):
    torch.manual_seed(0)
    from transformers import AutoModelForCausalLM
    model = AutoModelForCausalLM.from_config(config_cls(**kw))
    return model.float().eval()


TINY = dict(
    gpt2=lambda: _hf(transformers.GPT2Config, vocab_size=V, n_embd=64,
                     n_layer=2, n_head=4, n_positions=64),
    llama=lambda: _hf(transformers.LlamaConfig, vocab_size=V, hidden_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, intermediate_size=112,
                      max_position_embeddings=64),
    # a window of 8 keys: the prompt and its decode steps cross it
    mistral=lambda: _hf(transformers.MistralConfig, vocab_size=V,
                        hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        intermediate_size=112, max_position_embeddings=64,
                        sliding_window=8),
    # full attention below max_window_layers, windows of 8 above
    qwen2_windows=lambda: _hf(transformers.Qwen2Config, vocab_size=V,
                              hidden_size=64, num_hidden_layers=4,
                              num_attention_heads=4, num_key_value_heads=2,
                              intermediate_size=112,
                              max_position_embeddings=64,
                              use_sliding_window=True, sliding_window=8,
                              max_window_layers=2),
    opt=lambda: _hf(transformers.OPTConfig, vocab_size=V, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=4, ffn_dim=256,
                    max_position_embeddings=64, word_embed_proj_dim=64),
    opt_post_norm=lambda: _hf(transformers.OPTConfig, vocab_size=V,
                              hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=4, ffn_dim=256,
                              max_position_embeddings=64,
                              word_embed_proj_dim=64,
                              do_layer_norm_before=False),
    # OPT-350m's block: post-norm, narrow embeddings projected in/out
    opt_350m_style=lambda: _hf(transformers.OPTConfig, vocab_size=V,
                               hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=4, ffn_dim=256,
                               max_position_embeddings=64,
                               word_embed_proj_dim=32,
                               do_layer_norm_before=False),
    opt_proj_pre_norm=lambda: _hf(transformers.OPTConfig, vocab_size=V,
                                  hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, ffn_dim=256,
                                  max_position_embeddings=64,
                                  word_embed_proj_dim=32),
    bloom=lambda: _hf(transformers.BloomConfig, vocab_size=V, hidden_size=64,
                      n_layer=2, n_head=4),
    # falcon-7b's layout: one kv head after the q heads, parallel block
    falcon=lambda: _hf(transformers.FalconConfig, vocab_size=V,
                       hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, alibi=False, bias=False,
                       multi_query=True, parallel_attn=True,
                       new_decoder_architecture=False),
    # the classic rw layout: per-head [q|k|v] interleave, sequential block
    falcon_rw_style=lambda: _hf(transformers.FalconConfig, vocab_size=V,
                                hidden_size=64, num_hidden_layers=2,
                                num_attention_heads=4, alibi=False,
                                bias=True, multi_query=False,
                                parallel_attn=False,
                                new_decoder_architecture=False),
    # falcon-rw-1b: ALiBi before the score scale
    falcon_alibi=lambda: _hf(transformers.FalconConfig, vocab_size=V,
                             hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, alibi=True, bias=True,
                             multi_query=False, parallel_attn=False,
                             new_decoder_architecture=False),
    falcon_alibi_mqa=lambda: _hf(transformers.FalconConfig, vocab_size=V,
                                 hidden_size=64, num_hidden_layers=2,
                                 num_attention_heads=4, alibi=True,
                                 bias=False, multi_query=True,
                                 parallel_attn=True,
                                 new_decoder_architecture=False),
    # scaled RoPE on llama (the reference test's geometries)
    llama_linear_scaled=lambda: _hf(
        transformers.LlamaConfig, vocab_size=V, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=112, max_position_embeddings=256,
        rope_scaling={"rope_type": "linear", "factor": 4.0}),
    llama3_scaled=lambda: _hf(
        transformers.LlamaConfig, vocab_size=V, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=112, max_position_embeddings=256,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}),
    llama_yarn_scaled=lambda: _hf(
        transformers.LlamaConfig, vocab_size=V, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=112, max_position_embeddings=256,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 64}),
    llama_yarn_mscale=lambda: _hf(
        transformers.LlamaConfig, vocab_size=V, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=112, max_position_embeddings=256,
        rope_scaling={"rope_type": "yarn", "factor": 4.0, "mscale": 1.0,
                      "mscale_all_dim": 0.8,
                      "original_max_position_embeddings": 64}),
    # head dim 96 with llama3 scaling
    llama3_scaled_d96=lambda: _hf(
        transformers.LlamaConfig, vocab_size=V, hidden_size=192,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        intermediate_size=112, max_position_embeddings=256,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}),
    # phi-2's block: one layernorm, partial rotary, biased lm head
    phi=lambda: _hf(transformers.PhiConfig, vocab_size=V, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=256, max_position_embeddings=64,
                    partial_rotary_factor=0.5),
    phi_d80=lambda: _hf(transformers.PhiConfig, vocab_size=V,
                        hidden_size=160, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=64,
                        partial_rotary_factor=0.4),
    phi3=lambda: _hf(transformers.Phi3Config, vocab_size=V, hidden_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, intermediate_size=112,
                     max_position_embeddings=64, pad_token_id=0,
                     bos_token_id=1, eos_token_id=2),
    phi3_d96=lambda: _hf(transformers.Phi3Config, vocab_size=V,
                         hidden_size=192, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=2,
                         intermediate_size=112, max_position_embeddings=64,
                         pad_token_id=0, bos_token_id=1, eos_token_id=2),
    # Phi-3-mini-4k's window (2047 there), 8 keys here
    phi3_window_d96=lambda: _hf(transformers.Phi3Config, vocab_size=V,
                                hidden_size=192, num_hidden_layers=2,
                                num_attention_heads=2,
                                num_key_value_heads=2,
                                intermediate_size=112,
                                max_position_embeddings=64,
                                sliding_window=8, pad_token_id=0,
                                bos_token_id=1, eos_token_id=2),
    # Phi-3-mini-128k's longrope: the prompt and its decode steps inside
    # the original context (short band) or past it (long band)
    phi3_longrope_short=lambda: _phi3_longrope(64, 64),
    phi3_longrope_long=lambda: _phi3_longrope(64, 8),
    phi3_longrope_long_d96=lambda: _phi3_longrope(192, 8, heads=2),
    gpt_neox=lambda: _hf(transformers.GPTNeoXConfig, vocab_size=V,
                         hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=256,
                         max_position_embeddings=64, rotary_pct=0.25),
    gpt_neox_d96=lambda: _hf(transformers.GPTNeoXConfig, vocab_size=V,
                             hidden_size=192, num_hidden_layers=2,
                             num_attention_heads=2, intermediate_size=256,
                             max_position_embeddings=64, rotary_pct=0.25),
    mixtral=lambda: _hf(transformers.MixtralConfig, vocab_size=V,
                        hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        intermediate_size=96, num_local_experts=4,
                        num_experts_per_tok=2, max_position_embeddings=64),
    qwen2_moe=lambda: _hf(transformers.Qwen2MoeConfig, vocab_size=V,
                          hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          intermediate_size=112, moe_intermediate_size=48,
                          shared_expert_intermediate_size=80, num_experts=6,
                          num_experts_per_tok=3, norm_topk_prob=False,
                          max_position_embeddings=64),
    # layers 0 and 2 dense by mlp_only_layers and decoder_sparse_step 2,
    # normalised top-k weights
    qwen2_moe_dense=lambda: _hf(transformers.Qwen2MoeConfig, vocab_size=V,
                                hidden_size=64, num_hidden_layers=4,
                                num_attention_heads=4, num_key_value_heads=2,
                                intermediate_size=112,
                                moe_intermediate_size=48,
                                shared_expert_intermediate_size=80,
                                num_experts=4, num_experts_per_tok=2,
                                norm_topk_prob=True, decoder_sparse_step=1,
                                mlp_only_layers=[0, 2],
                                max_position_embeddings=64),
    gpt_neox_sequential_d96=lambda: _hf(
        transformers.GPTNeoXConfig, vocab_size=V, hidden_size=192,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=64, rotary_pct=0.25,
        use_parallel_residual=False),
)


def _phi3_longrope(hidden, orig, heads=4):
    """Phi-3 with longrope over an original context of `orig` tokens
    (max 256): factor lists of D / 2 entries rising from 1.0."""
    half = hidden // heads // 2
    return _hf(transformers.Phi3Config, vocab_size=V, hidden_size=hidden,
               num_hidden_layers=2, num_attention_heads=heads,
               num_key_value_heads=heads // 2, intermediate_size=112,
               max_position_embeddings=256,
               original_max_position_embeddings=orig, pad_token_id=0,
               bos_token_id=1, eos_token_id=2,
               rope_scaling={"type": "longrope",
                             "short_factor": [1.0 + 0.1 * i
                                              for i in range(half)],
                             "long_factor": [1.0 + 2.0 * i
                                             for i in range(half)]})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(
            np.asarray(ids, np.int64)[None])).logits[0].numpy()


@pytest.mark.parametrize("name", sorted(TINY))
def test_params_equal_the_jax_loader(name):
    model = TINY[name]()
    ours, params = load_hf_model(model, dtype=torch.float32)
    _, jparams = jax_load_hf(model, dtype=jnp.float32)
    got, want = _flat(params), _flat(jax.device_get(jparams))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ours.cfg.pos_emb == hf_to_config(model.config).pos_emb


@pytest.mark.parametrize("name", sorted(TINY))
def test_engine_logits_match_hf(name):
    """Prefill of a 21-token prompt (chunks of 16), then two decode steps:
    each within 2e-4 of the HF forward's logits at that position."""
    model = TINY[name]()
    eng = build_hf_engine(model, engine_config=RaggedInferenceEngineConfig(
        **ENGINE_KW), dtype=torch.float32, device="cpu")
    ids = np.random.RandomState(0).randint(0, V, 21).astype(np.int32)
    out = eng.put([1], [ids])
    while eng.query(1) is None:
        out = eng.step()
    seq = list(ids)
    np.testing.assert_allclose(out[1], _hf_logits(model, seq)[-1], **HF_TOL)
    for _ in range(2):
        nxt = int(np.argmax(eng.query(1)))
        seq.append(nxt)
        out = eng.put([1], [np.asarray([nxt], np.int32)])
        np.testing.assert_allclose(out[1], _hf_logits(model, seq)[-1],
                                   **HF_TOL)


def test_qwen2_windows_convert_per_layer():
    cfg = hf_to_config(TINY["qwen2_windows"]().config)
    assert cfg.sliding_window_layers == (0, 0, 8, 8)
    assert cfg.sliding_window is None
    assert hf_to_config(TINY["mistral"]().config).sliding_window == 8
    rw = hf_to_config(TINY["falcon_alibi"]().config)
    assert (rw.pos_emb, rw.alibi_scaled, rw.parallel_residual) == \
        ("alibi", True, False)
    assert hf_to_config(TINY["falcon"]().config).kv_heads == 1


@pytest.mark.parametrize("name", ["mixtral", "qwen2_moe_dense"])
def test_moe_model_types_convert_as_the_jax_loader(name):
    """The MoE model types' configs as the JAX loader's (experts, top k,
    the shared expert, `norm_topk_prob`, the dense layers), and the
    prompt's logits through `convert_state_dict` and the engine within
    the HF tolerance of the HF forward."""
    model = TINY[name]()
    mt = model.config.model_type
    assert mt in SUPPORTED_MODEL_TYPES
    from deepspeed_tpu.models.hf_loader import hf_to_config as jax_hf_config
    cfg = hf_to_config(model.config, dtype=torch.float32)
    jcfg = jax_hf_config(model.config)
    for field in ("moe_experts", "moe_top_k", "moe_shared_expert_ffn",
                  "moe_norm_topk_prob", "moe_dense_layers",
                  "dense_intermediate_size", "intermediate_size"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    if name == "qwen2_moe_dense":
        assert cfg.moe_dense_layers == (1, 0, 1, 0)
    params = convert_state_dict(cfg, mt, model.state_dict())
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    eng = InferenceEngineV2(cfg, params=params, device="cpu",
                            config=RaggedInferenceEngineConfig(**ENGINE_KW))
    ids = np.random.RandomState(1).randint(0, V, 13).astype(np.int32)
    out = eng.put([0], [ids])
    np.testing.assert_allclose(out[0], _hf_logits(model, ids)[-1], **HF_TOL)


def test_rope_scaling_and_attention_bias_are_refused():
    """What the reference refuses: dynamic RoPE, yarn with
    truncate=False, phi's qk_layernorm, a biased llama o_proj.  The
    scalings it converts convert here to the same tuples."""
    from deepspeed_tpu.models.hf_loader import hf_to_config as jax_config
    with pytest.raises(NotImplementedError, match="dynamic"):
        hf_to_config(transformers.LlamaConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4,
            rope_scaling={"rope_type": "dynamic", "factor": 2.0}))
    with pytest.raises(NotImplementedError, match="truncate=False"):
        fields = transformers.LlamaConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4).to_dict()
        fields["rope_scaling"] = {"rope_type": "yarn", "factor": 4.0,
                                  "truncate": False}
        hf_to_config(types.SimpleNamespace(**fields))
    with pytest.raises(NotImplementedError, match="qk_layernorm"):
        hf_to_config(transformers.PhiConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, qk_layernorm=True))
    for name in ("llama_linear_scaled", "llama3_scaled",
                 "llama_yarn_mscale", "phi3_longrope_long"):
        c = TINY[name]().config
        assert hf_to_config(c).rope_scaling == jax_config(c).rope_scaling
    with pytest.raises(NotImplementedError, match="attention_bias"):
        hf_to_config(transformers.MistralConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, attention_bias=True))


def test_a_config_and_state_dict_convert_without_transformers():
    """What the card does (it has no `transformers`): a plain namespace of
    the config's attributes and a state dict of tensors."""
    model = TINY["falcon"]()
    cfg = types.SimpleNamespace(**model.config.to_dict())
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ns = types.SimpleNamespace(config=cfg, state_dict=lambda: sd)
    ours, params = load_hf_model(ns, dtype=torch.float32)
    _, want = load_hf_model(model, dtype=torch.float32)
    got, want = _flat(params), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    eng = build_hf_engine(ns, engine_config=RaggedInferenceEngineConfig(
        **ENGINE_KW), dtype=torch.float32, device="cpu")
    ids = np.arange(5, dtype=np.int32)
    np.testing.assert_allclose(eng.put([0], [ids])[0],
                               _hf_logits(model, ids)[-1], **HF_TOL)


def test_build_hf_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hf_engine(TINY["gpt2"](), dtype=torch.float32)
