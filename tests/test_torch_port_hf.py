"""HF checkpoints through the port: `models.hf_loader` and
`inference.v2.build_hf_engine`, against the JAX package's loader and the
HF torch forward, on the CPU.

HF models are built from a config in memory (no download), as
tests/test_hf_loader.py builds them.  For each: the port's converted
parameters equal the JAX loader's exactly, and the port's engine (f32,
paged prefill and decode through the kernels' plain versions) gives the
HF forward's logits within 2e-4 — at a prompt's last token and at two
decode steps after it.  Also: the model types the port does not serve
are refused by name, a config and state dict convert without
`transformers` (the card has none), and `build_hf_engine` serves on the
card by default.
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
)


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


@pytest.mark.parametrize("name,config", [
    ("phi", lambda: transformers.PhiConfig(vocab_size=V, hidden_size=64,
                                           num_hidden_layers=2,
                                           num_attention_heads=4)),
    ("phi3", lambda: transformers.Phi3Config(vocab_size=V, hidden_size=64,
                                             num_hidden_layers=2,
                                             num_attention_heads=4,
                                             pad_token_id=0)),
    ("gpt_neox", lambda: transformers.GPTNeoXConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4)),
    ("mixtral", lambda: transformers.MixtralConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2)),
    ("qwen2_moe", lambda: transformers.Qwen2MoeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2))])
def test_remaining_model_types_are_refused_by_name(name, config):
    with pytest.raises(NotImplementedError, match=name):
        hf_to_config(config())
    with pytest.raises(NotImplementedError, match=name):
        convert_state_dict(None, name, {})
    assert name not in SUPPORTED_MODEL_TYPES


def test_rope_scaling_and_attention_bias_are_refused():
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        hf_to_config(transformers.LlamaConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4,
            rope_scaling={"rope_type": "linear", "factor": 2.0}))
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
