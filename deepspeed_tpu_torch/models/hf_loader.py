"""HuggingFace checkpoints -> the port's configs and stacked parameters.

Counterpart of `deepspeed_tpu/models/hf_loader.py`, for the model types
the port serves: gpt2, llama (with llama3, linear and yarn
`rope_scaling`), mistral, qwen2 (with `use_sliding_window` stacks,
homogeneous or per layer), phi (phi-2's biased lm head and one shared
layernorm a parallel block), phi3 (fused qkv and gate/up projections,
longrope's short and long per-band factors), opt (with the 350m
post-norm and embedding-projection variant), gpt_neox (per-head qkv
interleave), bloom (embedding layernorm, ALiBi, per-head qkv interleave)
and falcon (the 7b multi-query and the classic rw fused qkv layouts, and
the new-decoder-architecture groups; Falcon-RW's ALiBi before the score
scale), mixtral (per-expert w1/w3/w2 stacked into the expert leaves) and
qwen2_moe (the shared expert behind its sigmoid gate, `norm_topk_prob`,
and the dense layers that `mlp_only_layers` and `decoder_sparse_step`
mark, as `moe_dense_layers`).  Dynamic RoPE, yarn with truncate=False
and phi's qk_layernorm raise `NotImplementedError` by name.

The HF state dict is converted once into the reference's stacked layout
([L, ...] leading layer dim, in-first matmuls, the same key names), as f32
torch tensors on the CPU; the engine casts and moves them.  `transformers`
is imported only when `load_hf_model` is given a name or path: any object
with a `.config` (an HF PretrainedConfig, or the same attributes, e.g. a
`types.SimpleNamespace` read from a config.json) and a `.state_dict()`
converts without it.

    model, params = load_hf_model("gpt2")                  # name/path
    model, params = load_hf_model(hf_torch_model)          # live module
    cfg = hf_to_config(hf_torch_model.config)
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .transformer import Transformer, TransformerConfig

__all__ = ["load_hf_model", "hf_to_config", "convert_state_dict",
           "SUPPORTED_MODEL_TYPES"]


def _to_np(sd) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        out[k] = v.detach().cpu().float().numpy() if hasattr(v, "detach") \
            else np.asarray(v, np.float32)
    return out


def _stk(sd, fmt: str, L: int) -> np.ndarray:
    return np.stack([sd[fmt.format(i)] for i in range(L)])


def _stk_t(sd, fmt: str, L: int) -> np.ndarray:
    """Stack torch Linear weights ([out, in]) transposed to in-first."""
    return np.stack([sd[fmt.format(i)].T for i in range(L)])


# ---------------------------------------------------------------------------
# config mapping
# ---------------------------------------------------------------------------

def _map_act(name: str) -> str:
    table = {"gelu": "gelu_exact", "gelu_new": "gelu",
             "gelu_pytorch_tanh": "gelu", "relu": "relu",
             "gelu_fast": "gelu"}
    if name not in table:
        raise NotImplementedError(
            f"activation {name!r} has no zoo equivalent "
            f"(supported: {sorted(table)})")
    return table[name]


def _qwen2_window_stack(c):
    """qwen2 use_sliding_window -> (homogeneous, per_layer): HF
    layer_types (or the max_window_layers default) run full attention
    below max_window_layers and sliding above.  The plain window where
    the stack is homogeneous, else a per-layer tuple (0 = full)."""
    lt = getattr(c, "layer_types", None) or [
        "full_attention" if i < c.max_window_layers
        else "sliding_attention"
        for i in range(c.num_hidden_layers)]
    wins = tuple(int(c.sliding_window)
                 if t == "sliding_attention" else 0 for t in lt)
    if all(w == wins[0] for w in wins):
        return (wins[0] or None), None
    return None, wins


def _convert_rope_scaling(c):
    """HF rope_scaling dict -> TransformerConfig.rope_scaling tuple (the
    reference's conversion): llama3, linear, yarn (with the mscale pair)
    and longrope ("su", its older name) convert exactly; dynamic RoPE and
    yarn with truncate=False are refused rather than converted silently
    wrong."""
    rs = getattr(c, "rope_scaling", None)
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind == "default":
        return None
    if kind in ("longrope", "su"):
        # phi3-style per-band divisors (HF _compute_longrope_parameters)
        short = tuple(float(x) for x in rs["short_factor"])
        long_ = tuple(float(x) for x in rs["long_factor"])
        orig = float(rs.get("original_max_position_embeddings")
                     or getattr(c, "original_max_position_embeddings", 0)
                     or c.max_position_embeddings)
        factor = rs.get("factor")
        if getattr(c, "original_max_position_embeddings", None):
            factor = c.max_position_embeddings / orig
        factor = float(factor if factor is not None else 1.0)
        af = rs.get("attention_factor")
        if af is None:
            af = (1.0 if factor <= 1.0
                  else math.sqrt(1.0 + math.log(factor) / math.log(orig)))
        return ("longrope", float(af), orig, short, long_)
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]),
                float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                float(rs["original_max_position_embeddings"]))
    if kind == "yarn":
        if not rs.get("truncate", True):
            raise NotImplementedError(
                "yarn with truncate=False uses untruncated correction "
                "bounds this conversion does not model — refusing rather "
                "than converting silently wrong")
        factor = float(rs["factor"])
        af = rs.get("attention_factor")
        mscale = rs.get("mscale")
        mscale_all_dim = rs.get("mscale_all_dim")

        def get_mscale(scale, ms=1.0):
            return 1.0 if scale <= 1 else 0.1 * ms * math.log(scale) + 1.0
        if af is None:
            # HF _compute_yarn_parameters: the mscale pair, or the
            # paper's 0.1 ln(factor) + 1
            af = (get_mscale(factor, mscale) / get_mscale(factor,
                                                          mscale_all_dim)
                  if (mscale and mscale_all_dim) else get_mscale(factor))
        orig = float(rs.get("original_max_position_embeddings")
                     or c.max_position_embeddings)
        return ("yarn", factor, float(af),
                float(rs.get("beta_fast") or 32),
                float(rs.get("beta_slow") or 1), orig)
    raise NotImplementedError(
        f"rope_scaling={rs!r}: {kind} RoPE is not modeled by this zoo "
        f"(llama3, linear, yarn and longrope convert exactly; dynamic "
        f"would produce silently wrong logits)")


def hf_to_config(c, dtype=None, **overrides) -> TransformerConfig:
    """HF PretrainedConfig -> TransformerConfig (per model_type)."""
    mt = c.model_type
    if mt == "gpt2":
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.n_embd,
                  num_layers=c.n_layer, num_heads=c.n_head,
                  max_seq_len=c.n_positions, pos_emb="learned",
                  norm="layernorm",
                  activation=_map_act(c.activation_function),
                  tie_embeddings=True, norm_eps=c.layer_norm_epsilon)
    elif mt in ("llama", "mistral", "qwen2", "phi3"):
        rope_scaling = _convert_rope_scaling(c)
        if mt == "qwen2" and getattr(c, "use_sliding_window", False):
            homogeneous_window, qwen2_windows = _qwen2_window_stack(c)
        else:
            homogeneous_window, qwen2_windows = None, None
        if mt in ("llama", "mistral") and getattr(c, "attention_bias", False):
            # HF attention_bias adds biases to q/k/v AND o_proj; the
            # rmsnorm layer has no o-projection bias slot
            raise NotImplementedError(
                f"{mt} with attention_bias=True (biased o_proj) is not "
                f"representable in this zoo's rmsnorm layer")
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  num_kv_heads=getattr(c, "num_key_value_heads", None),
                  intermediate_size=c.intermediate_size,
                  max_seq_len=c.max_position_embeddings, pos_emb="rope",
                  rope_theta=getattr(c, "rope_theta", 10000.0),
                  rope_scaling=rope_scaling,
                  norm="rmsnorm", activation="swiglu",
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              False)),
                  norm_eps=c.rms_norm_eps,
                  qkv_bias=(mt == "qwen2"
                            and bool(getattr(c, "attention_bias", True))),
                  sliding_window=(getattr(c, "sliding_window", None)
                                  if mt in ("mistral", "phi3")
                                  else homogeneous_window),
                  sliding_window_layers=qwen2_windows)
    elif mt == "mixtral":
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  num_kv_heads=c.num_key_value_heads,
                  intermediate_size=c.intermediate_size,
                  max_seq_len=c.max_position_embeddings, pos_emb="rope",
                  rope_theta=getattr(c, "rope_theta", 10000.0),
                  rope_scaling=_convert_rope_scaling(c),
                  norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                  norm_eps=c.rms_norm_eps,
                  moe_experts=c.num_local_experts,
                  moe_top_k=c.num_experts_per_tok,
                  moe_norm_topk_prob=True)
    elif mt == "qwen2_moe":
        rope_scaling = _convert_rope_scaling(c)
        if getattr(c, "use_sliding_window", False):
            moe_window, moe_windows = _qwen2_window_stack(c)
        else:
            moe_window, moe_windows = None, None
        # HF layer i is an expert layer iff i is not in mlp_only_layers
        # and (i + 1) % decoder_sparse_step == 0 (Qwen2MoeDecoderLayer);
        # the dense layers run a plain MLP of intermediate_size
        mlp_only = set(getattr(c, "mlp_only_layers", None) or [])
        dense_flags = tuple(
            1 if (i in mlp_only or (i + 1) % c.decoder_sparse_step != 0)
            else 0 for i in range(c.num_hidden_layers))
        moe_dense_layers = dense_flags if any(dense_flags) else None
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  num_kv_heads=c.num_key_value_heads,
                  intermediate_size=c.moe_intermediate_size,
                  max_seq_len=c.max_position_embeddings, pos_emb="rope",
                  rope_theta=getattr(c, "rope_theta", 10000.0),
                  rope_scaling=rope_scaling,
                  norm="rmsnorm", activation="swiglu",
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              False)),
                  norm_eps=c.rms_norm_eps, qkv_bias=True,
                  sliding_window=moe_window,
                  sliding_window_layers=moe_windows,
                  moe_experts=c.num_experts,
                  moe_top_k=c.num_experts_per_tok,
                  moe_shared_expert_ffn=c.shared_expert_intermediate_size,
                  moe_norm_topk_prob=bool(c.norm_topk_prob),
                  moe_dense_layers=moe_dense_layers,
                  dense_intermediate_size=(c.intermediate_size
                                           if moe_dense_layers else None))
    elif mt == "opt":
        post_norm = not getattr(c, "do_layer_norm_before", True)
        # the top-level final_layer_norm exists only for the pre-norm
        # variants (HF OPTDecoder)
        final_norm = (not post_norm
                      and not getattr(c, "_remove_final_layer_norm", False))
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  intermediate_size=c.ffn_dim,
                  max_seq_len=c.max_position_embeddings, pos_emb="learned",
                  norm="layernorm",
                  activation=_map_act(c.activation_function),
                  post_norm=post_norm, final_norm=final_norm,
                  embed_proj_dim=(c.word_embed_proj_dim
                                  if c.word_embed_proj_dim != c.hidden_size
                                  else None),
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              True)))
    elif mt == "phi":
        rope_scaling = _convert_rope_scaling(c)
        if getattr(c, "qk_layernorm", False):
            raise NotImplementedError(
                "phi with qk_layernorm=True (per-head q/k layernorms) is "
                "not modeled by this zoo")
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  intermediate_size=c.intermediate_size,
                  max_seq_len=c.max_position_embeddings, pos_emb="rope",
                  rope_pct=c.partial_rotary_factor,
                  rope_theta=getattr(c, "rope_theta", 10000.0),
                  rope_scaling=rope_scaling,
                  norm="layernorm", norm_eps=c.layer_norm_eps,
                  activation=_map_act(c.hidden_act),
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              False)),
                  parallel_residual=True, head_bias=True)
    elif mt == "gpt_neox":
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  intermediate_size=c.intermediate_size,
                  max_seq_len=c.max_position_embeddings, pos_emb="rope",
                  rope_pct=c.rotary_pct,
                  rope_scaling=_convert_rope_scaling(c),
                  rope_theta=getattr(c, "rotary_emb_base", 10000.0),
                  norm="layernorm", norm_eps=c.layer_norm_eps,
                  activation=_map_act(c.hidden_act),
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              False)),
                  parallel_residual=c.use_parallel_residual)
    elif mt == "bloom":
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.n_layer, num_heads=c.n_head,
                  max_seq_len=getattr(c, "seq_length", 2048),
                  pos_emb="alibi", norm="layernorm",
                  norm_eps=c.layer_norm_epsilon,
                  activation="gelu",          # BloomGelu is the tanh approx
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              True)),
                  embed_norm=True)
    elif mt == "falcon":
        use_alibi = bool(getattr(c, "alibi", False))
        new_arch = bool(getattr(c, "new_decoder_architecture", False))
        kw = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                  num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads,
                  num_kv_heads=(c.num_kv_heads if new_arch
                                else (1 if getattr(c, "multi_query", True)
                                      else c.num_attention_heads)),
                  intermediate_size=getattr(c, "ffn_hidden_size", None),
                  max_seq_len=getattr(c, "max_position_embeddings", 2048),
                  # falcon-rw (alibi=True) drops rotary and adds alibi
                  # BEFORE the 1/sqrt(D) score scaling
                  pos_emb="alibi" if use_alibi else "rope",
                  alibi_scaled=use_alibi,
                  rope_theta=getattr(c, "rope_theta", 10000.0),
                  rope_scaling=(None if use_alibi
                                else _convert_rope_scaling(c)),
                  norm="layernorm", norm_eps=c.layer_norm_epsilon,
                  activation="gelu_exact",
                  tie_embeddings=bool(getattr(c, "tie_word_embeddings",
                                              True)),
                  parallel_residual=bool(getattr(c, "parallel_attn", True)))
    else:
        raise ValueError(
            f"unsupported model_type {mt!r}; supported: "
            f"{sorted(SUPPORTED_MODEL_TYPES)}")
    if dtype is not None:
        kw["dtype"] = dtype
    kw.update(overrides)
    return TransformerConfig(**kw)


# ---------------------------------------------------------------------------
# per-arch state-dict converters -> stacked-layer params
# ---------------------------------------------------------------------------

def _load_gpt2(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    L, H = cfg.num_layers, cfg.hidden_size
    w = _stk(sd, "transformer.h.{}.attn.c_attn.weight", L)   # Conv1D: [H, 3H]
    b = _stk(sd, "transformer.h.{}.attn.c_attn.bias", L)
    layers = {
        "attn_norm_scale": _stk(sd, "transformer.h.{}.ln_1.weight", L),
        "attn_norm_bias": _stk(sd, "transformer.h.{}.ln_1.bias", L),
        "wq": w[:, :, :H], "wk": w[:, :, H:2 * H], "wv": w[:, :, 2 * H:],
        "bq": b[:, :H], "bk": b[:, H:2 * H], "bv": b[:, 2 * H:],
        "wo": _stk(sd, "transformer.h.{}.attn.c_proj.weight", L),
        "bo": _stk(sd, "transformer.h.{}.attn.c_proj.bias", L),
        "mlp_norm_scale": _stk(sd, "transformer.h.{}.ln_2.weight", L),
        "mlp_norm_bias": _stk(sd, "transformer.h.{}.ln_2.bias", L),
        "w_up": _stk(sd, "transformer.h.{}.mlp.c_fc.weight", L),
        "b_up": _stk(sd, "transformer.h.{}.mlp.c_fc.bias", L),
        "w_down": _stk(sd, "transformer.h.{}.mlp.c_proj.weight", L),
        "b_down": _stk(sd, "transformer.h.{}.mlp.c_proj.bias", L),
    }
    return {
        "tok_embed": sd["transformer.wte.weight"],
        "pos_embed": sd["transformer.wpe.weight"],
        "layers": layers,
        "final_norm_scale": sd["transformer.ln_f.weight"],
        "final_norm_bias": sd["transformer.ln_f.bias"],
    }


def _load_llama_family(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    """llama / mistral / qwen2 (separate q/k/v projections)."""
    L = cfg.num_layers
    p = "model.layers.{}."
    layers = {
        "attn_norm_scale": _stk(sd, p + "input_layernorm.weight", L),
        "mlp_norm_scale": _stk(sd, p + "post_attention_layernorm.weight", L),
        "wq": _stk_t(sd, p + "self_attn.q_proj.weight", L),
        "wk": _stk_t(sd, p + "self_attn.k_proj.weight", L),
        "wv": _stk_t(sd, p + "self_attn.v_proj.weight", L),
        "wo": _stk_t(sd, p + "self_attn.o_proj.weight", L),
        "w_gate": _stk_t(sd, p + "mlp.gate_proj.weight", L),
        "w_up": _stk_t(sd, p + "mlp.up_proj.weight", L),
        "w_down": _stk_t(sd, p + "mlp.down_proj.weight", L),
    }
    if cfg.qkv_bias:
        layers["bq"] = _stk(sd, p + "self_attn.q_proj.bias", L)
        layers["bk"] = _stk(sd, p + "self_attn.k_proj.bias", L)
        layers["bv"] = _stk(sd, p + "self_attn.v_proj.bias", L)
    out = {
        "tok_embed": sd["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm_scale": sd["model.norm.weight"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    return out


def _load_mixtral(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    """mixtral: each layer's experts' w1 (gate), w3 (up) and w2 (down)
    stacked into the [L, E, in, out] expert leaves."""
    L, E = cfg.num_layers, cfg.moe_experts
    p = "model.layers.{}."

    def experts(which):
        return np.stack([
            np.stack([sd[p.format(i)
                         + f"block_sparse_moe.experts.{e}.{which}.weight"].T
                      for e in range(E)]) for i in range(L)])

    layers = {
        "attn_norm_scale": _stk(sd, p + "input_layernorm.weight", L),
        "mlp_norm_scale": _stk(sd, p + "post_attention_layernorm.weight", L),
        "wq": _stk_t(sd, p + "self_attn.q_proj.weight", L),
        "wk": _stk_t(sd, p + "self_attn.k_proj.weight", L),
        "wv": _stk_t(sd, p + "self_attn.v_proj.weight", L),
        "wo": _stk_t(sd, p + "self_attn.o_proj.weight", L),
        "moe_gate": _stk_t(sd, p + "block_sparse_moe.gate.weight", L),
        "moe_w_gate_proj": experts("w1"),
        "moe_w_up": experts("w3"),
        "moe_w_down": experts("w2"),
    }
    return {
        "tok_embed": sd["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm_scale": sd["model.norm.weight"],
        "lm_head": sd["lm_head.weight"].T,
    }


def _load_qwen2_moe(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    """qwen2_moe: the experts stacked as mixtral's, the shared expert and
    its gate row; the layers `moe_dense_layers` marks carry the dense MLP
    and zeros in the expert leaves (and the expert layers zeros in the
    dense leaves), as the reference's loader fills them."""
    L, E = cfg.num_layers, cfg.moe_experts
    p = "model.layers.{}."
    dense = list(cfg.moe_dense_layers or (0,) * L)
    H = cfg.hidden_size
    Fm = cfg.intermediate_size
    Fs = cfg.moe_shared_expert_ffn

    def experts(which):
        def one(i):
            if dense[i]:
                shp = ((E, H, Fm) if which != "down_proj" else (E, Fm, H))
                return np.zeros(shp, np.float32)
            return np.stack([
                sd[p.format(i) + f"mlp.experts.{e}.{which}.weight"].T
                for e in range(E)])
        return np.stack([one(i) for i in range(L)])

    def moe_only(fmt, shape):
        return np.stack([np.zeros(shape, np.float32) if dense[i]
                         else np.asarray(sd[fmt.format(i)]).T
                         for i in range(L)])

    def dense_only(which, shape):
        return np.stack([
            np.asarray(sd[p.format(i) + f"mlp.{which}.weight"]).T
            if dense[i] else np.zeros(shape, np.float32)
            for i in range(L)])

    layers = {
        "attn_norm_scale": _stk(sd, p + "input_layernorm.weight", L),
        "mlp_norm_scale": _stk(sd, p + "post_attention_layernorm.weight", L),
        "wq": _stk_t(sd, p + "self_attn.q_proj.weight", L),
        "wk": _stk_t(sd, p + "self_attn.k_proj.weight", L),
        "wv": _stk_t(sd, p + "self_attn.v_proj.weight", L),
        "bq": _stk(sd, p + "self_attn.q_proj.bias", L),
        "bk": _stk(sd, p + "self_attn.k_proj.bias", L),
        "bv": _stk(sd, p + "self_attn.v_proj.bias", L),
        "wo": _stk_t(sd, p + "self_attn.o_proj.weight", L),
        "moe_gate": moe_only(p + "mlp.gate.weight", (H, E)),
        "moe_w_gate_proj": experts("gate_proj"),
        "moe_w_up": experts("up_proj"),
        "moe_w_down": experts("down_proj"),
        "moe_shared_w_gate_proj": moe_only(
            p + "mlp.shared_expert.gate_proj.weight", (H, Fs)),
        "moe_shared_w_up": moe_only(
            p + "mlp.shared_expert.up_proj.weight", (H, Fs)),
        "moe_shared_w_down": moe_only(
            p + "mlp.shared_expert.down_proj.weight", (Fs, H)),
        "moe_shared_gate": np.stack([
            np.zeros((H,), np.float32) if dense[i]
            else np.asarray(sd[p.format(i)
                               + "mlp.shared_expert_gate.weight"])[0, :]
            for i in range(L)]),
    }
    if any(dense):
        Fd = cfg.dense_intermediate_size
        layers["w_gate"] = dense_only("gate_proj", (H, Fd))
        layers["w_up"] = dense_only("up_proj", (H, Fd))
        layers["w_down"] = dense_only("down_proj", (Fd, H))
    out = {
        "tok_embed": sd["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm_scale": sd["model.norm.weight"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    return out


def _load_phi3(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    """phi3: fused qkv_proj and gate_up_proj."""
    L, NH, NKV, D = (cfg.num_layers, cfg.num_heads, cfg.kv_heads,
                     cfg.head_dim)
    F = cfg.ffn_dim
    p = "model.layers.{}."
    qkv = _stk_t(sd, p + "self_attn.qkv_proj.weight", L)  # [L, H, (NH+2NKV)D]
    gu = _stk_t(sd, p + "mlp.gate_up_proj.weight", L)     # [L, H, 2F]
    layers = {
        "attn_norm_scale": _stk(sd, p + "input_layernorm.weight", L),
        "mlp_norm_scale": _stk(sd, p + "post_attention_layernorm.weight", L),
        "wq": qkv[:, :, :NH * D],
        "wk": qkv[:, :, NH * D:(NH + NKV) * D],
        "wv": qkv[:, :, (NH + NKV) * D:],
        "wo": _stk_t(sd, p + "self_attn.o_proj.weight", L),
        "w_gate": gu[:, :, :F],
        "w_up": gu[:, :, F:],
        "w_down": _stk_t(sd, p + "mlp.down_proj.weight", L),
    }
    out = {
        "tok_embed": sd["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm_scale": sd["model.norm.weight"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    return out


def _load_phi(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    """phi-2: separate biased q/k/v, ONE shared per-layer layernorm feeding
    the parallel attention + MLP block (copied into both norm slots), a
    biased lm head."""
    L = cfg.num_layers
    p = "model.layers.{}."
    ln_w = _stk(sd, p + "input_layernorm.weight", L)
    ln_b = _stk(sd, p + "input_layernorm.bias", L)
    layers = {
        "attn_norm_scale": ln_w, "attn_norm_bias": ln_b,
        "mlp_norm_scale": ln_w, "mlp_norm_bias": ln_b,
        "wq": _stk_t(sd, p + "self_attn.q_proj.weight", L),
        "wk": _stk_t(sd, p + "self_attn.k_proj.weight", L),
        "wv": _stk_t(sd, p + "self_attn.v_proj.weight", L),
        "bq": _stk(sd, p + "self_attn.q_proj.bias", L),
        "bk": _stk(sd, p + "self_attn.k_proj.bias", L),
        "bv": _stk(sd, p + "self_attn.v_proj.bias", L),
        "wo": _stk_t(sd, p + "self_attn.dense.weight", L),
        "bo": _stk(sd, p + "self_attn.dense.bias", L),
        "w_up": _stk_t(sd, p + "mlp.fc1.weight", L),
        "b_up": _stk(sd, p + "mlp.fc1.bias", L),
        "w_down": _stk_t(sd, p + "mlp.fc2.weight", L),
        "b_down": _stk(sd, p + "mlp.fc2.bias", L),
    }
    out = {
        "tok_embed": sd["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm_scale": sd["model.final_layernorm.weight"],
        "final_norm_bias": sd["model.final_layernorm.bias"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
        out["lm_head_bias"] = sd["lm_head.bias"]
    return out


def _load_gpt_neox(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    L, NH, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
    H = cfg.hidden_size
    p = "gpt_neox.layers.{}."
    # fused qkv with a per-head [q|k|v] interleave: weight [3H, H] ->
    # in-first [H, NH, 3D] -> thirds per head
    qkv = np.stack([sd[p.format(i) + "attention.query_key_value.weight"].T
                    .reshape(H, NH, 3 * D) for i in range(L)])
    qkv_b = np.stack([sd[p.format(i) + "attention.query_key_value.bias"]
                      .reshape(NH, 3 * D) for i in range(L)])
    layers = {
        "attn_norm_scale": _stk(sd, p + "input_layernorm.weight", L),
        "attn_norm_bias": _stk(sd, p + "input_layernorm.bias", L),
        "mlp_norm_scale": _stk(sd, p + "post_attention_layernorm.weight", L),
        "mlp_norm_bias": _stk(sd, p + "post_attention_layernorm.bias", L),
        "wq": qkv[..., :D].reshape(L, H, NH * D),
        "wk": qkv[..., D:2 * D].reshape(L, H, NH * D),
        "wv": qkv[..., 2 * D:].reshape(L, H, NH * D),
        "bq": qkv_b[..., :D].reshape(L, NH * D),
        "bk": qkv_b[..., D:2 * D].reshape(L, NH * D),
        "bv": qkv_b[..., 2 * D:].reshape(L, NH * D),
        "wo": _stk_t(sd, p + "attention.dense.weight", L),
        "bo": _stk(sd, p + "attention.dense.bias", L),
        "w_up": _stk_t(sd, p + "mlp.dense_h_to_4h.weight", L),
        "b_up": _stk(sd, p + "mlp.dense_h_to_4h.bias", L),
        "w_down": _stk_t(sd, p + "mlp.dense_4h_to_h.weight", L),
        "b_down": _stk(sd, p + "mlp.dense_4h_to_h.bias", L),
    }
    out = {
        "tok_embed": sd["gpt_neox.embed_in.weight"],
        "layers": layers,
        "final_norm_scale": sd["gpt_neox.final_layer_norm.weight"],
        "final_norm_bias": sd["gpt_neox.final_layer_norm.bias"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["embed_out.weight"].T
    return out


def _load_opt(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    L = cfg.num_layers
    p = "model.decoder.layers.{}."
    layers = {
        "attn_norm_scale": _stk(sd, p + "self_attn_layer_norm.weight", L),
        "attn_norm_bias": _stk(sd, p + "self_attn_layer_norm.bias", L),
        "mlp_norm_scale": _stk(sd, p + "final_layer_norm.weight", L),
        "mlp_norm_bias": _stk(sd, p + "final_layer_norm.bias", L),
        "wq": _stk_t(sd, p + "self_attn.q_proj.weight", L),
        "wk": _stk_t(sd, p + "self_attn.k_proj.weight", L),
        "wv": _stk_t(sd, p + "self_attn.v_proj.weight", L),
        "bq": _stk(sd, p + "self_attn.q_proj.bias", L),
        "bk": _stk(sd, p + "self_attn.k_proj.bias", L),
        "bv": _stk(sd, p + "self_attn.v_proj.bias", L),
        "wo": _stk_t(sd, p + "self_attn.out_proj.weight", L),
        "bo": _stk(sd, p + "self_attn.out_proj.bias", L),
        "w_up": _stk_t(sd, p + "fc1.weight", L),
        "b_up": _stk(sd, p + "fc1.bias", L),
        "w_down": _stk_t(sd, p + "fc2.weight", L),
        "b_down": _stk(sd, p + "fc2.bias", L),
    }
    out = {
        "tok_embed": sd["model.decoder.embed_tokens.weight"],
        # HF OPT offsets learned positions by 2 (OPTLearnedPositionalEmbedding)
        "pos_embed": sd["model.decoder.embed_positions.weight"][2:],
        "layers": layers,
    }
    if cfg.final_norm:
        out["final_norm_scale"] = sd["model.decoder.final_layer_norm.weight"]
        out["final_norm_bias"] = sd["model.decoder.final_layer_norm.bias"]
    if cfg.embed_proj_dim:
        # OPT-350m: narrow embeddings projected in/out of the hidden width
        out["embed_in_proj"] = sd["model.decoder.project_in.weight"].T
        out["embed_out_proj"] = sd["model.decoder.project_out.weight"].T
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    return out


def _load_bloom(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    L, NH, D, H = (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                   cfg.hidden_size)
    p = "transformer.h.{}."
    # fused qkv with a per-head [q|k|v] interleave (BloomAttention views
    # [B,S,NH,3,D])
    qkv = np.stack([sd[p.format(i) + "self_attention.query_key_value.weight"]
                    .T.reshape(H, NH, 3 * D) for i in range(L)])
    qkv_b = np.stack([sd[p.format(i) + "self_attention.query_key_value.bias"]
                      .reshape(NH, 3 * D) for i in range(L)])
    layers = {
        "attn_norm_scale": _stk(sd, p + "input_layernorm.weight", L),
        "attn_norm_bias": _stk(sd, p + "input_layernorm.bias", L),
        "mlp_norm_scale": _stk(sd, p + "post_attention_layernorm.weight", L),
        "mlp_norm_bias": _stk(sd, p + "post_attention_layernorm.bias", L),
        "wq": qkv[..., :D].reshape(L, H, NH * D),
        "wk": qkv[..., D:2 * D].reshape(L, H, NH * D),
        "wv": qkv[..., 2 * D:].reshape(L, H, NH * D),
        "bq": qkv_b[..., :D].reshape(L, NH * D),
        "bk": qkv_b[..., D:2 * D].reshape(L, NH * D),
        "bv": qkv_b[..., 2 * D:].reshape(L, NH * D),
        "wo": _stk_t(sd, p + "self_attention.dense.weight", L),
        "bo": _stk(sd, p + "self_attention.dense.bias", L),
        "w_up": _stk_t(sd, p + "mlp.dense_h_to_4h.weight", L),
        "b_up": _stk(sd, p + "mlp.dense_h_to_4h.bias", L),
        "w_down": _stk_t(sd, p + "mlp.dense_4h_to_h.weight", L),
        "b_down": _stk(sd, p + "mlp.dense_4h_to_h.bias", L),
    }
    out = {
        "tok_embed": sd["transformer.word_embeddings.weight"],
        "embed_norm_scale": sd["transformer.word_embeddings_layernorm.weight"],
        "embed_norm_bias": sd["transformer.word_embeddings_layernorm.bias"],
        "layers": layers,
        "final_norm_scale": sd["transformer.ln_f.weight"],
        "final_norm_bias": sd["transformer.ln_f.bias"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    return out


def _falcon_split_qkv(w, b, cfg: TransformerConfig, new_arch: bool,
                      multi_query: bool):
    """Falcon fused qkv -> (wq, wk, wv, biases) in in-first layout.

    Three layouts (FalconAttention._split_heads): new_decoder_architecture
    groups [NKV, NH/NKV + 2, D] (q block then k then v per group);
    multi_query appends one k and one v head after NH q heads; classic is
    the neox-style per-head [q|k|v] interleave."""
    H = cfg.hidden_size
    NH, NKV, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    wt = w.T                                               # [H, rows]
    if new_arch:
        g = NH // NKV
        wt = wt.reshape(H, NKV, g + 2, D)
        wq = wt[:, :, :g].reshape(H, NH * D)
        wk = wt[:, :, g].reshape(H, NKV * D)
        wv = wt[:, :, g + 1].reshape(H, NKV * D)
    elif multi_query:
        wt = wt.reshape(H, NH + 2, D)
        wq = wt[:, :NH].reshape(H, NH * D)
        wk = wt[:, NH].reshape(H, D)
        wv = wt[:, NH + 1].reshape(H, D)
    else:
        wt = wt.reshape(H, NH, 3, D)
        wq = wt[:, :, 0].reshape(H, NH * D)
        wk = wt[:, :, 1].reshape(H, NH * D)
        wv = wt[:, :, 2].reshape(H, NH * D)
    if b is None:
        z = np.zeros
        return wq, wk, wv, z(NH * D, np.float32), z(
            NKV * D, np.float32), z(NKV * D, np.float32)
    if new_arch:
        bt = b.reshape(NKV, NH // NKV + 2, D)
        return (wq, wk, wv, bt[:, :-2].reshape(-1), bt[:, -2].reshape(-1),
                bt[:, -1].reshape(-1))
    if multi_query:
        bt = b.reshape(NH + 2, D)
        return wq, wk, wv, bt[:NH].reshape(-1), bt[NH], bt[NH + 1]
    bt = b.reshape(NH, 3, D)
    return (wq, wk, wv, bt[:, 0].reshape(-1), bt[:, 1].reshape(-1),
            bt[:, 2].reshape(-1))


def _load_falcon(cfg: TransformerConfig, sd, hf_config=None) -> Dict:
    if hf_config is None:
        raise ValueError(
            "falcon conversion needs hf_config= (the FalconConfig): the "
            "fused-qkv layout and bias presence are config-dependent and "
            "guessing would silently mis-split weights")
    L, H = cfg.num_layers, cfg.hidden_size
    p = "transformer.h.{}."
    new_arch = bool(getattr(hf_config, "new_decoder_architecture", False))
    multi_query = bool(getattr(hf_config, "multi_query", True))
    has_bias = bool(getattr(hf_config, "bias", False))
    parallel_attn = bool(getattr(hf_config, "parallel_attn", True))
    wq, wk, wv, bq, bk, bv = [], [], [], [], [], []
    for i in range(L):
        w = sd[p.format(i) + "self_attention.query_key_value.weight"]
        b = (sd.get(p.format(i) + "self_attention.query_key_value.bias")
             if has_bias else None)
        q, k, v, qb, kb, vb = _falcon_split_qkv(w, b, cfg, new_arch,
                                                multi_query)
        wq.append(q), wk.append(k), wv.append(v)
        bq.append(qb), bk.append(kb), bv.append(vb)

    def ln(which, part):
        # raw configs carry None here; FalconModel.__init__ normalizes
        # None -> 2
        if new_arch and getattr(hf_config, "num_ln_in_parallel_attn",
                                2) in (None, 2):
            name = "ln_attn" if which == "attn" else "ln_mlp"
        elif not parallel_attn and which == "mlp":
            # classic sequential block (falcon-rw): separate post-attn norm
            name = "post_attention_layernorm"
        else:
            # single shared layernorm (falcon-7b): both blocks read it
            name = "input_layernorm"
        return _stk(sd, p + f"{name}.{part}", L)

    def dense_or_zeros(fmt, shape_like):
        if has_bias:
            return _stk(sd, fmt, L)
        return np.zeros(shape_like, np.float32)

    layers = {
        "attn_norm_scale": ln("attn", "weight"),
        "attn_norm_bias": ln("attn", "bias"),
        "mlp_norm_scale": ln("mlp", "weight"),
        "mlp_norm_bias": ln("mlp", "bias"),
        "wq": np.stack(wq), "wk": np.stack(wk), "wv": np.stack(wv),
        "bq": np.stack(bq), "bk": np.stack(bk), "bv": np.stack(bv),
        "wo": _stk_t(sd, p + "self_attention.dense.weight", L),
        "bo": dense_or_zeros(p + "self_attention.dense.bias", (L, H)),
        "w_up": _stk_t(sd, p + "mlp.dense_h_to_4h.weight", L),
        "b_up": dense_or_zeros(p + "mlp.dense_h_to_4h.bias",
                               (L, cfg.ffn_dim)),
        "w_down": _stk_t(sd, p + "mlp.dense_4h_to_h.weight", L),
        "b_down": dense_or_zeros(p + "mlp.dense_4h_to_h.bias", (L, H)),
    }
    out = {
        "tok_embed": sd["transformer.word_embeddings.weight"],
        "layers": layers,
        "final_norm_scale": sd["transformer.ln_f.weight"],
        "final_norm_bias": sd["transformer.ln_f.bias"],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    return out


_LOADERS: Dict[str, Callable] = {
    "gpt2": _load_gpt2,
    "llama": _load_llama_family,
    "mistral": _load_llama_family,
    "qwen2": _load_llama_family,
    "mixtral": _load_mixtral,
    "qwen2_moe": _load_qwen2_moe,
    "phi3": _load_phi3,
    "phi": _load_phi,
    "opt": _load_opt,
    "gpt_neox": _load_gpt_neox,
    "bloom": _load_bloom,
    "falcon": _load_falcon,
}
SUPPORTED_MODEL_TYPES = frozenset(_LOADERS)


def _tensors(tree):
    return {k: (_tensors(v) if isinstance(v, dict) else
                torch.from_numpy(np.ascontiguousarray(v, np.float32)))
            for k, v in tree.items()}


def convert_state_dict(cfg: TransformerConfig, model_type: str,
                       state_dict, hf_config=None) -> Dict:
    """HF state dict (torch tensors or arrays) -> stacked-layer params,
    f32 torch tensors on the CPU."""
    if model_type not in _LOADERS:
        raise ValueError(f"unsupported model_type {model_type!r}; supported: "
                         f"{sorted(SUPPORTED_MODEL_TYPES)}")
    return _tensors(_LOADERS[model_type](cfg, _to_np(state_dict),
                                         hf_config=hf_config))


def load_hf_model(model, dtype=None,
                  **cfg_overrides) -> Tuple[Transformer, Dict]:
    """HF torch model (or name/path for AutoModelForCausalLM, which needs
    `transformers`) -> (Transformer, f32 params)."""
    if isinstance(model, str):
        from transformers import AutoModelForCausalLM
        model = AutoModelForCausalLM.from_pretrained(
            model, torch_dtype=torch.float32)
    cfg = hf_to_config(model.config, dtype=dtype, **cfg_overrides)
    params = convert_state_dict(cfg, model.config.model_type,
                                model.state_dict(), hf_config=model.config)
    return Transformer(cfg), params
