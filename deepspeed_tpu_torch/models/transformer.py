"""Decoder-only transformer config, parameters and layer math in PyTorch.

Counterpart of `deepspeed_tpu/models/transformer.py`.  The parameter
layout is the reference's stacked one: every layer weight carries a
leading layer dim (`layers.wq` is `[L, H, NH*D]`, in-first), so a JAX
checkpoint converts without a transpose (`models/convert.py`).  Where the
reference scans over that dim, the port loops over it in Python.

Scope: the families gpt2, llama, qwen2, mistral, phi, phi3, falcon,
opt, bloom and gptneox, and the expert layers of mixtral and qwen2_moe
(exact top-k routing through the hand-written grouped GEMM,
`_moe_inference`, with qwen2_moe's shared expert and dense-interleaved
stacks) — rope (partial, and scaled: linear,
llama3, yarn and phi3's longrope), learned or ALiBi positions, rmsnorm or
layernorm, swiglu, gelu or relu, GQA and MQA, qkv/output biases and the
lm-head bias, sliding windows (one for every layer, or one a layer),
pre-norm, post-norm (OPT-350m) and parallel-residual (Falcon, phi,
GPT-NeoX) blocks, embedding norms and projections, and fp8 serving
weights (`quantize_serving_weights`: e4m3 codes with per-column or
per-group f32 scales, which `_dense` takes).  The config refuses
the features the port does not carry yet, by name, at construction
(`NotImplementedError`): dropout, tiled MLPs.

Training (`_forward`, `_lm_loss`, `Transformer.loss_fn`) runs the same
layer math with autograd (the pre-norm sequential block with rope or
learned positions, no window and a head dim the flash backward takes;
`training_refusal` names the rest, whose
plain forward runs on the CPU only; expert layers are not trained at all,
and `Transformer.forward` refuses them): attention through the differentiable
flash op (`ops/attention.causal_attention`), each layer optionally under a
checkpoint with a named remat policy (`runtime/activation_checkpointing`),
and the loss optionally through the tiled fused logits+loss
(`sequence/tiled.py`).  The layer stack may be given as the stacked dict
or as a list of per-layer dicts (the engine's per-layer views, whose
gradients land in one stacked buffer).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import BWD_HEAD_DIMS

__all__ = ["TransformerConfig", "Transformer", "gpt2_config",
           "llama_config", "qwen2_config", "mistral_config",
           "mixtral_config", "qwen2_moe_config", "phi_config",
           "phi3_config", "falcon_config", "opt_config", "bloom_config",
           "gptneox_config", "init_params", "dense_f32", "alibi_slopes",
           "layer_windows", "training_refusal", "rope_tables",
           "resolve_weight", "resolve_weight_scaled",
           "quantize_serving_weights"]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None          # GQA; None -> num_heads
    # None -> 4*hidden (gelu) / 8/3*hidden rounded to 256 (swiglu)
    intermediate_size: Optional[int] = None
    max_seq_len: int = 1024
    pos_emb: str = "learned"                    # learned | rope | alibi | none
    # falcon adds alibi BEFORE the 1/sqrt(D) score scaling, bloom after:
    # the slopes carry the difference (`alibi_slopes`)
    alibi_scaled: bool = False
    norm: str = "layernorm"                     # layernorm | rmsnorm
    # gelu (tanh) | gelu_exact | swiglu | relu
    activation: str = "gelu"
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                       # partial rotary (phi/neox)
    # scaled RoPE as a hashable tuple (the reference's):
    #   ("linear", factor)
    #   ("llama3", factor, low_freq_factor, high_freq_factor,
    #    original_max_position_embeddings)
    #   ("yarn", factor, attention_factor, beta_fast, beta_slow,
    #    original_max_position_embeddings)
    #   ("longrope", attention_factor, original_max_position_embeddings,
    #    short_factors, long_factors)   (phi3; per-band divisors)
    rope_scaling: Optional[Tuple] = None
    qkv_bias: bool = False                      # qkv biases w/ rmsnorm (qwen2)
    embed_norm: bool = False                    # layernorm after tok embed
    head_bias: bool = False                     # bias on the lm head
    # OPT-350m block: the norms after each residual add
    post_norm: bool = False
    embed_proj_dim: Optional[int] = None        # narrow embedding space
    final_norm: bool = True
    parallel_residual: bool = False             # attn+mlp from the same x
    sliding_window: Optional[int] = None        # local attention (mistral)
    # qwen2-style per-layer windows (0 = full attention), num_layers long
    sliding_window_layers: Optional[Tuple[int, ...]] = None
    norm_eps: float = 1e-5
    dropout: float = 0.0                        # != 0 refused
    dtype: torch.dtype = torch.bfloat16         # compute dtype
    remat: bool = False                         # checkpoint every layer
    # auto: the kernels on a CUDA tensor (their plain versions on the
    # CPU); jnp: the plain versions on every device (what both engines'
    # `plain_kernels=True` selects, for comparisons on the card)
    attn_impl: str = "auto"
    # mixture-of-experts (served by exact top-k routing, `_moe_inference`;
    # training refused by `training_refusal`): >1 turns every layer's MLP
    # into a top-k gated expert layer (Mixtral-style)
    moe_experts: int = 1
    moe_top_k: int = 2
    # qwen2-moe's always-on shared expert of this width behind a sigmoid
    # gate (0: none)
    moe_shared_expert_ffn: int = 0
    # normalize the selected top-k gate probs to sum to 1 (mixtral: True,
    # HF qwen2-moe default: False)
    moe_norm_topk_prob: bool = True
    # qwen2-moe dense-interleaved stacks (mlp_only_layers /
    # decoder_sparse_step): 1 = a plain dense MLP of
    # `dense_intermediate_size` instead of the expert layer, num_layers long
    moe_dense_layers: Optional[Tuple[int, ...]] = None
    dense_intermediate_size: Optional[int] = None
    tiled_mlp_shards: int = 1                   # >1 refused
    tiled_loss_shards: int = 1      # >1: fused logits+loss, no [B,S,V]

    def __post_init__(self):
        refused = []
        if self.pos_emb not in ("learned", "rope", "alibi", "none"):
            raise ValueError(f"unknown pos_emb {self.pos_emb!r}")
        if self.dropout:
            refused.append("dropout")
        if self.tiled_mlp_shards > 1:
            refused.append("tiled_mlp_shards > 1")
        if refused:
            raise NotImplementedError(
                f"the PyTorch port does not carry {', '.join(refused)} yet "
                f"(scope: the gpt2/llama/qwen2/mistral/phi/phi3/falcon/"
                f"opt/bloom/gptneox blocks and the mixtral/qwen2_moe "
                f"expert layers)")
        # the reference's own checks of the block features
        if self.sliding_window_layers is not None:
            if len(self.sliding_window_layers) != self.num_layers:
                raise ValueError(
                    f"sliding_window_layers has "
                    f"{len(self.sliding_window_layers)} entries for "
                    f"{self.num_layers} layers")
            if self.sliding_window is not None:
                raise ValueError(
                    "set either sliding_window (homogeneous) or "
                    "sliding_window_layers (per-layer), not both")
        if self.parallel_residual and self.moe_experts > 1:
            raise ValueError(
                "parallel_residual (falcon/neox/phi block) with MoE is not "
                "supported")
        if self.moe_dense_layers is not None:
            if self.moe_experts <= 1:
                raise ValueError(
                    "moe_dense_layers requires moe_experts > 1 (it marks "
                    "which layers of an MoE stack are dense)")
            if len(self.moe_dense_layers) != self.num_layers:
                raise ValueError(
                    f"moe_dense_layers has {len(self.moe_dense_layers)} "
                    f"entries for {self.num_layers} layers")
            if self.dense_intermediate_size is None:
                raise ValueError(
                    "moe_dense_layers needs dense_intermediate_size (the "
                    "dense layers' FFN width — usually different from the "
                    "per-expert moe width)")
        if self.moe_shared_expert_ffn and self.moe_experts <= 1:
            raise ValueError(
                "moe_shared_expert_ffn requires moe_experts > 1 (the shared "
                "expert runs alongside routed experts; a dense model would "
                "silently ignore it)")
        if self.post_norm and (self.parallel_residual
                               or self.moe_experts > 1):
            raise ValueError(
                "post_norm (OPT-350m block) supports only the sequential "
                "dense block")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.activation not in ("gelu", "gelu_exact", "swiglu", "relu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} is not a multiple of "
                f"kv_heads={self.kv_heads}")
        if self.attn_impl not in ("auto", "jnp"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.embed_proj_dim and self.tiled_loss_shards > 1:
            raise ValueError(
                "tiled_loss_shards with embed_proj_dim is not supported: "
                "the fused tiled loss consumes hidden states directly and "
                "would skip the embed-out projection")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        if self.activation == "swiglu":
            # llama convention: 2/3 * 4h rounded to 256
            d = int(8 * self.hidden_size / 3)
            return 256 * ((d + 255) // 256)
        return 4 * self.hidden_size


def gpt2_config(size: str = "small", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     max_seq_len=512, vocab_size=1024),
        "small": dict(hidden_size=768, num_layers=12, num_heads=12),
        "medium": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "large": dict(hidden_size=1280, num_layers=36, num_heads=20),
        "xl": dict(hidden_size=1600, num_layers=48, num_heads=25),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048),
    }
    base = dict(vocab_size=50304, pos_emb="learned", norm="layernorm",
                activation="gelu", tie_embeddings=True, max_seq_len=1024)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def llama_config(size: str = "7b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=4, max_seq_len=512, vocab_size=32000),
        "1b": dict(hidden_size=2048, num_layers=22, num_heads=32,
                   num_kv_heads=4, max_seq_len=2048, vocab_size=32000),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   max_seq_len=4096, vocab_size=32000),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    max_seq_len=4096, vocab_size=32000),
        "70b": dict(hidden_size=8192, num_layers=80, num_heads=64,
                    num_kv_heads=8, intermediate_size=28672,
                    max_seq_len=4096, vocab_size=32000),
    }
    base = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                tie_embeddings=False)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def qwen2_config(size: str = "7b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=2, max_seq_len=512),
        "7b": dict(hidden_size=3584, num_layers=28, num_heads=28,
                   num_kv_heads=4, intermediate_size=18944,
                   max_seq_len=8192),
    }
    base = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                tie_embeddings=False, vocab_size=151936, qkv_bias=True,
                rope_theta=1000000.0)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def mistral_config(size: str = "7b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=2, max_seq_len=512, sliding_window=256),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   num_kv_heads=8, intermediate_size=14336,
                   max_seq_len=8192, sliding_window=4096),
    }
    base = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                tie_embeddings=False, vocab_size=32000)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def mixtral_config(size: str = "8x7b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=2, max_seq_len=512, moe_experts=4,
                     moe_top_k=2),
        "8x7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     num_kv_heads=8, intermediate_size=14336,
                     max_seq_len=8192, moe_experts=8, moe_top_k=2),
    }
    base = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                tie_embeddings=False, vocab_size=32000)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def qwen2_moe_config(size: str = "a2.7b", **kw) -> TransformerConfig:
    """Qwen2-MoE: routed experts with a small per-expert FFN plus an
    always-on shared expert behind a sigmoid gate."""
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=4, max_seq_len=512, vocab_size=1024,
                     intermediate_size=128, moe_experts=4, moe_top_k=2,
                     moe_shared_expert_ffn=256),
        # Qwen1.5-MoE-A2.7B geometry
        "a2.7b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                      num_kv_heads=16, intermediate_size=1408,
                      max_seq_len=8192, vocab_size=151936, moe_experts=60,
                      moe_top_k=4, moe_shared_expert_ffn=5632),
    }
    base = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                tie_embeddings=False, qkv_bias=True, rope_theta=1000000.0,
                moe_norm_topk_prob=False)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def phi3_config(size: str = "mini", **kw) -> TransformerConfig:
    """Phi-3: llama-style (RMSNorm, SwiGLU, full rotary, sequential
    residual); the 128k variants add longrope `rope_scaling`."""
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=8, max_seq_len=512, vocab_size=1024),
        "mini": dict(hidden_size=3072, num_layers=32, num_heads=32,
                     num_kv_heads=32, intermediate_size=8192,
                     max_seq_len=4096, vocab_size=32064),
        "medium": dict(hidden_size=5120, num_layers=40, num_heads=40,
                       num_kv_heads=10, intermediate_size=17920,
                       max_seq_len=4096, vocab_size=32064),
    }
    base = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                tie_embeddings=False)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def phi_config(size: str = "2", **kw) -> TransformerConfig:
    """phi-2: partial rotary (40%), one layernorm feeding a parallel
    attention + MLP block, biased q/k/v and lm head."""
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     max_seq_len=512, vocab_size=1024),
        "2": dict(hidden_size=2560, num_layers=32, num_heads=32,
                  max_seq_len=2048, vocab_size=51200),
    }
    base = dict(pos_emb="rope", rope_pct=0.4, norm="layernorm",
                activation="gelu", tie_embeddings=False,
                parallel_residual=True, head_bias=True)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def falcon_config(size: str = "7b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     num_kv_heads=1, max_seq_len=512, vocab_size=1024),
        "7b": dict(hidden_size=4544, num_layers=32, num_heads=71,
                   num_kv_heads=1, max_seq_len=2048, vocab_size=65024),
    }
    base = dict(pos_emb="rope", norm="layernorm", activation="gelu",
                tie_embeddings=True, parallel_residual=True)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def opt_config(size: str = "1.3b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     max_seq_len=512, vocab_size=1024),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=32,
                     max_seq_len=2048, vocab_size=50272),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    max_seq_len=2048, vocab_size=50272),
    }
    base = dict(pos_emb="learned", norm="layernorm", activation="relu",
                tie_embeddings=True)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def bloom_config(size: str = "7b", **kw) -> TransformerConfig:
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     max_seq_len=512, vocab_size=1024),
        "7b": dict(hidden_size=4096, num_layers=30, num_heads=32,
                   max_seq_len=2048, vocab_size=250880),
    }
    base = dict(pos_emb="alibi", norm="layernorm", activation="gelu",
                tie_embeddings=True, embed_norm=True)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def gptneox_config(size: str = "20b", **kw) -> TransformerConfig:
    """GPT-NeoX: partial rotary (25%), layernorm, gelu, parallel residual
    with two layernorms (`use_parallel_residual`)."""
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8,
                     max_seq_len=512, vocab_size=1024),
        "20b": dict(hidden_size=6144, num_layers=44, num_heads=64,
                    max_seq_len=2048, vocab_size=50432),
    }
    base = dict(pos_emb="rope", rope_pct=0.25, norm="layernorm",
                activation="gelu", tie_embeddings=False,
                parallel_residual=True)
    base.update(presets[size])
    base.update(kw)
    return TransformerConfig(**base)


def _alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi per-head slopes [num_heads] f32 (the reference's)."""
    p = 2 ** np.floor(np.log2(num_heads))
    slopes = 2.0 ** (-8.0 * (np.arange(1, p + 1) / p))
    if p < num_heads:
        extra = 2.0 ** (-4.0 * (np.arange(1, 2 * (num_heads - p) + 1, 2)
                                / p))
        slopes = np.concatenate([slopes, extra])
    return slopes[:num_heads].astype(np.float32)


def alibi_slopes(cfg: TransformerConfig) -> Optional[np.ndarray]:
    """[NH] f32 slopes of `cfg`'s ALiBi bias, divided by sqrt(D) for
    `alibi_scaled` (Falcon-RW adds the bias before the score scale), so
    every attention computes qk/sqrt(D) - slope (q_pos - k_pos); None
    without ALiBi."""
    if cfg.pos_emb != "alibi":
        return None
    slopes = _alibi_slopes(cfg.num_heads)
    if cfg.alibi_scaled:
        slopes = slopes / np.float32(math.sqrt(cfg.head_dim))
    return slopes


def layer_windows(cfg: TransformerConfig) -> Tuple[Optional[int], ...]:
    """Each layer's sliding window: `sliding_window_layers[i]` (0: full
    attention, None here), else `sliding_window` for every layer."""
    if cfg.sliding_window_layers is not None:
        return tuple(int(w) or None for w in cfg.sliding_window_layers)
    return (cfg.sliding_window,) * cfg.num_layers


def training_refusal(cfg: TransformerConfig) -> Optional[str]:
    """What of `cfg` the port's training path does not carry, by name, or
    None: the flash kernels take no ALiBi bias and no window, the
    backward kernels no head dim but 32, 64 and 128, and the post-norm
    and parallel-residual blocks are left to the same slice.  Expert
    layers train in the reference through the capacity-limited dispatch
    of `moe/sharded.py`, which the port does not carry."""
    names = [n for n, on in (
        ("alibi", cfg.pos_emb == "alibi"),
        ("sliding windows", cfg.sliding_window is not None
         or cfg.sliding_window_layers is not None),
        ("post_norm blocks", cfg.post_norm),
        ("parallel residual blocks", cfg.parallel_residual),
        ("mixture-of-experts layers", cfg.moe_experts > 1),
        (f"head dim {cfg.head_dim}",
         cfg.head_dim not in BWD_HEAD_DIMS)) if on]
    if not names:
        return None
    return (f"training with {', '.join(names)} is not carried by the "
            f"PyTorch port yet (its flash kernels take no bias and no "
            f"window, and its flash backward head dims "
            f"{BWD_HEAD_DIMS} only); these architectures are served, "
            f"not trained")


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device, dtype: torch.dtype = torch.float32
                ) -> Dict[str, object]:
    """Random parameters in the reference's stacked layout and key names
    (`_init_params` in the JAX module): normal(0.02) matrices, the output
    projections scaled by 1/sqrt(2L), ones for norm scales, zeros for
    biases.  `generator` must live on `device`; the draws differ from
    jax.random's, so parity tests convert JAX parameters instead
    (`models/convert.params_from_jax`)."""
    H, L = cfg.hidden_size, cfg.num_layers
    D, NH, NKV = cfg.head_dim, cfg.num_heads, cfg.kv_heads
    Fd, V = cfg.ffn_dim, cfg.vocab_size
    std = 0.02

    def rnd(shape, scale=std):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
        return x.mul_(scale)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    out_scale = std / math.sqrt(2 * L)
    layers: Dict[str, torch.Tensor] = {
        "attn_norm_scale": ones((L, H)),
        "mlp_norm_scale": ones((L, H)),
        "wq": rnd((L, H, NH * D)),
        "wk": rnd((L, H, NKV * D)),
        "wv": rnd((L, H, NKV * D)),
        "wo": rnd((L, NH * D, H), scale=out_scale),
    }
    if cfg.norm == "layernorm":
        layers["attn_norm_bias"] = zeros((L, H))
        layers["mlp_norm_bias"] = zeros((L, H))
        layers["bo"] = zeros((L, H))
    if cfg.norm == "layernorm" or cfg.qkv_bias:
        layers["bq"] = zeros((L, NH * D))
        layers["bk"] = zeros((L, NKV * D))
        layers["bv"] = zeros((L, NKV * D))
    if cfg.moe_experts > 1:
        # the reference's MoE leaves, keys and shapes
        E = cfg.moe_experts
        layers["moe_gate"] = rnd((L, H, E))
        layers["moe_w_up"] = rnd((L, E, H, Fd))
        layers["moe_w_down"] = rnd((L, E, Fd, H), scale=out_scale)
        if cfg.activation == "swiglu":
            layers["moe_w_gate_proj"] = rnd((L, E, H, Fd))
        if cfg.moe_dense_layers is not None:
            Fdn = cfg.dense_intermediate_size or Fd
            layers["w_up"] = rnd((L, H, Fdn))
            layers["w_down"] = rnd((L, Fdn, H), scale=out_scale)
            if cfg.activation == "swiglu":
                layers["w_gate"] = rnd((L, H, Fdn))
            else:
                layers["b_up"] = zeros((L, Fdn))
                layers["b_down"] = zeros((L, H))
        if cfg.moe_shared_expert_ffn:
            Fs = cfg.moe_shared_expert_ffn
            layers["moe_shared_w_up"] = rnd((L, H, Fs))
            layers["moe_shared_w_down"] = rnd((L, Fs, H), scale=out_scale)
            if cfg.activation == "swiglu":
                layers["moe_shared_w_gate_proj"] = rnd((L, H, Fs))
            layers["moe_shared_gate"] = rnd((L, H))
    elif cfg.activation == "swiglu":
        layers["w_gate"] = rnd((L, H, Fd))
        layers["w_up"] = rnd((L, H, Fd))
        layers["w_down"] = rnd((L, Fd, H), scale=out_scale)
    else:
        layers["w_up"] = rnd((L, H, Fd))
        layers["w_down"] = rnd((L, Fd, H), scale=out_scale)
        layers["b_up"] = zeros((L, Fd))
        layers["b_down"] = zeros((L, H))

    E = cfg.embed_proj_dim or H
    params: Dict[str, object] = {"tok_embed": rnd((V, E)), "layers": layers}
    if cfg.final_norm:
        params["final_norm_scale"] = ones((H,))
        if cfg.norm == "layernorm":
            params["final_norm_bias"] = zeros((H,))
    if cfg.embed_proj_dim:
        params["embed_in_proj"] = rnd((E, H))
        params["embed_out_proj"] = rnd((H, E))
    if cfg.pos_emb == "learned":
        params["pos_embed"] = rnd((cfg.max_seq_len, H), scale=0.01)
    if cfg.embed_norm:
        params["embed_norm_scale"] = ones((H,))
        params["embed_norm_bias"] = zeros((H,))
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd((E, V))
        if cfg.head_bias:
            params["lm_head_bias"] = zeros((V,))
    return params


# ----------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------
def _norm(x, scale, bias, kind: str, eps: float):
    """Norm with f32 statistics and affine, rounded once to x's dtype.
    layernorm is one fused kernel (PyTorch's layer_norm computes a bf16
    input in f32), not the f32 round trip of the JAX `_norm` op by op."""
    if kind == "layernorm":
        return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype),
                            None if bias is None else bias.to(x.dtype), eps)
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def _scale_rope_freqs(freqs, scaling, theta):
    """An HF-style rope_scaling spec applied to the inverse frequencies
    [half] f32 (the reference's): "linear" divides them all by the factor;
    "llama3" leaves the high frequencies, divides the low ones, and ramps
    between; "yarn" interpolates by parts with a linear ramp between the
    beta_fast / beta_slow rotation counts (its attention factor scales
    cos and sin in `_rope`)."""
    kind = scaling[0]
    if kind == "linear":
        return freqs / scaling[1]
    if kind == "llama3":
        _, factor, low_f, high_f, orig = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig / low_f
        high_wl = orig / high_f
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(wavelen > low_wl, freqs / factor,
                           torch.where(wavelen < high_wl, freqs, mid))
    if kind == "yarn":
        _, factor, _af, beta_fast, beta_slow, orig = scaling
        half = freqs.shape[0]
        dim = 2 * half

        def corr(rot):
            return (dim * math.log(orig / (rot * 2 * math.pi))
                    / (2 * math.log(theta)))
        low = max(math.floor(corr(beta_fast)), 0)
        high = min(math.ceil(corr(beta_slow)), dim - 1)
        ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                         device=freqs.device) - low)
                           / max(high - low, 1e-3), 0.0, 1.0)
        # interpolated (freq / factor) where ramp = 1, extrapolated at 0
        return (freqs / factor) * ramp + freqs * (1.0 - ramp)
    raise ValueError(f"unknown rope_scaling kind {kind!r} "
                     f"(supported: linear, llama3, yarn, longrope)")


# rope frequency tables on each device, by (half, theta, scaling, device)
_ROPE: Dict[tuple, tuple] = {}


def rope_tables(half: int, theta: float, scaling, device):
    """The inverse frequencies of a rotary embedding over 2 `half` dims,
    made once per device and kept (a captured decode group reads them by
    address, and a capture may copy nothing from the host): (freqs
    [half] f32, None) or, for longrope, (freqs / short_factors, freqs /
    long_factors), each [half] f32; and the attention factor that scales
    cos and sin (yarn, longrope) or None."""
    key = (half, float(theta), scaling, torch.device(device))
    if key not in _ROPE:
        freqs = torch.exp(-math.log(theta)
                          * torch.arange(half, dtype=torch.float32,
                                         device=device) / half)
        factor = None
        if scaling is not None and scaling[0] == "longrope":
            _, factor, _orig, short_f, long_f = scaling
            tables = tuple(
                freqs / torch.tensor(f, dtype=torch.float32, device=device)
                for f in (short_f, long_f))
        else:
            if scaling is not None:
                freqs = _scale_rope_freqs(freqs, scaling, theta)
                if scaling[0] == "yarn":
                    factor = scaling[2]
            tables = (freqs, None)
        _ROPE[key] = tables + (factor,)
    return _ROPE[key]


def _rope(x, positions, theta: float, pct: float = 1.0, scaling=None,
          regime_len=None):
    """Rotary embedding.  x: [B, S, N, D]; positions [B, S]; pct < 1
    rotates only the leading rotary_dim (phi, neox); `scaling` is a
    TransformerConfig.rope_scaling tuple.  For longrope each row takes
    the long factors where its `regime_len` [B] (a device tensor; the
    chunked prefill passes each row's whole prompt length) or, without
    it, max(positions) + 1 exceeds the original context, chosen on the
    device (a captured group replays the choice without a host read)."""
    if pct < 1.0:
        rd = (int(x.shape[-1] * pct) // 2) * 2
        return torch.cat([_rope(x[..., :rd], positions, theta,
                                scaling=scaling, regime_len=regime_len),
                          x[..., rd:]], dim=-1)
    D = x.shape[-1]
    half = D // 2
    freqs, long_freqs, factor = rope_tables(half, theta, scaling, x.device)
    pos = positions.float()
    if long_freqs is not None:
        # per-band divisors, chosen per row: short inside the original
        # context, long beyond it (HF's per-forward choice is the
        # one-sequence case of this)
        eff_len = (positions.amax(dim=-1) + 1 if regime_len is None
                   else regime_len)
        use_long = (eff_len > scaling[2])[:, None]                 # [B, 1]
        f = torch.where(use_long, long_freqs[None], freqs[None])   # [B,half]
        angles = pos[:, :, None] * f[:, None, :]                   # [B,S,half]
    else:
        angles = pos[:, :, None] * freqs[None, None, :]            # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if factor is not None:
        cos = cos * factor
        sin = sin * factor
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _act_fn(name: str):
    """Non-gated activation: "gelu" is the tanh approximation,
    "gelu_exact" the erf form.  On a bf16 input PyTorch computes in f32
    and rounds once, which is the JAX module's f32 round trip exactly."""
    if name == "relu":
        return F.relu
    if name == "gelu_exact":
        return F.gelu
    return lambda t: F.gelu(t, approximate="tanh")


def _embed_in(cfg: TransformerConfig, params, input_ids, dt):
    """Token embedding, projected up to hidden width when the model embeds
    in a narrower space."""
    x = params["tok_embed"][input_ids].to(dt)
    if "embed_in_proj" in params:
        x = (x @ params["embed_in_proj"].to(dt)).to(dt)
    return x


def _head_hidden(params, x, dt):
    """Final hidden states projected back to the embedding width before the
    lm head."""
    if "embed_out_proj" in params:
        x = (x @ params["embed_out_proj"].to(dt)).to(dt)
    return x


# ----------------------------------------------------------------------
# training forward
# ----------------------------------------------------------------------
def resolve_weight(w, dt):
    """A weight leaf as a matrix in `dt`: plain tensors cast; fp8 dicts
    (`quantize_serving_weights`) dequantized in f32 and rounded once —
    {"q_codes", "q_scales"} by groups of the last dim (the group count is
    the scales' last dim, so a layer's slice resolves alone),
    {"q_codes", "q_col_scales"} by output column (`_dense` applies those
    scales to the product instead, `resolve_weight_scaled`)."""
    if isinstance(w, dict):
        codes = w["q_codes"].float()
        if "q_col_scales" in w:
            return (codes * w["q_col_scales"][..., None, :]).to(dt)
        scales = w["q_scales"]
        g = codes.shape[-1] // scales.shape[-1]
        cf = codes.reshape(*codes.shape[:-1], scales.shape[-1], g)
        return (cf * scales[..., None]).reshape(codes.shape).to(dt)
    return w.to(dt)


def resolve_weight_scaled(w, dt):
    """(matrix, post-scale or None): column-granular fp8 weights give
    their codes in `dt` (e4m3 -> bf16 is exact) and their per-column f32
    scale, which commutes with the contraction and multiplies the
    product; every other leaf resolves as `resolve_weight`, with no
    post-scale."""
    if isinstance(w, dict) and "q_col_scales" in w:
        return w["q_codes"].to(dt), w["q_col_scales"]
    return resolve_weight(w, dt), None


def quantize_serving_weights(params, q_bits: int = 8, group_size: int = 128,
                             granularity: str = "column",
                             keys=("wq", "wk", "wv", "wo", "w_up",
                                   "w_down", "w_gate")):
    """The reference's serving-weight transform: each named layer-stack
    matmul weight becomes a dict of `torch.float8_e4m3fn` codes and f32
    scales (absmax / 448, e4m3's largest value), consumed by `_dense`;
    embeddings, norms and biases stay as they are.  An inference
    transform (training takes no dict leaves).

    granularity "column": one scale per output column (the last dim,
    absmax over the contraction dim), {"q_codes", "q_col_scales"};
    "group": one per `group_size` run of the last dim (the whole dim when
    it does not divide), {"q_codes", "q_scales"}, dequantized before the
    product."""
    if q_bits != 8:
        raise NotImplementedError("serving weight quantization ships fp8 "
                                  "(e4m3) — fp6/fp12 codecs exist in "
                                  "linear/quantization.py but are not "
                                  "wired to the zoo")
    if granularity not in ("group", "column"):
        raise ValueError(f"granularity must be group|column, got "
                         f"{granularity!r}")
    layers = dict(params["layers"])
    for k in keys:
        if k not in layers:
            continue
        w = layers[k]
        wf = w.float()
        if granularity == "column":
            amax = wf.abs().amax(dim=-2, keepdim=True) + 1e-12
            scale = amax / 448.0
            layers[k] = {"q_codes": (wf / scale).to(torch.float8_e4m3fn),
                         "q_col_scales": scale[..., 0, :]}
            continue
        r = w.shape[-1]
        g = group_size if r % group_size == 0 else r
        grouped = wf.reshape(*w.shape[:-1], r // g, g)
        amax = grouped.abs().amax(dim=-1, keepdim=True) + 1e-12
        scale = amax / 448.0
        codes = (grouped / scale).to(torch.float8_e4m3fn)
        layers[k] = {"q_codes": codes.reshape(w.shape),
                     "q_scales": scale[..., 0]}
    out = dict(params)
    out["layers"] = layers
    return out


def _dense(h, w, b=None):
    """[..., H] @ [H, D] in the activation dtype: bf16 in, f32
    accumulation, rounded once to the activation dtype (torch's matmul
    contract, with cuBLAS's split-K reductions kept in f32 by
    `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
    False`), then the bias added in that dtype — as the JAX `_dense`.
    fp8 dicts: column-granular codes feed the product in `dt`, whose f32
    result takes the column scale in f32 and is rounded once (rounding
    the product first would round twice); group-granular ones are
    dequantized first (`resolve_weight`)."""
    dt = h.dtype
    if isinstance(w, dict):
        mat, post = resolve_weight_scaled(w, dt)
        if post is None:
            out = h @ mat
        else:
            out = (dense_f32(h, mat) * post.float()).to(dt)
    else:
        out = h @ w.to(dt)
    if b is not None:
        out = out + b.to(dt)
    return out


class _DenseF32(torch.autograd.Function):
    """x [..., H] @ w [H, V] with an f32 result from bf16 operands (the
    JAX einsum with preferred_element_type=f32): the product is not
    rounded to bf16.  The backward takes the f32 cotangent to the
    operands' dtype and runs bf16 products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            # bf16 -> f32 is exact, so this is the same product
            out = x2.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w.t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw


def dense_f32(x, w):
    """x @ w with an f32 result (the lm head: logits stay f32)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    return _DenseF32.apply(x, w)


def _mlp_block(cfg: TransformerConfig, lp, h, col=_dense, row=_dense):
    """Dense MLP (swiglu / gelu / relu).  The activation is computed in
    f32 and rounded once (see `_act_fn`).  `col` / `row` compute the up
    (and gate) and the down projections, `col(h, w, b)` like `_dense`
    (the tensor-parallel programs pass their fused ring stages)."""
    if cfg.activation == "swiglu":
        h = F.silu(col(h, lp["w_gate"], None)) * col(h, lp["w_up"], None)
    else:
        h = _act_fn(cfg.activation)(col(h, lp["w_up"], lp.get("b_up")))
    return row(h, lp["w_down"], lp.get("b_down"))


def _shared_expert(cfg: TransformerConfig, lp, h):
    """qwen2-moe's always-on shared expert of the normed rows `h` [N, H],
    scaled by a per-token sigmoid gate of an f32 dot, cast to the
    activation dtype before the product (the reference's)."""
    dt = h.dtype
    u = _dense(h, lp["moe_shared_w_up"])
    if cfg.activation == "swiglu":
        act = F.silu(_dense(h, lp["moe_shared_w_gate_proj"])) * u
    else:
        act = _act_fn(cfg.activation)(u)
    out = _dense(act, lp["moe_shared_w_down"])
    gate = h.float() @ lp["moe_shared_gate"].float()
    return out * torch.sigmoid(gate)[..., None].to(dt)


def _sorted_slots(gids, G: int):
    """Where each token-expert assignment lands when the assignments are
    sorted by group, stably (the reference's `argsort(gids, stable=True)`
    over the flattened [T, k] ids), computed without a sort: a token picks
    k distinct groups, so assignment (t, j) sits at offsets[g] + the
    number of earlier tokens in group g.  gids: [T, k] int64 on the
    device.  Returns (pos [T, k] int64, offsets [G+1] int32): the group
    sizes are a column sum of the [T, G] pick matrix, so nothing is read
    on the host and nothing is summed by atomics."""
    T, k = gids.shape
    pick = torch.zeros(T, G, dtype=torch.int32, device=gids.device)
    pick.scatter_(1, gids, 1)
    sizes = pick.sum(dim=0, dtype=torch.int32)
    offsets = torch.zeros(G + 1, dtype=torch.int32, device=gids.device)
    offsets[1:] = torch.cumsum(sizes, dim=0, dtype=torch.int32)
    before = torch.cumsum(pick, dim=0, dtype=torch.int32) - pick   # [T, G]
    pos = offsets[gids] + before.gather(1, gids)
    return pos.long(), offsets


def _in_group_order(pos, gids):
    """Each token's k sorted positions in ascending group order ([T, k]):
    the rank of pick j among its token's k distinct groups, then a
    scatter to that rank (no sort kernel)."""
    rank = (gids[:, None, :] < gids[:, :, None]).sum(dim=-1)          # [T, k]
    return torch.zeros_like(pos).scatter_(1, rank, pos)


def _moe_inference(cfg: TransformerConfig, lp, h, with_census=False):
    """Exact top-k MoE of the normed rows `h` [..., H] (the reference's,
    for serving): no capacity and no dropping, so each token's output
    depends on its own routing only.

    - softmax over the f32 router logits, then the top k; the combine
      weights are the selected probabilities, normalised over the k only
      when `cfg.moe_norm_topk_prob` is set;
    - the assignments sorted stably by expert id (by slot id when `lp`
      carries the expert pages, `moe_slot_map` / `moe_resident_mask`):
      `_sorted_slots`, with no sort and no read on the host;
    - the three grouped products (gate, up, down for swiglu) through
      `ops.moe_grouped.grouped_matmul` with f32 results, in the
      reference's casts: `up` rounded to the dtype, the gate kept f32
      through SiLU;
    - the combine in f32: each token's k weighted products gathered back
      and added in sorted-group order, the order the reference's
      `.at[].add` walks (no float atomics, so reruns are equal); then
      the shared expert where the config has one.

    Paged layers (`serving.experts.ExpertPool`): the router logits of
    non-resident experts are masked to -1e30 before the softmax, so their
    tokens fall to the best resident expert, and the products run over the
    slot stacks `moe_*_slots` [S, ...].  torch.topk's order among tied
    values is not jax.lax.top_k's (lower index first), and only masked
    logits tie: that cannot bite while at least k experts are resident,
    which the pool enforces (`slots_per_layer >= top_k`).

    with_census: also return the [E+1] int32 census row — each expert's
    count of the assignments the router wanted (the unmasked top k), and
    in the last column the assignments rerouted off non-resident
    experts."""
    from ..ops.moe_grouped import grouped_matmul, grouped_matmul_reference
    # attn_impl="jnp" (the engines' plain_kernels) takes the plain version
    gmm = (grouped_matmul_reference if cfg.attn_impl == "jnp"
           else grouped_matmul)
    dt = h.dtype
    lead, H = h.shape[:-1], h.shape[-1]
    k, E = cfg.moe_top_k, cfg.moe_experts
    xt = h.reshape(-1, H)
    T = xt.shape[0]
    paged = "moe_slot_map" in lp

    logits = xt.float() @ lp["moe_gate"].float()                  # [T, E]
    if paged:
        raw_logits = logits
        # ties among the masked logits cannot reach the top k while the
        # pool keeps at least k experts resident (see the docstring)
        logits = torch.where(lp["moe_resident_mask"][None, :], logits,
                             torch.full_like(logits, -1e30))
    gates = torch.softmax(logits, dim=-1)
    topi = torch.topk(logits, k, dim=-1).indices                  # [T, k]
    sel = gates.gather(1, topi)
    if cfg.moe_norm_topk_prob:
        weight = sel / torch.clamp_min(sel.sum(dim=1, keepdim=True), 1e-9)
    else:
        weight = sel

    if paged:
        # masked routing guarantees resident targets; the clamp covers
        # only the no-resident-expert corner (the pool refuses it)
        gids = lp["moe_slot_map"].long()[topi].clamp_min(0)
        w_up, w_down = lp["moe_w_up_slots"], lp["moe_w_down_slots"]
        w_gp = lp.get("moe_w_gate_proj_slots")
    else:
        gids = topi
        w_up, w_down = lp["moe_w_up"], lp["moe_w_down"]
        w_gp = lp.get("moe_w_gate_proj")
    G = w_up.shape[0]
    pos, offsets = _sorted_slots(gids, G)
    flat = pos.reshape(-1)
    # zeros, not empty: every position is written while the picks of a
    # token are distinct, which the pool guarantees (see the clamp above)
    token_of = torch.zeros(T * k, dtype=torch.long, device=h.device)
    token_of[flat] = torch.arange(T * k, device=h.device) // k
    xs = xt.index_select(0, token_of)                             # [T*k, H]

    up = gmm(xs, w_up.to(dt), offsets).to(dt)
    if cfg.activation == "swiglu":
        g = gmm(xs, w_gp.to(dt), offsets)
        act = F.silu(g).to(dt) * up
    else:
        act = _act_fn(cfg.activation)(up)
    down = gmm(act, w_down.to(dt), offsets)                       # f32

    w_sorted = torch.zeros(T * k, dtype=torch.float32, device=h.device)
    w_sorted[flat] = weight.reshape(-1)
    contrib = down * w_sorted[:, None]
    order = _in_group_order(pos, gids)
    out = contrib.index_select(0, order[:, 0])
    for j in range(1, k):
        out = out + contrib.index_select(0, order[:, j])
    out = out.to(dt).reshape(*lead, H)
    if cfg.moe_shared_expert_ffn:
        out = out + _shared_expert(cfg, lp, h)
    if not with_census:
        return out
    row = torch.zeros(E + 1, dtype=torch.int32, device=h.device)
    if paged:
        # count what the router wanted (the unmasked top k), so demoted
        # experts keep accruing demand; the last column counts the
        # assignments that had to reroute
        wanted = torch.topk(raw_logits, k, dim=-1).indices
        row[:E] = torch.zeros(T, E, dtype=torch.int32,
                              device=h.device).scatter_(1, wanted, 1).sum(
            dim=0, dtype=torch.int32)
        row[E] = (~lp["moe_resident_mask"][wanted]).sum(dtype=torch.int32)
    else:
        # unpaged, each expert's group is what the router wanted of it
        row[:E] = offsets.diff()
    return out, row


def _ffn(cfg: TransformerConfig, lp, h, li: int = 0, census=None):
    """A layer's MLP of the normed rows `h`: the dense MLP, or the exact
    top-k expert layer on an MoE config, except where
    `cfg.moe_dense_layers[li]` marks layer `li` dense (qwen2-moe's
    mlp_only_layers; the flag is static config, so the choice is made
    here on the host, where the reference computes both and keeps one
    with a `where`).  `census` ([L, E+1] int32 on the device): the
    layer's census row is added to row `li` in place (a dense layer adds
    none, as the reference's zero row)."""
    if cfg.moe_experts <= 1 or (cfg.moe_dense_layers is not None
                                and cfg.moe_dense_layers[li]):
        return _mlp_block(cfg, lp, h)
    if census is None:
        return _moe_inference(cfg, lp, h)
    out, row = _moe_inference(cfg, lp, h, with_census=True)
    census[li].add_(row)
    return out


def _alibi_bias(cfg: TransformerConfig, S: int, device):
    """[1, NH, S, S] f32 additive score bias -slope (q_pos - k_pos)."""
    slopes = torch.from_numpy(alibi_slopes(cfg)).to(device)
    pos = torch.arange(S, device=device, dtype=torch.float32)
    dist = pos[:, None] - pos[None, :]
    return -(slopes[:, None, None] * dist[None])[None]


def _layer(cfg: TransformerConfig, x, lp, positions, window=None):
    """One transformer block over the full sequence: pre-norm sequential,
    post-norm (`cfg.post_norm`) or parallel residual
    (`cfg.parallel_residual`), as the reference's `_layer`.  x: [B, S, H]
    in the compute dtype; lp: this layer's weights; `window`: this
    layer's sliding window (None: full attention)."""
    from ..ops.attention import causal_attention
    B, S, _ = x.shape
    NH, NKV, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    x_in = x
    h = x if cfg.post_norm else _norm(x, lp["attn_norm_scale"],
                                      lp.get("attn_norm_bias"), cfg.norm,
                                      cfg.norm_eps)
    q = _dense(h, lp["wq"], lp.get("bq")).reshape(B, S, NH, D)
    k = _dense(h, lp["wk"], lp.get("bk")).reshape(B, S, NKV, D)
    v = _dense(h, lp["wv"], lp.get("bv")).reshape(B, S, NKV, D)
    if cfg.pos_emb == "rope":
        q = _rope(q, positions, cfg.rope_theta, cfg.rope_pct,
                  cfg.rope_scaling)
        k = _rope(k, positions, cfg.rope_theta, cfg.rope_pct,
                  cfg.rope_scaling)
    bias = (_alibi_bias(cfg, S, x.device) if cfg.pos_emb == "alibi"
            else None)
    attn = causal_attention(q, k, v, plain=cfg.attn_impl == "jnp",
                            bias=bias, sliding_window=window)
    return _block_out(cfg, lp, x_in, _dense(attn.reshape(B, S, NH * D),
                                            lp["wo"], lp.get("bo")))


def _block_out(cfg: TransformerConfig, lp, x, attn_out, li: int = 0,
               census=None):
    """The rest of layer `li` after its attention output `attn_out`, on
    the layer's input `x` (the reference's blocks): parallel residual
    (attention and MLP both read x), post-norm (a norm after each
    residual add) or pre-norm sequential, whose MLP is `_ffn` (an expert
    layer on an MoE config; the config refuses experts in the other two
    blocks), with `census` as there."""
    def mlp_norm(h):
        return _norm(h, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"),
                     cfg.norm, cfg.norm_eps)
    if cfg.parallel_residual:
        return x + attn_out + _mlp_block(cfg, lp, mlp_norm(x))
    if cfg.post_norm:
        x = _norm(x + attn_out, lp["attn_norm_scale"],
                  lp.get("attn_norm_bias"), cfg.norm, cfg.norm_eps)
        return mlp_norm(x + _mlp_block(cfg, lp, x))
    x = x + attn_out
    return x + _ffn(cfg, lp, mlp_norm(x), li, census)


def _layer_params(layers, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's weights: from a list of per-layer dicts, or as views
    into the stacked [L, ...] leaves (an fp8 dict's codes and scales
    each)."""
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return {k: ({kk: vv[i] for kk, vv in w.items()} if isinstance(w, dict)
                else w[i]) for k, w in layers.items()}


def _lm_head(params):
    """Output projection [E, V]: the explicit lm_head or the tied token
    embedding's transpose (its gradient then adds from both uses)."""
    head = params.get("lm_head")
    return params["tok_embed"].t() if head is None else head


def _forward(cfg: TransformerConfig, params, input_ids, positions=None,
             return_hidden: bool = False, remat_policy: str = None):
    """f32 logits [B, S, V] for [B, S] token ids, or the final hidden
    states with `return_hidden`.  `remat_policy` names the checkpoint
    policy when `cfg.remat` is set.  What `training_refusal` names runs
    on the CPU only (the plain forward the tests hold against JAX's)."""
    B, S = input_ids.shape
    dt = cfg.dtype
    refusal = training_refusal(cfg)
    if refusal is not None and (input_ids.device.type != "cpu"
                                or cfg.moe_experts > 1):
        raise NotImplementedError(refusal)
    if positions is None:
        positions = torch.arange(S, device=input_ids.device)[None].expand(
            B, S)
    x = _embed_in(cfg, params, input_ids, dt)
    if cfg.pos_emb == "learned":
        x = x + params["pos_embed"][positions].to(dt)
    if cfg.embed_norm:
        x = _norm(x, params["embed_norm_scale"], params["embed_norm_bias"],
                  "layernorm", cfg.norm_eps)
    layer_fn = partial(_layer, cfg)
    if cfg.remat:
        from ..runtime.activation_checkpointing import checkpoint_wrapper
        layer_fn = checkpoint_wrapper(layer_fn, remat_policy)
    for i, window in enumerate(layer_windows(cfg)):
        x = layer_fn(x, _layer_params(params["layers"], i), positions,
                     window)
    if cfg.final_norm:
        x = _norm(x, params["final_norm_scale"],
                  params.get("final_norm_bias"), cfg.norm, cfg.norm_eps)
    if return_hidden:
        return x
    logits = dense_f32(_head_hidden(params, x, dt), _lm_head(params))
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"].float()
    return logits


def _lm_loss(cfg: TransformerConfig, params, batch, rng=None,
             remat_policy: str = None):
    """Next-token cross-entropy.  batch: {"input_ids": [B, S]} (labels
    default to the shifted inputs) or explicit {"input_ids", "labels",
    "mask"?}.  Returns (loss, {"ppl_log": loss})."""
    ids = batch["input_ids"]
    labels = batch.get("labels")
    mask = batch.get("mask")
    if (labels is None and ids.shape[1] <= cfg.max_seq_len
            and (mask is None or mask.shape[1] == ids.shape[1])):
        # keep the full S sequence (so S-divisible features such as the
        # tiled loss stay active) and mask the final position instead of
        # slicing to S-1; the masked mean equals the sliced mean exactly
        inputs = ids
        labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], 1)
        last_off = torch.cat([torch.ones_like(ids[:, 1:]),
                              torch.zeros_like(ids[:, :1])], 1)
        mask = last_off if mask is None else mask * last_off
    elif labels is None:
        # S = max_seq_len + 1 shift-by-one idiom: slice
        labels = ids[:, 1:]
        inputs = ids[:, :-1]
    else:
        inputs = ids
    if cfg.tiled_loss_shards > 1:
        from ..sequence.tiled import tiled_fused_logits_loss
        hidden = _forward(cfg, params, inputs, return_hidden=True,
                          remat_policy=remat_policy)
        loss = tiled_fused_logits_loss(
            hidden, _lm_head(params), labels, shards=cfg.tiled_loss_shards,
            mask=mask, bias=params.get("lm_head_bias"))
    else:
        logits = _forward(cfg, params, inputs, remat_policy=remat_policy)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        if mask is not None:
            maskf = mask.float()
            loss = (nll * maskf).sum() / torch.clamp_min(maskf.sum(), 1.0)
        else:
            loss = nll.mean()
    return loss, {"ppl_log": loss.detach()}


class Transformer:
    """Bundle of init / loss / forward for the training engine
    (`deepspeed_tpu_torch.initialize(model=...)`)."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32):
        """Random parameters on the generator's device (`init_params`)."""
        return init_params(self.cfg, generator, generator.device, dtype)

    def loss_fn(self, params, batch, rng=None, remat_policy: str = None):
        return _lm_loss(self.cfg, params, batch, rng, remat_policy)

    def forward(self, params, input_ids, positions=None):
        return _forward(self.cfg, params, input_ids, positions)

    def num_params(self, params=None) -> int:
        if params is None:
            params = init_params(self.cfg, None, "meta")
        from ..utils.tree import count_params
        return count_params(params)
