"""Decoder-only transformer config, parameters and layer math in PyTorch.

Counterpart of `deepspeed_tpu/models/transformer.py`.  The parameter
layout is the reference's stacked one: every layer weight carries a
leading layer dim (`layers.wq` is `[L, H, NH*D]`, in-first), so a JAX
checkpoint converts without a transpose (`models/convert.py`).  Where the
reference scans over that dim, the port loops over it in Python.

Scope: the pre-norm sequential dense families (gpt2, llama, qwen2) —
rope or learned positions, rmsnorm or layernorm, swiglu or gelu, GQA,
qkv/output biases.  The config refuses the features the port does not
carry yet, by name, at construction (`NotImplementedError`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["TransformerConfig", "gpt2_config", "llama_config",
           "qwen2_config", "init_params", "resolve_weight_scaled"]


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
    pos_emb: str = "learned"                    # learned | rope | none
    norm: str = "layernorm"                     # layernorm | rmsnorm
    # gelu (tanh) | gelu_exact | swiglu | relu
    activation: str = "gelu"
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                       # partial rotary
    rope_scaling: Optional[Tuple] = None        # refused
    qkv_bias: bool = False                      # qkv biases w/ rmsnorm (qwen2)
    embed_norm: bool = False                    # layernorm after tok embed
    head_bias: bool = False                     # bias on the lm head
    post_norm: bool = False                     # refused
    embed_proj_dim: Optional[int] = None        # narrow embedding space
    final_norm: bool = True
    parallel_residual: bool = False             # refused
    sliding_window: Optional[int] = None        # refused
    sliding_window_layers: Optional[Tuple[int, ...]] = None   # refused
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16         # compute dtype
    moe_experts: int = 1                        # >1 refused

    def __post_init__(self):
        refused = []
        if self.pos_emb == "alibi":
            refused.append("alibi position bias")
        elif self.pos_emb not in ("learned", "rope", "none"):
            raise ValueError(f"unknown pos_emb {self.pos_emb!r}")
        if self.sliding_window is not None or \
                self.sliding_window_layers is not None:
            refused.append("sliding-window attention")
        if self.post_norm:
            refused.append("post_norm blocks")
        if self.parallel_residual:
            refused.append("parallel_residual blocks")
        if self.rope_scaling is not None:
            refused.append("rope_scaling")
        if self.moe_experts > 1:
            refused.append("mixture-of-experts layers")
        if refused:
            raise NotImplementedError(
                f"the PyTorch port does not carry {', '.join(refused)} yet "
                f"(scope: pre-norm sequential dense gpt2/llama/qwen2)")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.activation not in ("gelu", "gelu_exact", "swiglu", "relu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} is not a multiple of "
                f"kv_heads={self.kv_heads}")

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
    if cfg.activation == "swiglu":
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
    xf = x.float()
    if kind == "rmsnorm":
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * scale
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale
        if bias is not None:
            out = out + bias
    return out.to(x.dtype)


def _rope(x, positions, theta: float, pct: float = 1.0):
    """Rotary embedding (no scaling).  x: [B, S, N, D]; positions [B, S];
    pct < 1 rotates only the leading rotary_dim."""
    if pct < 1.0:
        rd = (int(x.shape[-1] * pct) // 2) * 2
        return torch.cat([_rope(x[..., :rd], positions, theta),
                          x[..., rd:]], dim=-1)
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions.float()[:, :, None] * freqs[None, None, :]  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _act_fn(name: str):
    """Non-gated activation in fp32: "gelu" is the tanh approximation,
    "gelu_exact" the erf form."""
    if name == "relu":
        return F.relu
    if name == "gelu_exact":
        return F.gelu
    return lambda t: F.gelu(t, approximate="tanh")


def resolve_weight_scaled(w, dt):
    """(matrix, post_scale_or_None).  The port serves plain weights only:
    the reference's fp8 code/scale dicts are refused by name."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized serving weights are not carried by the PyTorch port "
            "yet (plain weights only)")
    return w.to(dt), None


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
