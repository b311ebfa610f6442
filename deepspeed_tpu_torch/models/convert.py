"""JAX parameter and optimizer-state pytrees (as numpy arrays) -> the
port's tensors, and the tensor-parallel shard of a parameter tree.

Both packages keep the same stacked, in-first layout and key names
(`layers.wq` `[L, H, NH*D]`, `tok_embed` `[V, E]`, ...), so conversion is
a copy per leaf: nothing is transposed or renamed.  The caller fetches the
JAX tree to host first (`jax.device_get`), which keeps this module free of
any JAX import.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .transformer import TransformerConfig

__all__ = ["params_from_jax", "opt_state_from_jax", "shard_params_tp",
           "TP_SPLIT_DIMS", "fp8_leaf"]

# The reference's Megatron partition rules (`_TP_RULES`,
# deepspeed_tpu/models/transformer.py) as the dim of each stacked leaf that
# the tp axis splits: column-parallel leaves (q/k/v, MLP up/gate and their
# biases) on their output dim, row-parallel ones (attention out, MLP down)
# on their input dim, the embedding and lm head on the vocabulary.  Every
# other leaf is replicated.  (The MoE rules are left out: the fused ring
# refuses MoE layers, as the reference's does.)
TP_SPLIT_DIMS = {
    "wq": 2, "wk": 2, "wv": 2, "bq": 1, "bk": 1, "bv": 1,
    "w_up": 2, "w_gate": 2, "b_up": 1,
    "wo": 1, "w_down": 1,
    "tok_embed": 0, "lm_head": 1, "lm_head_bias": 0,
}


def _leaf(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.kind != "f":
        raise NotImplementedError(
            f"non-float parameter leaf of dtype {a.dtype} (the port carries "
            f"float leaves and the fp8 serving-weight dicts)")
    # bf16 has no numpy dtype of its own here: go through float32
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return t.to(device=device, dtype=dtype)


# the fp8 serving-weight dicts (`quantize_serving_weights`) by key set
_FP8_KEYS = (frozenset({"q_codes", "q_col_scales"}),
            frozenset({"q_codes", "q_scales"}))


def _fp8_codes(x, device) -> torch.Tensor:
    """fp8 e4m3 codes as a `torch.float8_e4m3fn` tensor on `device`: a
    tensor of that dtype as it is, or a numpy array of the ml_dtypes
    float8_e4m3fn type through a uint8 view (torch.from_numpy has no
    float8).  The codes are never cast: they keep their byte."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float8_e4m3fn:
            raise TypeError(f"fp8 codes of dtype {x.dtype} (want "
                            f"torch.float8_e4m3fn)")
        return x.to(device)
    a = np.asarray(x)
    if a.dtype.name != "float8_e4m3fn" or a.dtype.itemsize != 1:
        raise TypeError(f"fp8 codes of dtype {a.dtype} (want "
                        f"float8_e4m3fn)")
    t = torch.from_numpy(np.array(a).view(np.uint8))     # a writable copy
    return t.view(torch.float8_e4m3fn).to(device)


def fp8_leaf(w: Dict, device) -> Dict:
    """An fp8 serving-weight dict on `device`: its codes as `_fp8_codes`,
    its scales f32 (the dequantize and the post-scale multiply in f32).
    Raises on any other dict."""
    if frozenset(w) not in _FP8_KEYS:
        raise NotImplementedError(
            f"a parameter leaf of keys {sorted(w)}: the port carries the "
            f"fp8 serving-weight dicts {{q_codes, q_col_scales}} and "
            f"{{q_codes, q_scales}} only")
    scale_key = "q_col_scales" if "q_col_scales" in w else "q_scales"
    s = w[scale_key]
    s = s if isinstance(s, torch.Tensor) else torch.from_numpy(
        np.array(s, np.float32))
    return {"q_codes": _fp8_codes(w["q_codes"], device),
            scale_key: s.to(device=device, dtype=torch.float32)}


def _moe_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """The MoE leaves an MoE config's layers carry, by key, with their
    stacked shapes (the reference's `init_params`): the router, the
    expert stacks, qwen2-moe's shared expert and the dense MLP of a
    dense-interleaved stack; {} for a dense config."""
    if cfg.moe_experts <= 1:
        return {}
    L, H, E, F = (cfg.num_layers, cfg.hidden_size, cfg.moe_experts,
                  cfg.ffn_dim)
    swiglu = cfg.activation == "swiglu"
    out = {"moe_gate": (L, H, E), "moe_w_up": (L, E, H, F),
           "moe_w_down": (L, E, F, H)}
    if swiglu:
        out["moe_w_gate_proj"] = (L, E, H, F)
    if cfg.moe_shared_expert_ffn:
        Fs = cfg.moe_shared_expert_ffn
        out.update(moe_shared_w_up=(L, H, Fs), moe_shared_w_down=(L, Fs, H),
                   moe_shared_gate=(L, H))
        if swiglu:
            out["moe_shared_w_gate_proj"] = (L, H, Fs)
    if cfg.moe_dense_layers is not None:
        Fd = cfg.dense_intermediate_size or F
        out.update(w_up=(L, H, Fd), w_down=(L, Fd, H))
        if swiglu:
            out["w_gate"] = (L, H, Fd)
    return out


def params_from_jax(np_tree: Dict, cfg: TransformerConfig, device,
                    dtype: torch.dtype = None) -> Dict:
    """Convert a JAX parameter tree of numpy arrays to torch tensors on
    `device` in `dtype` (default `cfg.dtype`), keeping every key; the fp8
    serving-weight dicts of `layers` keep their 1-byte codes and f32
    scales (`fp8_leaf`).  Raises on a leaf whose shape disagrees with
    `cfg`'s stacked layout: the attention projections, the embedding and
    head leaves, and on an MoE config its router, expert stacks, shared
    expert and dense-interleaved MLP (`_moe_shapes`), each of which must
    be there."""
    dtype = dtype or cfg.dtype
    out: Dict = {}
    for key, val in np_tree.items():
        if isinstance(val, dict):
            if key != "layers":
                raise NotImplementedError(
                    f"nested parameter group {key!r} (only 'layers' is "
                    f"carried)")
            out[key] = {k: (fp8_leaf(v, device) if isinstance(v, dict)
                            else _leaf(v, device, dtype))
                        for k, v in val.items()}
        else:
            out[key] = _leaf(val, device, dtype)
    L, H = cfg.num_layers, cfg.hidden_size
    E, V = cfg.embed_proj_dim or H, cfg.vocab_size
    want = {"wq": (L, H, cfg.num_heads * cfg.head_dim),
            "wk": (L, H, cfg.kv_heads * cfg.head_dim),
            "wv": (L, H, cfg.kv_heads * cfg.head_dim),
            "wo": (L, cfg.num_heads * cfg.head_dim, H)}
    want.update(_moe_shapes(cfg))
    for k, shape in want.items():
        if k not in out["layers"]:
            raise ValueError(f"layers.{k} is missing: config wants {shape}")
        leaf = out["layers"][k]
        got = tuple((leaf["q_codes"] if isinstance(leaf, dict)
                     else leaf).shape)
        if got != shape:
            raise ValueError(f"layers.{k} has shape {got}, config wants "
                             f"{shape}")
    # the leaves of the embedding and the head, those of the narrow
    # embedding space (OPT-350m), the embedding norm (bloom) and the head
    # bias included, wherever the tree has them
    top = {"tok_embed": (V, E), "embed_in_proj": (E, H),
           "embed_out_proj": (H, E), "embed_norm_scale": (H,),
           "embed_norm_bias": (H,), "lm_head": (E, V),
           "lm_head_bias": (V,)}
    for k, shape in top.items():
        if k in out and tuple(out[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(out[k].shape)}, config "
                             f"wants {shape}")
    return out


def opt_state_from_jax(np_state: Dict, device) -> Dict:
    """Convert a JAX optimizer state ({"m": tree, "m_scale": tree, ...},
    leaves as numpy arrays) to torch tensors on `device`, keeping each
    leaf's dtype: int8/uint8 codes stay codes, f32 scales and moments stay
    f32, bf16 moments stay bf16."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.kind in "iu":
            return torch.from_numpy(np.array(a)).to(device)
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" \
            else torch.float32
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32))).to(device=device, dtype=dtype)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)
    return walk(np_state)


def shard_params_tp(params: Dict, tp: int, rank: int) -> Dict:
    """Rank `rank`'s shard of the full parameter tree for tensor
    parallelism of degree `tp`: every leaf named in `TP_SPLIT_DIMS` cut to
    its rank-th contiguous chunk along that dim, every other leaf as it is.
    Leaves may be numpy arrays or torch tensors; a cut leaf is a contiguous
    copy (so the full tree can be freed).  Raises if a split dim does not
    divide by tp."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")

    def cut(name, x):
        dim = TP_SPLIT_DIMS.get(name)
        if dim is None or tp == 1:
            return x
        n = x.shape[dim]
        if n % tp:
            raise ValueError(f"{name} has {n} entries along dim {dim}, not "
                             f"divisible by tp={tp}")
        c = n // tp
        piece = x[(slice(None),) * dim + (slice(rank * c, (rank + 1) * c),)]
        if isinstance(piece, torch.Tensor):
            return piece.contiguous()
        return np.ascontiguousarray(piece)

    return {k: ({kk: cut(kk, vv) for kk, vv in v.items()}
                if isinstance(v, dict) else cut(k, v))
            for k, v in params.items()}
