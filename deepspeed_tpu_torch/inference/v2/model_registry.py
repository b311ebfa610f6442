"""Per-architecture engine factory.

Counterpart of `deepspeed_tpu/inference/v2/model_registry.py`: maps an
architecture name to a model family's config preset and builds the ragged
engine.  The port serves the pre-norm sequential dense families (gpt2,
llama, qwen2); the reference's other architectures are refused by name.
"""
from __future__ import annotations

from typing import Optional

from ...models import get_model_config
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig

__all__ = ["ARCH_REGISTRY", "arch_config", "build_engine"]

# arch name (HF-style, lowercased) -> models/ family key
ARCH_REGISTRY = {
    "gpt2": "gpt2",
    "llama": "llama",
    "llama_v2": "llama",
    "qwen2": "qwen2",
    "qwen_v2": "qwen2",
}

# architectures the reference serves that the port does not carry yet
_NOT_PORTED = ("mistral", "mixtral", "qwen_v2_moe", "qwen2_moe", "phi",
               "phi3", "falcon", "opt", "bloom", "gptneox")


def arch_config(arch: str, size: Optional[str] = None, **kw):
    """Architecture name -> TransformerConfig."""
    key = arch.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not carried by the PyTorch port yet "
            f"(supported: {sorted(ARCH_REGISTRY)})")
    if key not in ARCH_REGISTRY:
        raise ValueError(f"unsupported architecture {arch!r}; supported: "
                         f"{sorted(ARCH_REGISTRY)}")
    return get_model_config(ARCH_REGISTRY[key], size, **kw)


def build_engine(arch: str, size: Optional[str] = None, params=None,
                 engine_config: Optional[RaggedInferenceEngineConfig] = None,
                 device="cuda", **cfg_kw) -> InferenceEngineV2:
    """Arch string in, serving engine out.  `params`: a parameter dict in
    the reference's stacked layout (torch tensors or numpy arrays, e.g.
    from `models.params_from_jax`); None draws random weights from a
    seeded `torch.Generator` on `device`.  `device` defaults to "cuda" and
    raises when no CUDA device is present.  With `engine_config=
    RaggedInferenceEngineConfig(tensor_parallel_size=N,
    tp_collectives="fused")` every one of N ranks calls this after
    `comm.init_distributed` and serves its shard on its own card."""
    cfg = arch_config(arch, size, **cfg_kw)
    return InferenceEngineV2(cfg, params=params, config=engine_config,
                             device=device)
