"""Per-architecture engine factory.

Counterpart of `deepspeed_tpu/inference/v2/model_registry.py`: maps an
architecture name to a model family's config preset and builds the ragged
engine (`build_engine`), or builds it from an HF checkpoint
(`build_hf_engine`, through `models/hf_loader.py`).  The port serves
every architecture the reference's registry names: gpt2, llama, qwen2,
mistral, mixtral, qwen2_moe, phi, phi3, falcon, opt, bloom and gptneox.
"""
from __future__ import annotations

from typing import Optional

from ...models import get_model_config
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig

__all__ = ["ARCH_REGISTRY", "arch_config", "build_engine",
           "build_hf_engine"]

# arch name (HF-style, lowercased) -> models/ family key
ARCH_REGISTRY = {
    "gpt2": "gpt2",
    "llama": "llama",
    "llama_v2": "llama",
    "mistral": "mistral",
    "mixtral": "mixtral",
    "qwen2": "qwen2",
    "qwen_v2": "qwen2",
    "qwen_v2_moe": "qwen2_moe",
    "qwen2_moe": "qwen2_moe",
    "phi": "phi",
    "phi3": "phi3",
    "falcon": "falcon",
    "opt": "opt",
    "bloom": "bloom",
    "gptneox": "gptneox",
}


def arch_config(arch: str, size: Optional[str] = None, **kw):
    """Architecture name -> TransformerConfig."""
    key = arch.lower()
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


def build_hf_engine(model, engine_config: Optional[
        RaggedInferenceEngineConfig] = None, dtype=None, device="cuda",
        **cfg_kw) -> InferenceEngineV2:
    """HF torch model (or name/path) -> ragged serving engine with the
    converted weights (`models.hf_loader.load_hf_model`; `cfg_kw`
    overrides config fields).  A name or path needs `transformers`;
    without it, pass any object with `.config` (the HF config's
    attributes, e.g. a `types.SimpleNamespace` from its config.json) and
    `.state_dict()`.  `device` as in `build_engine`."""
    from ...models.hf_loader import load_hf_model
    bundle, params = load_hf_model(model, dtype=dtype, **cfg_kw)
    return InferenceEngineV2(bundle, params=params, config=engine_config,
                             device=device)
