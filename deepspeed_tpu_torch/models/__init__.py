"""Model configs, parameters and the training model bundle of the port
(counterpart of `deepspeed_tpu/models/__init__.py`, restricted to the three
families the port serves and trains: gpt2, llama, qwen2)."""
from .transformer import (Transformer, TransformerConfig, gpt2_config,
                          init_params, llama_config, qwen2_config)
from .convert import opt_state_from_jax, params_from_jax, shard_params_tp

MODEL_FAMILIES = {
    "gpt2": gpt2_config,
    "llama": llama_config,
    "qwen2": qwen2_config,
}


def get_model_config(family: str, size: str = None, **kw) -> TransformerConfig:
    """Registry lookup: family name (+ preset size) -> TransformerConfig."""
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}; "
                         f"available: {sorted(MODEL_FAMILIES)}")
    fn = MODEL_FAMILIES[family]
    return fn(size, **kw) if size is not None else fn(**kw)


__all__ = ["Transformer", "TransformerConfig", "MODEL_FAMILIES",
           "get_model_config", "gpt2_config", "llama_config",
           "qwen2_config", "init_params", "params_from_jax",
           "opt_state_from_jax", "shard_params_tp"]
