"""Model configs, parameters and the training model bundle of the port
(counterpart of `deepspeed_tpu/models/__init__.py`: the families the
port serves, gpt2, llama, qwen2, mistral, mixtral, qwen2_moe, phi, phi3,
falcon, opt, bloom and gptneox; it trains the pre-norm sequential dense
ones, `training_refusal` names the rest), and the HF checkpoint
loader."""
from .transformer import (Transformer, TransformerConfig, bloom_config,
                          falcon_config, gpt2_config, gptneox_config,
                          init_params, llama_config, mistral_config,
                          mixtral_config, opt_config, phi3_config,
                          phi_config, qwen2_config, qwen2_moe_config)
from .convert import opt_state_from_jax, params_from_jax, shard_params_tp
from .hf_loader import convert_state_dict, hf_to_config, load_hf_model

MODEL_FAMILIES = {
    "gpt2": gpt2_config,
    "llama": llama_config,
    "mistral": mistral_config,
    "mixtral": mixtral_config,
    "qwen2": qwen2_config,
    "qwen2_moe": qwen2_moe_config,
    "phi": phi_config,
    "phi3": phi3_config,
    "falcon": falcon_config,
    "opt": opt_config,
    "bloom": bloom_config,
    "gptneox": gptneox_config,
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
           "mistral_config", "mixtral_config", "qwen2_config",
           "qwen2_moe_config", "phi_config", "phi3_config",
           "falcon_config", "opt_config", "bloom_config", "gptneox_config",
           "init_params", "params_from_jax",
           "opt_state_from_jax", "shard_params_tp", "load_hf_model",
           "hf_to_config", "convert_state_dict"]
