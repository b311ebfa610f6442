"""Ragged (FastGen-style) serving engine of the port (counterpart of
`deepspeed_tpu/inference/v2`)."""
from .blocked_allocator import BlockedAllocator
from .ragged_manager import DSStateManager, SequenceDescriptor
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .model_registry import (ARCH_REGISTRY, arch_config, build_engine,
                             build_hf_engine)

__all__ = ["BlockedAllocator", "DSStateManager", "SequenceDescriptor",
           "InferenceEngineV2", "RaggedInferenceEngineConfig",
           "ARCH_REGISTRY", "arch_config", "build_engine",
           "build_hf_engine"]
