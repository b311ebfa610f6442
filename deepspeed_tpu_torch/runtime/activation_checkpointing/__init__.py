"""Activation checkpointing (counterpart of
`deepspeed_tpu/runtime/activation_checkpointing`)."""
from .checkpointing import POLICIES, checkpoint_wrapper, remat_policy

__all__ = ["POLICIES", "checkpoint_wrapper", "remat_policy"]
