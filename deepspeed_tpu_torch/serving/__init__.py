"""Serving layer of the port (counterpart of `deepspeed_tpu/serving`):
so far the multi-tenant adapter pool (`serving.tenancy`) and the
prompt-lookup draft source of speculative decoding
(`serving.speculative`)."""
from .speculative import DraftSource, PromptLookupDrafter, span_bucket

__all__ = ["DraftSource", "PromptLookupDrafter", "span_bucket"]
