"""Serving layer of the port (counterpart of `deepspeed_tpu/serving`):
so far the multi-tenant adapter pool (`serving.tenancy`), the
prompt-lookup draft source of speculative decoding
(`serving.speculative`) and the expert pool of paged MoE serving
(`serving.experts`)."""
from .experts import ExpertError, ExpertPool, ExpertUnavailable
from .speculative import DraftSource, PromptLookupDrafter, span_bucket

__all__ = ["DraftSource", "PromptLookupDrafter", "span_bucket",
           "ExpertError", "ExpertUnavailable", "ExpertPool"]
