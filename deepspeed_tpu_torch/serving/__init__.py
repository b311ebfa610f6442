"""Serving layer of the port (counterpart of `deepspeed_tpu/serving`):
so far the multi-tenant adapter pool (`serving.tenancy`)."""
