"""Helpers of the port (counterpart of `deepspeed_tpu/utils`)."""
