"""Inference stack of the port (counterpart of `deepspeed_tpu/inference`)."""
