"""Sequence-tiled compute of the port (counterpart of
`deepspeed_tpu/sequence`)."""
