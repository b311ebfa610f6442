"""Training runtime of the port: engine, optimizers, LR schedules and
activation checkpointing (counterpart of `deepspeed_tpu/runtime`)."""
