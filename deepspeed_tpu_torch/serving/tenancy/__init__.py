"""Multi-tenant serving of the port (counterpart of
`deepspeed_tpu/serving/tenancy`): the paged multi-LoRA `AdapterPool`.  The
per-tenant QoS scheduler (`qos.py` in the reference) needs the serve loop,
which is not ported yet."""
from .adapter_pool import AdapterError, AdapterPool, AdapterUnavailable

__all__ = ["AdapterError", "AdapterPool", "AdapterUnavailable"]
