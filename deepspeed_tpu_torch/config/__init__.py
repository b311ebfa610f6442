"""Training configuration of the port (counterpart of
`deepspeed_tpu/config`)."""
from .config import (ActivationCheckpointingConfig, ConfigError,
                     DeepSpeedTPUConfig, OptimizerConfig, PrecisionConfig,
                     SchedulerConfig, ZeroConfig)

__all__ = ["ActivationCheckpointingConfig", "ConfigError",
           "DeepSpeedTPUConfig", "OptimizerConfig", "PrecisionConfig",
           "SchedulerConfig", "ZeroConfig"]
