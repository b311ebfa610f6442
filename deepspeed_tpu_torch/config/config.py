"""Training configuration: the DeepSpeed JSON keys the port carries.

Counterpart of `deepspeed_tpu/config/config.py`, restricted to what the
training slice runs: the batch triple and its check, `optimizer`,
`scheduler`, `bf16`, `data_types.grad_accum_dtype`,
`zero_optimization.stage`, `gradient_clipping`, `steps_per_print`,
`activation_checkpointing.policy` and `seed`, on one device.  On one
device ZeRO stages 0-3 compute the same step, as in the JAX package, so
the stage is checked and kept but changes nothing.  Every other key, an
enabled `fp16` section and a world size above 1 are refused by name
(`NotImplementedError`) rather than ignored.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["ConfigError", "DeepSpeedTPUConfig", "OptimizerConfig",
           "SchedulerConfig", "PrecisionConfig", "ZeroConfig",
           "ActivationCheckpointingConfig"]


class ConfigError(ValueError):
    """Raised for invalid or inconsistent configuration."""


# top-level keys the port reads; everything else is refused by name
_KNOWN = {"train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "optimizer", "scheduler", "bf16",
          "fp16", "data_types", "zero_optimization", "gradient_clipping",
          "steps_per_print", "activation_checkpointing", "seed"}


def _get(d: Dict[str, Any], key: str, default: Any = None) -> Any:
    v = d.get(key, default)
    return default if v is None else v


def _refuse_extra(section: str, d: Dict[str, Any], allowed) -> None:
    extra = sorted(set(d) - set(allowed))
    if extra:
        raise NotImplementedError(
            f"{section} keys {extra} are not carried by the PyTorch port "
            f"yet (it reads {sorted(allowed)})")


@dataclass
class ZeroConfig:
    """ZeRO stage.  On one device every stage computes the same step."""

    stage: int = 0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        d = d or {}
        _refuse_extra("zero_optimization", d, {"stage"})
        cfg = cls(stage=int(_get(d, "stage", 0)))
        if cfg.stage not in (0, 1, 2, 3):
            raise ConfigError(
                f"zero_optimization.stage must be 0..3, got {cfg.stage}")
        return cfg


@dataclass
class PrecisionConfig:
    """bf16 or f32 compute.  fp16 (and its loss scaling) is refused."""

    bf16_enabled: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16_enabled else torch.float32

    @classmethod
    def from_dict(cls, root: Dict[str, Any]) -> "PrecisionConfig":
        bf16 = root.get("bf16", {}) or {}
        fp16 = root.get("fp16", {}) or {}
        _refuse_extra("bf16", bf16, {"enabled"})
        if _get(fp16, "enabled", False):
            raise NotImplementedError(
                "fp16 (with dynamic loss scaling) is not carried by the "
                "PyTorch port yet; use bf16")
        return cls(bf16_enabled=bool(_get(bf16, "enabled", False)))


@dataclass
class OptimizerConfig:
    """Optimizer selection, as the JAX package's block (type + params)."""

    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)

    @property
    def lr(self) -> float:
        return float(self.params.get("lr", 1e-3))

    @property
    def betas(self) -> Tuple[float, float]:
        b = self.params.get("betas", (0.9, 0.999))
        return (float(b[0]), float(b[1]))

    @property
    def eps(self) -> float:
        return float(self.params.get("eps", 1e-8))

    @property
    def weight_decay(self) -> float:
        return float(self.params.get("weight_decay", 0.0))

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]
                  ) -> Optional["OptimizerConfig"]:
        if not d:
            return None
        return cls(type=str(_get(d, "type", "adamw")).lower(),
                   params=_get(d, "params", {}))


@dataclass
class SchedulerConfig:
    """LR schedule selection (runtime/lr_schedules.py)."""

    type: str = "WarmupLR"
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]
                  ) -> Optional["SchedulerConfig"]:
        if not d:
            return None
        return cls(type=_get(d, "type", "WarmupLR"),
                   params=_get(d, "params", {}))


@dataclass
class ActivationCheckpointingConfig:
    """The remat policy's name (runtime/activation_checkpointing)."""

    policy: str = "none"

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]
                  ) -> "ActivationCheckpointingConfig":
        d = d or {}
        _refuse_extra("activation_checkpointing", d, {"policy"})
        return cls(policy=_get(d, "policy", "none"))


@dataclass
class DeepSpeedTPUConfig:
    """Top-level config from a dict, a JSON string or a JSON file, with
    the reference's batch arithmetic: train_batch_size = micro * gas *
    dp, any two of the three determining the third (dp is the world size,
    1 here)."""

    train_batch_size: int = 0
    train_micro_batch_size_per_gpu: int = 0
    gradient_accumulation_steps: int = 0
    data_parallel_size: int = 1
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    seed: int = 1234
    grad_accum_dtype: Optional[str] = None
    zero: ZeroConfig = field(default_factory=ZeroConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)

    @classmethod
    def from_json(cls, config, world_size: int = 1) -> "DeepSpeedTPUConfig":
        if isinstance(config, cls):
            return config
        if isinstance(config, str):
            if os.path.exists(config):
                with open(config) as f:
                    config = json.load(f)
            else:
                try:
                    config = json.loads(config)
                except json.JSONDecodeError as e:
                    raise ConfigError(
                        f"config is neither an existing file nor valid "
                        f"JSON: {config!r}") from e
        if not isinstance(config, dict):
            raise ConfigError(
                f"config must be dict or path, got {type(config)}")
        if world_size != 1:
            raise NotImplementedError(
                f"world_size={world_size}: data parallel training is not "
                f"carried by the PyTorch port yet (one device only)")
        d = dict(config)
        extra = sorted(set(d) - _KNOWN)
        if extra:
            raise NotImplementedError(
                f"config sections {extra} are not carried by the PyTorch "
                f"port yet")
        data_types = d.get("data_types") or {}
        _refuse_extra("data_types", data_types, {"grad_accum_dtype"})
        cfg = cls(
            train_batch_size=int(_get(d, "train_batch_size", 0)),
            train_micro_batch_size_per_gpu=int(
                _get(d, "train_micro_batch_size_per_gpu", 0)),
            gradient_accumulation_steps=int(
                _get(d, "gradient_accumulation_steps", 0)),
            steps_per_print=int(_get(d, "steps_per_print", 10)),
            gradient_clipping=float(_get(d, "gradient_clipping", 0.0)),
            seed=int(_get(d, "seed", 1234)),
            grad_accum_dtype=data_types.get("grad_accum_dtype"),
            zero=ZeroConfig.from_dict(d.get("zero_optimization")),
            precision=PrecisionConfig.from_dict(d),
            optimizer=OptimizerConfig.from_dict(d.get("optimizer")),
            scheduler=SchedulerConfig.from_dict(d.get("scheduler")),
            activation_checkpointing=ActivationCheckpointingConfig.from_dict(
                d.get("activation_checkpointing")),
        )
        cfg._resolve_batch_sizes(world_size)
        return cfg

    def _resolve_batch_sizes(self, world_size: int) -> None:
        """train_batch_size = micro * gas * dp (reference:
        runtime/config.py _configure_train_batch_size)."""
        dp = world_size
        tb, mb, gas = (self.train_batch_size,
                       self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb and mb and gas:
            if tb != mb * gas * dp:
                raise ConfigError(
                    f"train_batch_size {tb} != micro_batch {mb} * gas {gas} "
                    f"* dp {dp}")
        elif tb and mb:
            if tb % (mb * dp):
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by "
                    f"micro_batch*dp {mb * dp}")
            gas = tb // (mb * dp)
        elif tb and gas:
            if tb % (gas * dp):
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by gas*dp "
                    f"{gas * dp}")
            mb = tb // (gas * dp)
        elif mb and gas:
            tb = mb * gas * dp
        elif mb:
            gas = 1
            tb = mb * dp
        elif tb:
            gas = 1
            if tb % dp:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by dp {dp}")
            mb = tb // dp
        else:
            mb, gas, tb = 1, 1, dp
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas
        self.data_parallel_size = dp
