"""LR schedules (reference: deepspeed/runtime/lr_schedules.py — LRRangeTest
:273, OneCycle :371, WarmupLR :633, WarmupDecayLR :726, WarmupCosineLR
:777).

Counterpart of `deepspeed_tpu/runtime/lr_schedules.py`, with the same
names, parameters and formulas.  The JAX schedules are traced functions
of a jnp step inside the compiled step; here a schedule is a plain
function of the Python int step (completed optimizer steps) returning a
Python float, evaluated on the host once per step.  `build_scheduler`
mirrors the reference's selection by `scheduler.type`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from ..config.config import SchedulerConfig

__all__ = ["build_scheduler", "get_scheduler_names"]

Schedule = Callable[[int], float]  # step -> lr


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def _warmup_factor(step, warmup_num_steps, warmup_type: str) -> float:
    warmup_num_steps = max(1, warmup_num_steps)
    if warmup_type == "log":
        # reference WarmupLR: lr scales with log(step)/log(warmup_steps)
        if step >= warmup_num_steps:
            return 1.0
        return math.log(max(step, 1.0)) / math.log(max(2, warmup_num_steps))
    return _clip01(step / warmup_num_steps)


def warmup_lr(params: Dict) -> Schedule:
    lo = float(params.get("warmup_min_lr", 0.0))
    hi = float(params.get("warmup_max_lr", 1e-3))
    steps = int(params.get("warmup_num_steps", 1000))
    wtype = params.get("warmup_type", "log")

    def f(step):
        return lo + (hi - lo) * _warmup_factor(step, steps, wtype)
    return f


def warmup_decay_lr(params: Dict) -> Schedule:
    lo = float(params.get("warmup_min_lr", 0.0))
    hi = float(params.get("warmup_max_lr", 1e-3))
    wsteps = int(params.get("warmup_num_steps", 1000))
    total = int(params.get("total_num_steps", 10000))
    wtype = params.get("warmup_type", "log")

    def f(step):
        if step < wsteps:
            return lo + (hi - lo) * _warmup_factor(step, wsteps, wtype)
        return hi * _clip01((total - step) / max(1, total - wsteps))
    return f


def warmup_cosine_lr(params: Dict) -> Schedule:
    wsteps = int(params.get("warmup_num_steps", 1000))
    total = int(params.get("total_num_steps", 10000))
    cos_min_ratio = float(params.get("cos_min_ratio", 0.0001))
    warmup_min_ratio = float(params.get("warmup_min_ratio", 0.0))
    lr = float(params.get("lr", 1e-3))

    def f(step):
        if step < wsteps:
            return lr * (warmup_min_ratio + (1 - warmup_min_ratio)
                         * _clip01(step / max(1, wsteps)))
        progress = _clip01((step - wsteps) / max(1, total - wsteps))
        return lr * (cos_min_ratio + (1 - cos_min_ratio) * 0.5
                     * (1 + math.cos(math.pi * progress)))
    return f


def one_cycle(params: Dict) -> Schedule:
    lo = float(params.get("cycle_min_lr", 1e-4))
    hi = float(params.get("cycle_max_lr", 1e-3))
    first = int(params.get("cycle_first_step_size", 2000))
    second = int(params.get("cycle_second_step_size", first))
    decay = float(params.get("decay_lr_rate", 0.0))

    def f(step):
        if step <= first:
            return lo + (hi - lo) * _clip01(step / max(1, first))
        if step <= first + second:
            return hi - (hi - lo) * _clip01((step - first) / max(1, second))
        return lo * max(0.0, 1.0 - decay * (step - first - second))
    return f


def lr_range_test(params: Dict) -> Schedule:
    lo = float(params.get("lr_range_test_min_lr", 1e-3))
    rate = float(params.get("lr_range_test_step_rate", 1.0))
    size = int(params.get("lr_range_test_step_size", 2000))
    staircase = bool(params.get("lr_range_test_staircase", False))

    def f(step):
        interval = math.floor(step / size) if staircase else step / size
        return lo * (1.0 + rate * interval)
    return f


def constant_lr(params: Dict) -> Schedule:
    lr = float(params.get("lr", 1e-3))
    return lambda step: lr


_SCHEDULES = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": constant_lr,
}


def get_scheduler_names():
    return sorted(_SCHEDULES)


def build_scheduler(cfg: Optional[SchedulerConfig],
                    base_lr: float) -> Schedule:
    if cfg is None:
        return lambda step: base_lr
    key = cfg.type.replace("_", "").lower()
    if key not in _SCHEDULES:
        raise ValueError(f"unknown scheduler {cfg.type!r}; supported: "
                         f"{get_scheduler_names()}")
    params = dict(cfg.params)
    params.setdefault("lr", base_lr)
    params.setdefault("warmup_max_lr", base_lr)
    return _SCHEDULES[key](params)
