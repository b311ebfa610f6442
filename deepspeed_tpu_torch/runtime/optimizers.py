"""Optimizers as functional updates over trees of tensors.

Counterpart of `deepspeed_tpu/runtime/optimizers.py` for the optimizers
the training slice runs: Adam/AdamW (`state_dtype` fp32, bf16 or the
single-pass 8-bit codec "int8f") and SGD (with momentum).  Each is an
(init, update) pair: `update` takes the gradients, the state and the f32
master parameters and returns new master parameters and new state; the
engine casts the masters back to the compute dtype.  State leaves mirror
the parameter tree.

The JAX update is one XLA-fused pass; here it is plain PyTorch per leaf,
about 35 elementwise kernels for an int8f leaf, with f32 temporaries of
the leaf's size (1.6 GB apiece for GPT-2-1.3B's stacked `w_up`).  A fused
kernel is a later candidate.  `torch.round` rounds half to even like
`jnp.round`, and every operation keeps the JAX order, so the int8f codes
match the JAX package's bit for bit on the same inputs.

Refused by name (`NotImplementedError`): `state_dtype` "int8" and
`fused_update` (they need the fused 8-bit Adam kernel), and the other
optimizer types of the JAX package (lamb, lion, adagrad, the 1-bit
variants).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config.config import OptimizerConfig
from ..utils.tree import tree_map

__all__ = ["Optimizer", "build_optimizer", "get_optimizer_names"]


@dataclass(frozen=True)
class Optimizer:
    """Functional optimizer: state leaves mirror params."""

    name: str
    init: Callable
    # update(grads, state, master, lr, step, [grad_scale]) ->
    #     (new_master, new_state)
    update: Callable
    # update() takes grad_scale= (a scalar folded into each gradient leaf),
    # so the engine skips its separate unscale and clip passes
    supports_grad_scale: bool = False


def _split(out, n: int):
    """A tree of n-tuples -> n trees."""
    return [tree_map(lambda t, i=i: t[i], out) for i in range(n)]


def _map_tuples(fn, *trees):
    """fn over corresponding leaves, each call returning a tuple."""
    if isinstance(trees[0], dict):
        return {k: _map_tuples(fn, *(t[k] for t in trees))
                for k in trees[0]}
    return fn(*trees)


def _state_dtype(cfg: OptimizerConfig):
    """Storage dtype of the moments (params["state_dtype"])."""
    sd = cfg.params.get("state_dtype")
    if sd is None:
        return torch.float32
    table = {"float32": torch.float32, "fp32": torch.float32,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "int8f": "int8f", "int8_fused": "int8f"}
    key = str(sd).lower()
    if key in ("int8", "quantized8", "8bit"):
        raise NotImplementedError(
            f"optimizer state_dtype {sd!r} (exact-amax 8-bit moments) is "
            f"not carried by the PyTorch port yet: it waits for the fused "
            f"8-bit Adam kernel; use 'int8f'")
    if key not in table:
        raise ValueError(
            f"optimizer state_dtype {sd!r} not supported (fp32 | bf16 | "
            f"int8f); moments must keep fp32's exponent range — fp16 v "
            f"underflows")
    return table[key]


# ----------------------------------------------------------------------
# int8f codec (see the comment block above `_q8_sq_signed` in the JAX
# module): predicted per-row scale bounds, sqrt-domain codes
# ----------------------------------------------------------------------
def _scale_shape(p):
    # 0-dim leaves keep a 0-dim scale
    return (tuple(p.shape[:-1]) + (1,)) if p.dim() >= 1 else ()


def _safe(bound):
    return torch.where(bound > 0, bound, 1.0)


def _q8_sq_signed(x, bound):
    r = x.abs() / _safe(bound)
    q = torch.round(127.0 * torch.sqrt(torch.clamp_max(r, 1.0)))
    return (torch.sign(x) * q).to(torch.int8)


def _dq8_sq_signed(q, bound):
    qf = q.float()
    return qf * qf.abs() * (bound * (1.0 / 127.0 ** 2))


def _q8_sq(x, bound):
    r = x / _safe(bound)
    q = torch.where(
        x > 0,
        torch.clamp(torch.round(255.0 * torch.sqrt(torch.clamp_max(r, 1.0))),
                    1.0, 255.0),
        0.0)
    return q.to(torch.uint8)


def _dq8_sq(q, bound):
    qf = q.float()
    return qf * qf * (bound * (1.0 / 255.0 ** 2))


def _row_absmax(g):
    return g.abs().amax(dim=-1, keepdim=True) if g.dim() >= 1 else g.abs()


# ----------------------------------------------------------------------
# Adam / AdamW
# ----------------------------------------------------------------------
def _corrections(bias_correction: bool, b1: float, b2: float, step):
    if bias_correction:
        return 1.0 - b1 ** step, 1.0 - b2 ** step
    return 1.0, 1.0


def _make_adam(cfg: OptimizerConfig, adam_w_mode: bool) -> Optimizer:
    if cfg.params.get("fused_update"):
        raise NotImplementedError(
            "optimizer fused_update is not carried by the PyTorch port yet "
            "(it needs the fused 8-bit Adam kernel)")
    b1, b2 = cfg.betas
    eps = cfg.eps
    wd = cfg.weight_decay
    bias_correction = bool(cfg.params.get("bias_correction", True))
    sd = _state_dtype(cfg)
    if sd == "int8f":
        return _make_adam_int8f(cfg, adam_w_mode)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=sd),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=sd),
                              params)}

    def update(grads, state, master, lr, step, grad_scale=None):
        # step is 1-based at the time of this update
        c1, c2 = _corrections(bias_correction, b1, b2, step)

        def leaf(g, m, v, p):
            g = g.float()
            if grad_scale is not None:
                g = g * grad_scale
            if not adam_w_mode and wd:
                g = g + wd * p
            m_new = b1 * m.float() + (1.0 - b1) * g
            v_new = b2 * v.float() + (1.0 - b2) * (g * g)
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if adam_w_mode and wd:
                upd = upd + wd * p
            return p - lr * upd, m_new.to(sd), v_new.to(sd)

        out = _map_tuples(leaf, grads, state["m"], state["v"], master)
        new_master, new_m, new_v = _split(out, 3)
        return new_master, {"m": new_m, "v": new_v}

    return Optimizer("adamw" if adam_w_mode else "adam", init, update,
                     supports_grad_scale=True)


def _make_adam_int8f(cfg: OptimizerConfig, adam_w_mode: bool) -> Optimizer:
    """Adam/AdamW with the single-pass 8-bit codec: m/v hold int8/uint8
    codes in the param shapes, m_scale/v_scale the per-row f32 bounds
    (`_scale_shape`), starting at zero."""
    b1, b2 = cfg.betas
    eps = cfg.eps
    wd = cfg.weight_decay
    bias_correction = bool(cfg.params.get("bias_correction", True))

    def init(params):
        def scale(p):
            return torch.zeros(_scale_shape(p), dtype=torch.float32,
                               device=p.device)
        return {
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.int8),
                          params),
            "m_scale": tree_map(scale, params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.uint8),
                          params),
            "v_scale": tree_map(scale, params),
        }

    def update(grads, state, master, lr, step, grad_scale=None):
        c1, c2 = _corrections(bias_correction, b1, b2, step)

        def leaf(g, m_q, m_s, v_q, v_s, p):
            g = g.float()
            if grad_scale is not None:
                g = g * grad_scale
            if not adam_w_mode and wd:
                g = g + wd * p
            gmax = _row_absmax(g)
            mb = b1 * m_s + (1.0 - b1) * gmax
            vb = b2 * v_s + (1.0 - b2) * gmax * gmax
            m_new = b1 * _dq8_sq_signed(m_q, m_s) + (1.0 - b1) * g
            v_new = b2 * _dq8_sq(v_q, v_s) + (1.0 - b2) * (g * g)
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if adam_w_mode and wd:
                upd = upd + wd * p
            return (p - lr * upd, _q8_sq_signed(m_new, mb), mb,
                    _q8_sq(v_new, vb), vb)

        out = _map_tuples(leaf, grads, state["m"], state["m_scale"],
                          state["v"], state["v_scale"], master)
        new_master, m, ms, v, vs = _split(out, 5)
        return new_master, {"m": m, "m_scale": ms, "v": v, "v_scale": vs}

    return Optimizer("adamw" if adam_w_mode else "adam", init, update,
                     supports_grad_scale=True)


# ----------------------------------------------------------------------
# SGD (+momentum)
# ----------------------------------------------------------------------
def _make_sgd(cfg: OptimizerConfig) -> Optimizer:
    momentum = float(cfg.params.get("momentum", 0.0))
    wd = cfg.weight_decay
    nesterov = bool(cfg.params.get("nesterov", False))

    def init(params):
        if momentum:
            return {"m": tree_map(torch.zeros_like, params)}
        return {}

    def update(grads, state, master, lr, step):
        def leaf_mom(g, m, p):
            g = g.float()
            if wd:
                g = g + wd * p
            m_new = momentum * m + g
            upd = g + momentum * m_new if nesterov else m_new
            return p - lr * upd, m_new

        def leaf_plain(g, p):
            g = g.float()
            if wd:
                g = g + wd * p
            return p - lr * g

        if momentum:
            out = _map_tuples(leaf_mom, grads, state["m"], master)
            new_master, new_m = _split(out, 2)
            return new_master, {"m": new_m}
        return tree_map(leaf_plain, grads, master), {}

    return Optimizer("sgd", init, update)


_BUILDERS = {
    "adam": lambda c: _make_adam(
        c, adam_w_mode=bool(c.params.get("adam_w_mode", False))),
    "adamw": lambda c: _make_adam(c, adam_w_mode=True),
    "fusedadam": lambda c: _make_adam(
        c, adam_w_mode=bool(c.params.get("adam_w_mode", True))),
    "sgd": _make_sgd,
}
# the JAX package's other optimizers, refused by name until ported
_NOT_PORTED = ("lamb", "fusedlamb", "lion", "fusedlion", "adagrad",
               "onebitadam", "zerooneadam", "onebitlamb")


def get_optimizer_names():
    return sorted(_BUILDERS)


def build_optimizer(cfg: Optional[OptimizerConfig]) -> Optimizer:
    """Build from the config block (`optimizer.type` + `params`)."""
    cfg = cfg or OptimizerConfig(type="adamw", params={"lr": 1e-3})
    key = cfg.type.replace("_", "").lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {cfg.type!r} is not carried by the PyTorch port "
            f"yet; supported: {get_optimizer_names()}")
    if key not in _BUILDERS:
        raise ValueError(f"unknown optimizer {cfg.type!r}; supported: "
                         f"{get_optimizer_names()}")
    return _BUILDERS[key](cfg)
