"""Training engine: `initialize` and `TrainEngine.train_batch`.

Counterpart of `deepspeed_tpu/runtime/engine.py` (`TrainEngine`,
`initialize`) on one device.  The JAX engine traces the whole step —
gradient accumulation, unscale, clip, optimizer update, cast back — into
one compiled program; here the same step runs eagerly, in the same order
and with the same numerics:

1. gradient accumulation over `gradient_accumulation_steps` micro-batches,
   each micro's gradients (in the parameters' dtype, as autograd makes
   them) added into an accumulator in `data_types.grad_accum_dtype`;
2. the global gradient norm (f32 sum of squares per leaf);
3. the unscale by 1/gas and the clip folded into the optimizer's update
   as one `grad_scale` scalar when the optimizer supports it, else
   applied to the gradient tree;
4. the update on the f32 master parameters (bf16 compute) or on the
   parameters themselves (f32 compute), then the cast back.  With int8
   moments and `fused_update` (`optimizer.update_fused`), bf16 compute and
   the card, the update is the fused 8-bit Adam kernel, one launch per
   leaf, which writes the master, the bf16 parameters, the codes and the
   scales in place in the same pass (the JAX step's `use_fused` rule with
   "tpu" read as the card); otherwise the plain `update`, as the JAX
   engine runs on its CPU.

What differs by nature of PyTorch, and what the port does about it:

- The parameters live in one stacked tensor per layer weight (`layers.wq`
  is [L, H, NH*D], as in the JAX package and its checkpoints).  Autograd
  through `wq[i]` would scatter each layer's gradient into a zeroed
  full-size tensor and add those L times; instead the loss sees per-layer
  leaf views of the stacked storage whose `.grad` are views of one stacked
  gradient buffer, so autograd accumulates each layer's gradient in place.
- The parameters, the per-layer views and the gradient buffer keep their
  storage for the engine's life: the update writes the new values into
  it in place (the JAX step donates and re-emits the state instead).

Scope: one device, bf16 or f32 compute, ZeRO stages 0-3 (the same step on
one device), the optimizers of `runtime/optimizers.py`, the remat policies
of `runtime/activation_checkpointing`.  The device is "cuda" unless the
caller asks for the CPU; without a card that default raises.
`initialize(..., plain_kernels=True)` selects the kernels' plain versions
on the card, for comparisons (never by default): it sets the model
config's `attn_impl` to "jnp", as the serving engine's option does, and
runs the optimizer's plain `update` even where `update_fused` exists, so
the plain engine is plain throughout.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..config.config import ConfigError, DeepSpeedTPUConfig
from ..utils import tree as tu
from . import lr_schedules, optimizers
from .activation_checkpointing import remat_policy

__all__ = ["TrainEngine", "initialize", "OPTIMIZER_RANGE"]

logger = logging.getLogger(__name__)

# torch.profiler range around the optimizer update and the cast back
OPTIMIZER_RANGE = "dstt::optimizer_update"

_GRAD_ACCUM = {None: None, "fp32": torch.float32, "float32": torch.float32,
               "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available: the port "
            f"trains on the card by default; pass device='cpu' to run the "
            f"plain PyTorch versions of the kernels on the CPU")
    return dev


def _to_tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, copy=True)
    a = np.asarray(x)
    # bf16 has no numpy dtype of its own here: go through float32
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(
        device=device, dtype=dtype)


class TrainEngine:
    """See the module docstring.  `loss_fn(params, batch, rng) -> loss |
    (loss, aux)` takes the parameter tree with the layer stack as a list
    of per-layer dicts."""

    def __init__(self, loss_fn: Callable, params, config: DeepSpeedTPUConfig,
                 device="cuda", plain_kernels: bool = False):
        self.device = _resolve_device(device)
        self.plain_kernels = bool(plain_kernels)
        self.config = config
        self.loss_fn = loss_fn
        self.optimizer = optimizers.build_optimizer(config.optimizer)
        base_lr = config.optimizer.lr if config.optimizer else 1e-3
        self.lr_fn = lr_schedules.build_scheduler(config.scheduler, base_lr)
        self.compute_dtype = config.precision.dtype
        if config.grad_accum_dtype not in _GRAD_ACCUM:
            raise ConfigError(
                f"data_types.grad_accum_dtype {config.grad_accum_dtype!r} "
                f"not supported (fp32 | bf16)")
        self.grad_accum_dtype = (_GRAD_ACCUM[config.grad_accum_dtype]
                                 or torch.float32)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        if callable(params):
            params = params(self.generator)
        dt = self.compute_dtype
        self.params = tu.tree_map(lambda x: _to_tensor(x, self.device, dt),
                                  params)
        self.master = (None if dt == torch.float32 else
                       tu.tree_map(lambda p: p.float(), self.params))
        self.opt_state = self.optimizer.init(self._target())
        self.global_steps = 0
        self._grads = tu.tree_zeros_like(self.params)
        self._leaves = self._make_leaves()
        self._tput_t0 = None
        logger.info(
            "engine up: zero_stage=%d dtype=%s device=%s micro_bs=%d gas=%d "
            "global_bs=%d params=%d", config.zero.stage, dt, self.device,
            config.train_micro_batch_size_per_gpu,
            config.gradient_accumulation_steps, config.train_batch_size,
            tu.count_params(self.params))

    # ------------------------------------------------------------------
    @property
    def grads(self):
        """The gradient buffer, in the parameters' layout: the last
        micro-batch's gradients (the step's, before unscale and clip, when
        gas is 1) until the next micro-batch zeroes it."""
        return self._grads

    @property
    def fused_update(self) -> bool:
        """Whether a step runs the optimizer's `update_fused`: int8
        moments with `fused_update`, an f32 master (bf16 compute), the
        card, and not `plain_kernels`."""
        return (self.optimizer.update_fused is not None
                and self.master is not None
                and self.device.type == "cuda" and not self.plain_kernels)

    def _target(self):
        """The tree the optimizer updates: the f32 masters, or the
        parameters themselves under f32 compute."""
        return self.master if self.master is not None else self.params

    def _make_leaves(self):
        """Autograd leaves sharing the parameters' storage, each with its
        `.grad` preset to the matching view of the gradient buffer; the
        layer stack as a list of per-layer dicts (module docstring)."""
        def leaf(p, g):
            t = p.detach().requires_grad_()
            t.grad = g
            return t

        out = {}
        for k, v in self.params.items():
            if k == "layers":
                L = next(iter(v.values())).shape[0]
                out[k] = [{kk: leaf(w[i], self._grads[k][kk][i])
                           for kk, w in v.items()} for i in range(L)]
            else:
                out[k] = leaf(v, self._grads[k])
        return out

    def _split_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A global batch [train_batch_size, ...] -> [gas, micro, ...] on
        the device (the JAX `_shard_batch`'s check, without the mesh)."""
        gas = self.config.gradient_accumulation_steps
        expected = self.config.train_batch_size
        out = {}
        for k, x in batch.items():
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(np.asarray(x)))
            if t.shape[0] != expected:
                raise ValueError(
                    f"batch leading dim {t.shape[0]} != train_batch_size "
                    f"{expected} (= micro "
                    f"{self.config.train_micro_batch_size_per_gpu} * gas "
                    f"{gas} * dp {self.config.data_parallel_size})")
            out[k] = t.reshape((gas, expected // gas) + tuple(t.shape[1:])
                               ).to(self.device)
        return out

    def _micro(self, micro):
        """Forward + backward of one micro-batch into the gradient buffer;
        returns (loss, aux) detached."""
        for g in tu.tree_leaves(self._grads):
            g.zero_()
        out = self.loss_fn(self._leaves, micro, None)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def train_batch(self, batch) -> Dict[str, Any]:
        """One optimizer step over a full [train_batch_size, ...] batch.
        Returns the step's metrics: loss, grad_norm, lr (a float),
        micro_losses [gas] and the loss function's aux (ppl_log)."""
        if self._tput_t0 is None:
            self._tput_t0 = time.time()
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
        gad = self.grad_accum_dtype
        micro_batches = self._split_batch(batch)

        losses, aux_sum, acc = [], {}, None
        for i in range(gas):
            loss, aux = self._micro({k: v[i] for k, v in
                                     micro_batches.items()})
            losses.append(loss.float())
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.float()
            with torch.no_grad():
                if gas == 1:
                    acc = tu.tree_map(lambda g: g.to(gad), self._grads)
                elif acc is None:
                    acc = tu.tree_map(lambda g: g.to(gad, copy=True),
                                      self._grads)
                else:
                    acc = tu.tree_map(lambda a, g: a + g.to(gad), acc,
                                      self._grads)
        micro_losses = torch.stack(losses)
        with torch.no_grad():
            metrics = self._apply(acc, micro_losses, gas)
        metrics.update({k: v / gas for k, v in aux_sum.items()})
        self._finish_step(metrics)
        return metrics

    def _apply(self, grads, micro_losses, gas: int) -> Dict[str, Any]:
        """Unscale, norm, clip, update, cast back (the JAX step's tail)."""
        opt = self.optimizer
        clip = self.config.gradient_clipping
        inv = 1.0 / gas
        fold = opt.supports_grad_scale
        if fold:
            gnorm = tu.global_norm(grads) * inv
            gscale = torch.full((), inv, dtype=torch.float32,
                                device=self.device)
            if clip and clip > 0:
                gscale = inv * torch.clamp_max(clip / (gnorm + 1e-6), 1.0)
        else:
            grads = tu.tree_map(lambda g: g * inv, grads)
            gnorm = tu.global_norm(grads)
            if clip and clip > 0:
                scale = torch.clamp_max(clip / (gnorm + 1e-6), 1.0)
                grads = tu.tree_map(lambda g: g * scale, grads)
        lr = float(self.lr_fn(self.global_steps))
        step_num = float(self.global_steps + 1)
        kw = {"grad_scale": gscale} if fold else {}
        # a named range, so a profile can attribute the update's kernels
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            if self.fused_update:
                # master, parameters, codes and scales written in place
                opt.update_fused(grads, self.opt_state, self.master, lr,
                                 step_num, self.params, **kw)
            else:
                new_target, self.opt_state = opt.update(
                    grads, self.opt_state, self._target(), lr, step_num,
                    **kw)
                if self.master is not None:
                    self.master = new_target
                tu.tree_map(lambda p, n: p.copy_(n), self.params, new_target)
        return {"loss": micro_losses.mean(), "grad_norm": gnorm, "lr": lr,
                "micro_losses": micro_losses}

    def _finish_step(self, metrics: Dict[str, Any]) -> None:
        self.global_steps += 1
        spp = self.config.steps_per_print
        if spp and self.global_steps % spp == 0:
            elapsed = time.time() - self._tput_t0
            sps = (self.global_steps * self.config.train_batch_size
                   / max(elapsed, 1e-9))
            logger.info("step=%d loss=%.4f lr=%.3e gnorm=%.3f "
                        "samples/sec=%.1f", self.global_steps,
                        float(metrics["loss"]), metrics["lr"],
                        float(metrics["grad_norm"]), sps)

    # ------------------------------------------------------------------
    def set_state(self, step: int, master=None, opt_state=None) -> None:
        """Start from a given state (e.g. another engine's): `master` is
        the f32 master tree (the parameters under f32 compute), copied
        into place and cast to the parameters; `opt_state` replaces the
        optimizer state (same structure as `optimizer.init`'s)."""
        with torch.no_grad():
            if master is not None:
                tu.tree_map(lambda t, n: t.copy_(n), self._target(), master)
                if self.master is not None:
                    tu.tree_map(lambda p, n: p.copy_(n), self.params,
                                self.master)
        if opt_state is not None:
            self.opt_state = tu.tree_map(
                lambda old, new: new.to(device=old.device, dtype=old.dtype),
                self.opt_state, opt_state)
        self.global_steps = int(step)


def initialize(loss_fn: Callable = None, params=None, config=None,
               model=None, device="cuda", plain_kernels: bool = False
               ) -> TrainEngine:
    """Entry point mirroring `deepspeed_tpu.initialize` on one device.

    `model` is a `models.Transformer` (its init and loss, with the
    config's remat policy); otherwise pass `loss_fn` and `params`.
    `params` may be a tree of tensors or numpy arrays, or a function of a
    `torch.Generator` (the model's `init_params` by default, seeded from
    the config's `seed`).  `plain_kernels=True` runs the plain versions
    throughout: the model's attention and the optimizer's `update` (never
    `update_fused`).  Returns the engine."""
    cfg = DeepSpeedTPUConfig.from_json(config or {}, world_size=1)
    policy = cfg.activation_checkpointing.policy
    remat_policy(policy)   # refuse an unported policy before any work
    if model is not None:
        mcfg = model.cfg
        if plain_kernels:
            mcfg = dataclasses.replace(mcfg, attn_impl="jnp")
        model = type(model)(mcfg)
        if loss_fn is None:
            def loss_fn(p, b, rng=None, _f=model.loss_fn):
                return _f(p, b, rng, remat_policy=policy)
        if params is None:
            params = model.init_params
    elif plain_kernels:
        raise ValueError("plain_kernels=True needs model= (the engine "
                         "selects the plain versions through the model's "
                         "config)")
    if loss_fn is None or params is None:
        raise ValueError("initialize() needs loss_fn+params or model=")
    return TrainEngine(loss_fn, params, cfg, device=device,
                       plain_kernels=plain_kernels)
