"""Per-layer activation checkpointing (remat) with named policies.

Counterpart of `deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py` (`remat_policy`, `checkpoint_wrapper`).  The JAX package
wraps each layer in `jax.checkpoint` with a policy that says which
residuals to keep; here each layer runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, and a policy is
a selective-checkpoint context (`create_selective_checkpoint_contexts`):

- "nothing_saveable" (also "none", the config default, as in the JAX
  package): full remat — only the layer input is kept and the whole layer
  reruns in backward, the flash forward kernel included;
- "save_attn": full remat except the flash attention op
  (`dstt::flash_attention`), whose out and lse are kept (MUST_SAVE), so the
  backward recomputes norms, projections and the MLP but never reruns the
  forward kernel: one flash forward launch per layer per step instead of
  two.  A plain `autograd.Function` would be rerun by the recompute; the
  custom op is what lets the policy name it.

The JAX package's other policy names (everything_saveable, dots_saveable,
the save_attn_proj* and offload variants, ...) are refused by name with
`NotImplementedError`.  Whether a model checkpoints at all is its
config's `remat` flag, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...ops.flash_attention import FLASH_OP

__all__ = ["POLICIES", "remat_policy", "checkpoint_wrapper"]

POLICIES = ("nothing_saveable", "save_attn")
# the JAX package's remat_policy table, not ported yet
_NOT_PORTED = ("everything_saveable", "dots_saveable", "checkpoint_dots",
               "dots_with_no_batch_dims", "save_named", "save_attn_proj",
               "save_attn_proj_up", "offload")


def _save_attn(ctx, op, *args, **kwargs):
    if op == FLASH_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: Optional[str] = None):
    """The selective-checkpoint `context_fn` of policy `name`, or None for
    full remat.  "none"/None is the config default and means full remat,
    as in the JAX package."""
    if name in (None, "none", "nothing_saveable"):
        return None
    if name == "save_attn":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_attn)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"remat policy {name!r} is not carried by the PyTorch port yet "
            f"(ported: {', '.join(POLICIES)})")
    raise ValueError(f"unknown remat policy {name!r}; one of "
                     f"{sorted(POLICIES + _NOT_PORTED)}")


def checkpoint_wrapper(function: Callable,
                       policy: Optional[str] = None) -> Callable:
    """A rematerialising version of `function` under policy `policy`."""
    context_fn = remat_policy(policy)

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        if context_fn is None:
            return checkpoint(function, *args, use_reentrant=False,
                              **kwargs)
        return checkpoint(function, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)

    return wrapped
