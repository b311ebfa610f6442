"""Tree helpers over nested dicts of tensors.

Counterpart of `deepspeed_tpu/utils/tree.py` for the few helpers the
training engine uses.  A "tree" here is what the port keeps parameters,
gradients and optimizer state in: dicts (possibly nested, like
`params["layers"]`) whose leaves are tensors, walked in insertion order.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

__all__ = ["tree_leaves", "tree_map", "tree_zeros_like", "global_norm",
           "count_params"]

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over corresponding leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_zeros_like(tree: Tree, dtype=None) -> Tree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def global_norm(tree: Tree) -> torch.Tensor:
    """Global L2 norm over every leaf: each leaf's sum of squares in f32,
    summed in leaf order (reference: runtime/utils.py
    get_global_norm_of_tensors).  A 0-d f32 tensor on the leaves'
    device."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    total = sum(x.float().square().sum() for x in leaves)
    return total.sqrt()


def count_params(tree: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))
