"""Block-sparse attention: DeepSpeed Sparse Attention's layouts and module.

Counterpart of `deepspeed_tpu/ops/sparse_attention.py`, all of it: the
six `SparsityConfig` layouts (Dense, Fixed, Variable, BigBird,
BSLongformer, LocalSlidingWindow), the gather table `_layout_to_gather`,
`block_sparse_attention` and the user module `SparseSelfAttention`.

Layouts are static numpy [H, nb, nb] bool masks, built by the same loops
in the same order as the JAX package (Variable and BigBird draw from
Python's `random.Random(0)`), so the two packages give identical layouts.
Attention visits, per (head, q-block), only the layout's active key blocks
through a padded gather table `kb_idx [H, nqb, A]` (-1 padding).

On a CUDA tensor `block_sparse_attention` runs the block-sparse flash
kernels of `ops/sparse_flash.py` (forward, dq, dk/dv) under a
`torch.autograd.Function`; a shape the kernels do not take raises in the
wrapper.  On the CPU (or with `impl="jnp"`) it runs the forward kernel's
plain version, the JAX package's jnp branch: [B, H, nqb, A, block, D]
gathered copies, masked scores, P rounded to the input dtype before P.V,
a fully-masked row's output 0 (the kernels' -1e30 sentinel, where the JAX
branch maps its -inf softmax's NaN to 0), and PyTorch's autograd for the
gradient.

`SparseSelfAttention` caches, per sequence length, the layout and, per
device, the gather table and its reverse as int32 tensors: the JAX
backward rebuilds both in Python loops on every call (~275k iterations at
H 16, nb 256, A 67), which would keep the card waiting on the host.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import sparse_flash

__all__ = [
    "SparsityConfig",
    "DenseSparsityConfig",
    "FixedSparsityConfig",
    "VariableSparsityConfig",
    "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig",
    "LocalSlidingWindowSparsityConfig",
    "block_sparse_attention",
    "SparseSelfAttention",
]


# ----------------------------------------------------------------------
# sparsity configs -> block layouts
# ----------------------------------------------------------------------
class SparsityConfig:
    """Base: produces a [num_heads, nb, nb] bool block layout for a seq_len.

    `different_layout_per_head=False` collapses all heads to head-0's
    layout."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of block {self.block}")
        return seq_len // self.block

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _finalize(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        return np.ones((self.num_heads, nb, nb), bool)


class FixedSparsityConfig(SparsityConfig):
    """Local windows of `num_local_blocks`, plus `num_global_blocks` global
    block-columns taken from the tail of each window; heads may rotate among
    `num_different_global_patterns` choices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention mode {attention!r}")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "num_different_global_patterns > 1 requires "
                "different_layout_per_head=True")
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        L = np.zeros((self.num_heads, nb, nb), bool)
        w = self.num_local_blocks
        for h in range(self.num_heads):
            # local windows
            for start in range(0, nb, w):
                end = min(start + w, nb)
                for q in range(start, end):
                    hi = (q + 1) if self.attention == "unidirectional" else end
                    L[h, q, start:hi] = True
            # global columns: pattern-rotated tail blocks of each window
            pat = h % self.num_different_global_patterns
            first = w - (1 + pat) * self.num_global_blocks
            for start in range(0, nb, w):
                g0 = start + max(first, 0)
                for g in range(g0, min(g0 + self.num_global_blocks, nb)):
                    L[h, :, g] = True       # every query block attends to g
                    if self.horizontal_global_attention:
                        L[h, g, :] = True   # g attends everywhere
        if self.attention == "unidirectional":
            tri = np.tril(np.ones((nb, nb), bool))
            L &= tri[None]
        return self._finalize(L)


class VariableSparsityConfig(SparsityConfig):
    """Custom local window sizes + explicit global block indices + random
    blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[Sequence[int]] = None,
                 global_block_end_indices: Optional[Sequence[int]] = None,
                 attention="bidirectional", horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = list(global_block_indices or [0])
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices
            else None)
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _global_cols(self, nb: int) -> List[int]:
        cols: List[int] = []
        if self.global_block_end_indices is None:
            cols = [i for i in self.global_block_indices if i < nb]
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                cols.extend(range(s, min(e, nb)))
        return cols

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        L = np.zeros((self.num_heads, nb, nb), bool)
        rng = random.Random(0)
        for h in range(self.num_heads):
            # variable-width local windows, then the last width repeats
            q = 0
            widths = list(self.local_window_blocks)
            widths += [widths[-1]] * nb
            for w in widths:
                if q >= nb:
                    break
                end = min(q + w, nb)
                for i in range(q, end):
                    hi = (i + 1) if self.attention == "unidirectional" else end
                    L[h, i, q:hi] = True
                q = end
            for g in self._global_cols(nb):
                L[h, :, g] = True
                if self.horizontal_global_attention:
                    L[h, g, :] = True
            for i in range(nb):
                for _ in range(self.num_random_blocks):
                    L[h, i, rng.randrange(nb)] = True
        if self.attention == "unidirectional":
            L &= np.tril(np.ones((nb, nb), bool))[None]
        return self._finalize(L)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding-window + global (ITC) blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        L = np.zeros((self.num_heads, nb, nb), bool)
        rng = random.Random(0)
        half = self.num_sliding_window_blocks // 2
        g = min(self.num_global_blocks, nb)
        for h in range(self.num_heads):
            for i in range(nb):
                L[h, i, max(0, i - half):min(nb, i + half + 1)] = True
                for _ in range(self.num_random_blocks):
                    L[h, i, rng.randrange(nb)] = True
            L[h, :, :g] = True      # global columns (ITC)
            L[h, :g, :] = True      # global rows
        if self.attention == "unidirectional":
            L &= np.tril(np.ones((nb, nb), bool))[None]
        return self._finalize(L)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + leading global blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices: Optional[Sequence[int]] = None,
                 global_block_end_indices: Optional[Sequence[int]] = None,
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices or [0])
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices
            else None)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        L = np.zeros((self.num_heads, nb, nb), bool)
        half = self.num_sliding_window_blocks // 2
        if self.global_block_end_indices is None:
            cols = [i for i in self.global_block_indices if i < nb]
        else:
            cols = []
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                cols.extend(range(s, min(e, nb)))
        for h in range(self.num_heads):
            for i in range(nb):
                L[h, i, max(0, i - half):min(nb, i + half + 1)] = True
            for c in cols:
                L[h, :, c] = True
                L[h, c, :] = True
        if self.attention == "unidirectional":
            L &= np.tril(np.ones((nb, nb), bool))[None]
        return self._finalize(L)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding-window layout."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        L = np.zeros((self.num_heads, nb, nb), bool)
        w = self.num_sliding_window_blocks
        for i in range(nb):
            if self.attention == "unidirectional":
                L[:, i, max(0, i - w + 1):i + 1] = True
            else:
                half = w // 2
                L[:, i, max(0, i - half):min(nb, i + half + 1)] = True
        return self._finalize(L)


# ----------------------------------------------------------------------
# gather tables
# ----------------------------------------------------------------------
def _layout_to_gather(layout: np.ndarray) -> np.ndarray:
    """[H, nqb, nkb] bool -> kb_idx [H, nqb, A] int32: each row's active
    key blocks in ascending order, padded with -1 (A = the most active
    blocks of any row)."""
    layout = np.asarray(layout, bool)
    counts = layout.sum(-1)
    max_a = int(counts.max())
    if max_a == 0:
        raise ValueError("sparsity layout has an all-zero row")
    H, nqb, _ = layout.shape
    h, q, col = np.nonzero(layout)          # row-major: ascending col per row
    row = h * nqb + q
    starts = np.concatenate([[0], np.cumsum(counts.ravel())[:-1]])
    pos = np.arange(row.size) - starts[row]
    idx = np.full((H * nqb, max_a), -1, np.int32)
    idx[row, pos] = col
    return idx.reshape(H, nqb, max_a)


def _use_sparse_kernel(impl: str, device) -> bool:
    """The kernel gate: "auto" takes the kernels for every CUDA tensor (a
    block or head dim they do not take raises in the wrapper), "jnp" the
    plain path on every device."""
    if impl not in ("auto", "jnp"):
        raise ValueError(f"impl {impl!r} (the port takes 'auto' or 'jnp')")
    return impl == "auto" and torch.device(device).type == "cuda"


class _SparseFlash(torch.autograd.Function):
    """The kernel path: the forward kernel keeps out and lse; the backward
    is the dq and dk/dv kernels over the table and its reverse."""

    @staticmethod
    def forward(ctx, q, k, v, tables, block, causal, scale):
        idx, rev = tables
        # the kernels take contiguous [B, S, H, D]; q/k/v sliced out of a
        # fused projection are not
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = sparse_flash.block_sparse_flash_attention(
            q, k, v, idx, block, causal=causal, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, idx, rev)
        ctx.block, ctx.causal, ctx.scale = block, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, idx, rev = ctx.saved_tensors
        dq, dk, dv = sparse_flash.block_sparse_flash_backward(
            q, k, v, idx, rev, out, dout.contiguous(), lse, ctx.block,
            causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def _device_tables(kb_idx: np.ndarray, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    rev = sparse_flash.reverse_gather(kb_idx)
    return (torch.from_numpy(np.ascontiguousarray(kb_idx, np.int32)).to(
                device),
            torch.from_numpy(rev).to(device))


def block_sparse_attention(q, k, v, layout: np.ndarray, block: int,
                           causal: bool = True, scale: Optional[float] = None,
                           impl: str = "auto", tables=None):
    """q, k, v: [B, S, H, D]; layout: [H, S/block, S/block] bool (static).
    Differentiable in q, k and v.  `tables` (the gather table as numpy
    and the device tables `(kb_idx, rev)`), when given, saves rebuilding
    them (`SparseSelfAttention` caches them)."""
    B, S, H, D = q.shape
    nb = S // block
    if layout.shape != (H, nb, nb):
        raise ValueError(f"layout {layout.shape} != {(H, nb, nb)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if tables is None:
        kb_idx = _layout_to_gather(layout)
        dev_tables = None
    else:
        kb_idx, dev_tables = tables
    if _use_sparse_kernel(impl, q.device):
        if dev_tables is None:
            dev_tables = _device_tables(kb_idx, q.device)
        return _SparseFlash.apply(q, k, v, dev_tables, block, bool(causal),
                                  float(scale))
    return sparse_flash.block_sparse_flash_attention_reference(
        q, k, v, kb_idx, block, causal, scale, round_p=True)[0]


class SparseSelfAttention:
    """User module: holds a sparsity config and applies block-sparse
    attention to [B, S, H, D] q/k/v."""

    def __init__(self, sparsity_config: SparsityConfig,
                 causal: Optional[bool] = None, impl: str = "auto"):
        self.sparsity_config = sparsity_config
        if causal is None:
            # bidirectional layouts must not be silently causal-masked;
            # configs without an attention mode default causal
            causal = getattr(sparsity_config, "attention",
                             "unidirectional") == "unidirectional"
        elif (not causal and getattr(sparsity_config, "attention", None)
              == "unidirectional"):
            causal = True
        self.causal = causal
        self.impl = impl
        self._layouts: Dict[int, np.ndarray] = {}
        self._gathers: Dict[int, np.ndarray] = {}
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}

    def layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def tables(self, seq_len: int, device):
        """(kb_idx numpy, (kb_idx, rev) int32 tensors on `device`), built
        once per sequence length and device."""
        if seq_len not in self._gathers:
            self._gathers[seq_len] = _layout_to_gather(self.layout(seq_len))
        kb_idx = self._gathers[seq_len]
        key = (seq_len, str(torch.device(device)))
        if key not in self._tables:
            self._tables[key] = _device_tables(kb_idx, device)
        return kb_idx, self._tables[key]

    def __call__(self, q, k, v):
        S = q.shape[1]
        return block_sparse_attention(
            q, k, v, self.layout(S), self.sparsity_config.block,
            causal=self.causal, impl=self.impl,
            tables=self.tables(S, q.device))
