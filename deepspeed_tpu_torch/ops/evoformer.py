"""Evoformer (MSA row / triangle) attention with a mask bias and a pair
bias.

Counterpart of `deepspeed_tpu/ops/evoformer.py` (`evoformer_attention`,
`DS4Sci_EvoformerAttention`; the reference is DeepSpeed4Science's
`DS4Sci_EvoformerAttention`).  Q/K/V are [B, N, L, H, D]; up to two
additive biases, told apart by shape: the mask bias [B, N, 1, 1, L] and
the pair bias [B, 1, H, L, L], both broadcast against the
[B, N, H, L, L] scores.

`evoformer_attention` is differentiable in q, k, v and both biases:
- `impl="auto"` runs `_EvoformerKernel`: the forward kernel, and in the
  backward the dq, dk/dv and db2 kernels (`ops/evoformer_flash.py`), the
  JAX package's fully fused path.  On the card those are the only path:
  an input the kernels do not take raises.  The JAX hybrid (XLA forward,
  Pallas backward) and its gate were a TPU measurement with no
  counterpart here.  On CPU tensors the same Function runs the kernels'
  plain versions.
- `impl="jnp"` runs `_evoformer_plain`, the counterpart of the JAX
  `_evoformer_jnp` (chunked online softmax in f32), under autograd.
- Any other impl raises (the JAX "pallas" has no counterpart).
db1 and db2 are computed only when their bias requires grad (the JAX
custom_vjp computes them whenever the bias is given; the values are the
same).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from . import evoformer_flash

__all__ = ["evoformer_attention", "DS4Sci_EvoformerAttention"]

NEG = evoformer_flash.NEG_INF


def _check_biases(q, biases):
    B, N, L, H, D = q.shape
    b1 = b2 = None
    biases = [b for b in (biases or []) if b is not None]
    if len(biases) > 2:
        raise ValueError("at most two biases (mask bias, pair bias)")
    for b in biases:
        if tuple(b.shape) == (B, N, 1, 1, L):
            if b1 is not None:
                raise ValueError("two mask-shaped biases given; one per "
                                 "slot (mask, pair) as in the reference")
            b1 = b
        elif tuple(b.shape) == (B, 1, H, L, L):
            if b2 is not None:
                raise ValueError("two pair-shaped biases given; one per "
                                 "slot (mask, pair) as in the reference")
            b2 = b
        else:
            raise ValueError(
                f"bias shape {tuple(b.shape)} is neither mask-bias "
                f"{(B, N, 1, 1, L)} nor pair-bias {(B, 1, H, L, L)}")
    return b1, b2


def _check_chunk(L, chunk_size):
    if L > chunk_size and L % chunk_size != 0:
        raise ValueError(f"L={L} must be a multiple of "
                         f"chunk_size={chunk_size}")


def _use_evo_kernel(impl: str) -> bool:
    """"auto" takes the kernel path (the kernels on a CUDA tensor, their
    plain versions on the CPU), "jnp" the plain path."""
    if impl not in ("auto", "jnp"):
        raise ValueError(f"impl {impl!r} (the port takes 'auto' or 'jnp')")
    return impl == "auto"


def _aligned(t):
    """`t` contiguous and starting on a 16-byte boundary, as the kernels
    read it: a view that starts elsewhere (a bias sliced at an odd row,
    say) is copied."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _EvoformerKernel(torch.autograd.Function):
    """The kernel path: the forward kernel keeps out and lse; the backward
    is the dq, dk/dv (+db1) and db2 kernels.  Inputs the kernels would
    refuse for their layout alone (not contiguous, or not starting on a
    16-byte boundary) are copied first, as the reference takes them."""

    @staticmethod
    def forward(ctx, q, k, v, b1, b2):
        q, k, v, b1, b2 = (_aligned(t) for t in (q, k, v, b1, b2))
        out, lse = evoformer_flash.evoformer_flash_forward(
            q, k, v, b1, b2, return_lse=True)
        ctx.save_for_backward(q, k, v, b1, b2, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, b1, b2, out, lse = ctx.saved_tensors
        dq, dk, dv, db1, db2 = evoformer_flash.evoformer_flash_backward(
            q, k, v, b1, b2, out, _aligned(dout), lse,
            need_db1=ctx.needs_input_grad[3],
            need_db2=ctx.needs_input_grad[4])
        return dq, dk, dv, db1, db2


def evoformer_attention(q, k, v, biases: Sequence = (),
                        chunk_size: int = 128, impl: str = "auto"):
    """q, k, v: [B, N, L, H, D]; returns [B, N, L, H, D] in q's dtype.

    biases: up to two of mask-bias [B, N, 1, 1, L] / pair-bias
    [B, 1, H, L, L], in any order (told apart by shape, as the reference
    asserts the same shapes).  L must be at most `chunk_size` or a
    multiple of it, as in the JAX package."""
    L = q.shape[2]
    b1, b2 = _check_biases(q, biases)
    _check_chunk(L, chunk_size)
    if _use_evo_kernel(impl):
        return _EvoformerKernel.apply(q, k, v, b1, b2)
    return _evoformer_plain(q, k, v, b1, b2, chunk_size)


def _evoformer_plain(q, k, v, b1=None, b2=None, chunk_size: int = 128,
                     return_lse: bool = False):
    """The plain path, counterpart of the JAX `_evoformer_jnp`: keys in
    chunks with an online softmax in f32, scores clamped at -1e30 and
    re-masked, l floored at 1e-9.  return_lse: also the logsumexp
    [B*N, H, L] f32."""
    B, N, L, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    odt = q.dtype
    # scores laid out [B, N, H, Lq, Lk]
    qh = q.permute(0, 1, 3, 2, 4).float() * scale
    kh = k.permute(0, 1, 3, 2, 4).float()
    vh = v.permute(0, 1, 3, 2, 4).float()

    if L <= chunk_size:
        s = qh @ kh.transpose(-1, -2)
        if b1 is not None:
            s = s + b1.float()
        if b2 is not None:
            s = s + b2.float()
        # entries at/below the -1e30 mask level contribute exactly zero and
        # an all-masked row outputs zeros
        s = torch.clamp_min(s, NEG)
        m = s.amax(-1, keepdim=True)
        p = torch.where(s > NEG * 0.5, torch.exp(s - m), 0.0)
        out = p @ vh
        # eps**2 must stay normal in f32 (the division's gradient)
        l = p.sum(-1).clamp_min(1e-9)
        out = (out / l[..., None]).permute(0, 1, 3, 2, 4).to(odt)
        if return_lse:
            return out, (m[..., 0] + torch.log(l)).reshape(B * N, H, L)
        return out

    _check_chunk(L, chunk_size)
    m = torch.full((B, N, H, L), NEG, device=q.device)
    l = torch.zeros((B, N, H, L), device=q.device)
    acc = torch.zeros((B, N, H, L, D), device=q.device)
    b1f = b1.float() if b1 is not None else None
    b2f = b2.float() if b2 is not None else None
    for c0 in range(0, L, chunk_size):
        keys = slice(c0, c0 + chunk_size)
        s = qh @ kh[..., keys, :].transpose(-1, -2)
        if b1f is not None:
            s = s + b1f[..., keys]
        if b2f is not None:
            s = s + b2f[..., keys]
        s = torch.clamp_min(s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > NEG * 0.5, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vh[..., keys, :]
        m = m_new
    l = l.clamp_min(1e-9)
    out = (acc / l[..., None]).permute(0, 1, 3, 2, 4).to(odt)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B * N, H, L)
    return out


def DS4Sci_EvoformerAttention(Q, K, V, biases):
    """Drop-in name parity with the reference entry point."""
    return evoformer_attention(Q, K, V, biases)
