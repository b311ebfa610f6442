"""Logits post-processing shared by the port's samplers.

Counterpart of `deepspeed_tpu/inference/sampling.py`: the temperature
scale + top-k truncation step, scalar and per-row.  (The grammar `mask`
operand of the reference's per-row variant belongs to structured
generation, which the port does not carry yet.)
"""
from __future__ import annotations

import torch

__all__ = ["scale_topk", "scale_topk_per_row"]


def scale_topk(logits, temperature, top_k: int):
    """fp32 logits scaled by a clamped temperature, entries below the
    per-row top_k-th value masked to -inf (top_k <= 0 -> no truncation).
    Callers gate their own greedy path (temperature <= 0) before this."""
    l = logits.float() / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = l.masked_fill(l < kth, float("-inf"))
    return l


def scale_topk_per_row(logits, temperature, top_k):
    """Heterogeneous-batch variant of `scale_topk`: `temperature` [B] and
    `top_k` [B] int are per-row tensors.  The per-row kth threshold comes
    from a full descending sort; top_k[i] <= 0 means no truncation for
    that row, and ties at the kth value survive (`l < kth` masking, as in
    `scale_topk`).  Rows with temperature <= 0 are the caller's greedy
    rows (the clamp only keeps the division finite)."""
    t = temperature.float().clamp(min=1e-6)
    l = logits.float() / t[:, None]
    V = l.shape[-1]
    k = top_k.long()
    srt = torch.sort(l, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (k - 1).clamp(0, V - 1)[:, None])   # [B, 1]
    keep = (k[:, None] <= 0) | (l >= kth)
    return l.masked_fill(~keep, float("-inf"))
