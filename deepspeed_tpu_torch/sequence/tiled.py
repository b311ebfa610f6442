"""ALST tiled fused logits + loss: the [B, S, V] logits never exist whole.

Counterpart of `deepspeed_tpu/sequence/tiled.py` `tiled_fused_logits_loss`
(reference: runtime/sequence_parallel/ulysses_sp.py TiledFusedLogitsLoss
:898).  The JAX version scans a `jax.checkpoint`ed chunk function; here a
Python loop runs each sequence chunk under
`torch.utils.checkpoint.checkpoint`, which keeps only the chunk's inputs,
so one chunk's [B, S/shards, V] f32 logits is live at a time in the
forward and again, recomputed, in the backward (206 MB at GPT-2-1.3B's
bench shape, B 4, S 2048, 8 shards).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.transformer import dense_f32

__all__ = ["tiled_fused_logits_loss"]


def _chunk_loss(xc, head, lc, mc, bias, label_smoothing):
    logits = dense_f32(xc, head)
    if bias is not None:
        logits = logits + bias.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    nll = logz - gold
    if label_smoothing > 0.0:
        smooth = logz - logits.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return (nll * mc).sum(), mc.sum()


def tiled_fused_logits_loss(x, head, labels, shards: int = 8, mask=None,
                            label_smoothing: float = 0.0, bias=None):
    """Fused logits+loss over sequence chunks.  x: [B, S, H] final hidden
    states; head: [H, V]; labels: [B, S] int.  Returns the mean token NLL
    (the masked mean when `mask` is given) as a 0-d f32 tensor."""
    B, S, H = x.shape
    if S % shards != 0:
        raise ValueError(
            f"tiled_fused_logits_loss: seq len {S} not divisible by "
            f"shards={shards}; falling back would materialize the full "
            f"[B,S,V] logits this feature exists to avoid — pad/crop the "
            f"batch or pick a divisor of {S}")
    chunk = S // shards
    labels = labels.long()
    maskf = (mask.float() if mask is not None
             else torch.ones(B, S, dtype=torch.float32, device=x.device))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(shards):
        sl = slice(i * chunk, (i + 1) * chunk)
        s, c = checkpoint(_chunk_loss, x[:, sl], head, labels[:, sl],
                          maskf[:, sl], bias, label_smoothing,
                          use_reentrant=False)
        tot = tot + s
        cnt = cnt + c
    return tot / torch.clamp_min(cnt, 1.0)
