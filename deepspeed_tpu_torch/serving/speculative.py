"""Speculative decoding, stage 1: model-free prompt-lookup drafts.

Counterpart of `deepspeed_tpu/serving/speculative.py`, kept as the port's
own copy (the module is host bookkeeping in numpy; the port imports
nothing of the JAX package).

Decode is weight-bandwidth-bound: a verify forward over K draft tokens
moves every weight once for up to K+1 tokens of progress, so on
templated or extractive traffic, where the continuation often already
appears in the request's own context, acceptance turns nearly free
compute into delivered tokens.

- **Drafting** (this module) is host bookkeeping over token ids the
  caller already holds (prompt + generated): `PromptLookupDrafter`
  matches the trailing n-gram of a request's context against the context
  itself and proposes the continuation of the most recent match.
- **Verification** is one call on the device
  (`inference/v2/ragged_ops.verify_tokens`, dispatched through
  `InferenceEngineV2.decode_burst_step(drafts=...)`): the span forward,
  accept/reject, and the replacement or bonus token; the host reads only
  the emitted tokens and counts.

`DraftSource` is model-agnostic: a small draft model sharing the
target's KV arena would implement the same `draft()` contract, and the
engine's verify path would not change.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DraftSource", "PromptLookupDrafter", "span_bucket",
           "filter_draft"]


def filter_draft(draft, automaton, state: int) -> np.ndarray:
    """The grammar pre-filter for constrained speculative rows: truncate
    `draft` at its first token that `automaton` (any object with a host
    `trans` [states, vocab] table, < 0 = disallowed) refuses, walking
    from `state`.

    A refused draft token would be rejected by the verify anyway, but a
    rejection ends the accepted prefix, so one out-of-grammar token would
    forfeit every drafted token after it; truncating on the host costs a
    few table lookups and keeps every staged draft token allowed at its
    span position."""
    toks = np.asarray(draft, np.int32).ravel()
    st = int(state)
    n = 0
    for t in toks:
        nt = int(automaton.trans[st, int(t)])
        if nt < 0:
            break
        st = nt
        n += 1
    return toks[:n]


def span_bucket(n: int) -> int:
    """The fixed span width for a verify span of up to `n` tokens
    (pending + drafts): the next power of two, floor 2.  A caller buckets
    each dispatch by its longest draft, so every draft length maps into
    the small set {2, 4, ..., span_bucket(1 + max_draft)}, and a batch of
    short drafts pays the small span."""
    if n < 1:
        raise ValueError(f"span must cover at least the pending token, "
                         f"got {n}")
    s = 2
    while s < n:
        s *= 2
    return s


class DraftSource:
    """Draft-provider contract for speculative serving: given a request's
    full context (prompt + every generated token, the pending one
    included), propose up to `max_draft` continuation tokens.  An empty
    array is always legal (the dispatch then verifies the bare pending
    token: one ordinary decode step)."""

    def draft(self, context: np.ndarray, max_draft: int) -> np.ndarray:
        raise NotImplementedError

    def observe(self, drafted: int, accepted: int) -> None:
        """Per-dispatch feedback (drafted vs accepted token counts) for
        adaptive sources; the default drafter ignores it."""


class PromptLookupDrafter(DraftSource):
    """Model-free prompt-lookup drafts: match the context's trailing
    n-gram (n = `ngram`, backing off to 1) against the context itself and
    draft the tokens that followed the most recent earlier match.

    Templated prompts (shared preambles, few-shot blocks, retrieved
    documents) and extractive or repetitive generations put the next
    tokens verbatim in the request's own context, and the whole span is
    then accepted.  On traffic with no self-similarity the matcher
    returns empty drafts and serving degrades to ordinary (verified
    single-token) decode, never to wrong outputs: the target model
    decides acceptance."""

    def __init__(self, ngram: int = 3, max_draft: int = 7):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        if max_draft < 0:
            raise ValueError(f"max_draft must be >= 0, got {max_draft}")
        self.ngram = ngram
        self.max_draft = max_draft

    def draft(self, context: np.ndarray, max_draft: int = -1) -> np.ndarray:
        """Up to `max_draft` (default: the constructor's) proposed
        continuation tokens for `context` (int32 1-D, the request's
        prompt + generated tokens).  Empty when nothing matches."""
        if max_draft < 0:
            max_draft = self.max_draft
        ctx = np.asarray(context, np.int32).ravel()
        L = len(ctx)
        if max_draft == 0 or L < 2:
            return np.zeros(0, np.int32)
        for n in range(min(self.ngram, L - 1), 0, -1):
            pattern = ctx[L - n:]
            # every window of length n except the trailing one itself
            windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((windows == pattern[None]).all(axis=1))[0]
            if hits.size == 0:
                continue
            # the most recent occurrence that still has a full max_draft
            # continuation before the context end; with only near-end
            # matches (a short-period cycle puts one every p tokens), the
            # earliest, whose continuation is the longest available
            full = hits[hits + n + max_draft <= L]
            j = int(full[-1]) if full.size else int(hits[0])
            cont = ctx[j + n: j + n + max_draft]
            if 0 < len(cont) < max_draft:
                # cyclic extension: a period-p loop drafts whole spans at
                # once instead of p tokens at a time (a wrong guess costs
                # only rejected tokens)
                reps = -(-max_draft // len(cont))
                cont = np.tile(cont, reps)[:max_draft]
            if cont.size:
                return np.ascontiguousarray(cont, np.int32)
        return np.zeros(0, np.int32)
