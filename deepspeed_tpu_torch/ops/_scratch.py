"""Device state that the split kernels keep from call to call.

The paged TMA kernels split one output over several CTAs and merge the
splits in the launch itself: each CTA writes its partial state to a
workspace and takes an integer ticket, and the CTA that takes the last
ticket merges and sets the ticket back to 0.  Both buffers are cached per
(kernel, device, stream) here and grown when a call needs more, so no
call allocates them: the tickets start zeroed and the kernels leave them
zeroed; the workspace holds nothing between calls.  Calls on one stream
run in order, so they may share a buffer.  The fused LoRA kernel keeps
its partial sums and its work and tile counters here too (two counter
regions, used by turns, each zeroed by the call after the one that used
it).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["sm_count", "buffer"]

_SMS: Dict[int, int] = {}
_BUFS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def _index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def sm_count(device) -> int:
    """The device's number of streaming multiprocessors (read once)."""
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def buffer(name: str, device, stream: int, numel: int,
           dtype: torch.dtype) -> torch.Tensor:
    """The cached buffer `name` of at least `numel` elements on `device`
    for `stream`, zero-filled when first made (a ticket buffer stays
    zeroed from call to call; a workspace is overwritten before it is
    read)."""
    key = (name, _index(device), stream)
    buf = _BUFS.get(key)
    if buf is None or buf.numel() < numel or buf.dtype != dtype:
        buf = torch.zeros(1 << max(numel - 1, 1).bit_length(), dtype=dtype,
                          device=device)
        _BUFS[key] = buf
    return buf
