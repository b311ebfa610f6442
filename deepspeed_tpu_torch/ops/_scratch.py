"""Device state that the split kernels keep from call to call.

The paged TMA kernels split one output over several CTAs and merge the
splits in the launch itself: each CTA writes its partial state to a
workspace and takes an integer ticket, and the CTA that takes the last
ticket merges and sets the ticket back to 0.  Both buffers are cached per
(kernel, device, stream) here and grown when a call needs more, so no
call allocates them: the tickets start zeroed and the kernels leave them
zeroed; the workspace holds nothing between calls.  Calls on one stream
run in order, so they may share a buffer.  The fused LoRA kernel keeps
its partial sums and its work and tile counters here too (found zero;
each counter's last user zeroes it).

CUDA graphs read these buffers by address.  `replaying_on` keys a
capture's buffers by the stream its graph will replay on, so a replay and
the eager calls on that stream share them, and lists every buffer a call
takes within it: the holder of the graph keeps those, so a buffer that a
larger one replaces lives as long as a graph that reads it.  Within it no
buffer is made while the stream captures (it would be a fill node of the
graph, zeroing the buffer at every replay): the program warms up on the
capture stream first, which makes them.  Other captures (timing
harnesses) make theirs as before.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

__all__ = ["sm_count", "buffer", "replaying_on"]

_SMS: Dict[int, int] = {}
_BUFS: Dict[Tuple[str, int, int], torch.Tensor] = {}
# capture stream -> (the stream its graphs replay on, the buffers taken)
_ALIAS: Dict[int, Tuple[int, List[torch.Tensor]]] = {}


def _index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def sm_count(device) -> int:
    """The device's number of streaming multiprocessors (read once)."""
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


@contextmanager
def replaying_on(capture_stream: int, replay_stream: int):
    """Within this block, calls on `capture_stream` (a handle) use the
    buffers of `replay_stream`, where the graph captured here will
    replay.  Yields the list of the buffers they take, for the graph's
    holder to keep."""
    used: List[torch.Tensor] = []
    _ALIAS[capture_stream] = (replay_stream, used)
    try:
        yield used
    finally:
        _ALIAS.pop(capture_stream, None)


def buffer(name: str, device, stream: int, numel: int,
           dtype: torch.dtype) -> torch.Tensor:
    """The cached buffer `name` of at least `numel` elements on `device`
    for `stream`, zero-filled when first made (a ticket buffer stays
    zeroed from call to call; a workspace is overwritten before it is
    read)."""
    alias = _ALIAS.get(stream)
    key = (name, _index(device), alias[0] if alias else stream)
    buf = _BUFS.get(key)
    if buf is None or buf.numel() < numel or buf.dtype != dtype:
        if alias and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"scratch buffer {name!r} ({numel} elements) would be made "
                f"inside a CUDA graph capture: run the program once on the "
                f"capture stream before capturing it")
        buf = torch.zeros(1 << max(numel - 1, 1).bit_length(), dtype=dtype,
                          device=device)
        _BUFS[key] = buf
    if alias:
        alias[1].append(buf)
    return buf
