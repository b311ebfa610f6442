"""The collectives facade, the part the tensor-parallel serving path uses.

Counterpart of `deepspeed_tpu/comm/comm.py`.  The reference's collectives
are traced inside a shard_map region over a named mesh axis; here each
rank is one process on one device, and a collective is a
`torch.distributed` call on a process group (None = the whole world):
NCCL on the card, gloo on the CPU.  The backend follows from the device
the caller names and is passed to `init_process_group` explicitly; it is
never left to torch to guess.

Not carried yet: the rest of the facade (all_to_all, broadcast, ppermute
helpers) and `CommsLogger`.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_initialized", "get_rank",
           "get_world_size", "get_device", "global_rank",
           "new_group", "all_gather", "reduce_scatter", "all_reduce",
           "barrier", "destroy"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_state = {"device": None}


def init_distributed(init_method: str, rank: int, world_size: int,
                     local_rank: Optional[int] = None, device="cuda",
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group of `world_size` ranks meeting at
    `init_method` (e.g. "tcp://localhost:29500" or "file:///path/store")
    as `rank`.  The rank's device is cuda:<local_rank> (local_rank
    defaults to rank: one host) with backend "nccl", or the CPU with
    backend "gloo" when the caller asks for device="cpu".  Returns the
    rank's device."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"device {device!r}: the port's collectives run on "
                         f"'cuda' (nccl) or 'cpu' (gloo)")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    local = rank if local_rank is None else local_rank
    kw = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but no CUDA device is "
                               f"available")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend=_BACKENDS[kind], init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kw)
    _state["device"] = dev
    return dev


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank in `group` (the world when None)."""
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    return dist.get_world_size(group)


def get_device() -> torch.device:
    """The device `init_distributed` gave this rank."""
    if _state["device"] is None:
        raise RuntimeError("init_distributed has not run in this process")
    return _state["device"]


def global_rank(group, group_rank: int) -> int:
    """The world rank of `group_rank` in `group` (P2P ops take world
    ranks)."""
    return group_rank if group is None else dist.get_global_rank(
        group, group_rank)


def new_group(ranks: Sequence[int]):
    """A process group over `ranks` (every world rank must call this)."""
    return dist.new_group(list(ranks))


def all_gather(tensor, group=None, dim: int = 0):
    """Concatenate every rank's `tensor` along `dim` (the reference's
    tiled all_gather), through `all_gather_into_tensor`."""
    n = dist.get_world_size(group)
    src = tensor.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(tensor, group=None):
    """Sum `tensor` over the ranks and keep this rank's chunk of dim 0
    (the reference's tiled psum_scatter), through
    `reduce_scatter_tensor`."""
    n = dist.get_world_size(group)
    src = tensor.contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(tensor, group=None, op: str = "sum"):
    """Reduce `tensor` over the ranks ("sum" or "max"), in place; returns
    it."""
    dist.all_reduce(tensor, op=_OPS[op], group=group)
    return tensor


def barrier(group=None) -> None:
    if _state["device"] is not None and _state["device"].type == "cuda":
        dist.barrier(group=group, device_ids=[_state["device"].index])
    else:
        dist.barrier(group=group)


def destroy() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = None
