"""The tensor-parallel axis of the device mesh.

Counterpart of `deepspeed_tpu/parallel/mesh.py`, the tp axis only: the
reference names its axes over one SPMD device mesh; here the tp axis is a
`torch.distributed` process group of one process per device, and a
`MeshTopology` carries its size, this process's rank in it, the group and
the rank's device.  The dp, fsdp, ep, sp and pp axes are not carried yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..comm import comm

__all__ = ["AXIS_TP", "MeshTopology", "make_tp_mesh"]

AXIS_TP = "tp"


@dataclass(frozen=True)
class MeshTopology:
    tp_size: int
    tp_rank: int
    tp_group: object           # torch.distributed ProcessGroup
    device: torch.device


def make_tp_mesh(tp: int) -> MeshTopology:
    """The tp axis over every rank of the initialized process group (the
    reference's `make_tp_mesh` spans the first `tp` devices; with one
    process per device that is the whole world, and other axes are not
    carried yet).  Call `comm.init_distributed` in every rank first."""
    if not comm.is_initialized():
        raise RuntimeError(
            f"tensor_parallel_size={tp} needs an initialized process group "
            f"of {tp} ranks: call deepspeed_tpu_torch.comm.init_distributed"
            f"(...) in every rank first (one process per device)")
    world = comm.get_world_size()
    if world != tp:
        raise ValueError(
            f"tensor_parallel_size={tp} but the process group has {world} "
            f"ranks: the port carries the tp axis only, over every rank")
    return MeshTopology(tp_size=tp, tp_rank=comm.get_rank(), tp_group=None,
                        device=comm.get_device())
