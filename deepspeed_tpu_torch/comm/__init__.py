"""Process groups and collectives of the port (`comm.py`), and the
per-rank process launcher of its tests and chip check (`launch.py`)."""
from . import comm
from .comm import (all_gather, all_reduce, barrier, destroy,
                   get_device, get_rank, get_world_size,
                   init_distributed, is_initialized, new_group,
                   reduce_scatter)
from .launch import spawn_ranks

__all__ = ["comm", "init_distributed", "is_initialized", "get_rank",
           "get_world_size", "get_device", "new_group",
           "all_gather", "reduce_scatter", "all_reduce", "barrier",
           "destroy", "spawn_ranks"]
