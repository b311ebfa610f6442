"""Parallel topology of the port: the tensor-parallel axis (`mesh.py`)."""
from .mesh import AXIS_TP, MeshTopology, make_tp_mesh

__all__ = ["AXIS_TP", "MeshTopology", "make_tp_mesh"]
