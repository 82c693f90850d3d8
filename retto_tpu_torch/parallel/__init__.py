"""Meshes, placement and multi-process helpers (port of ``retto_tpu/parallel``)."""

from . import distributed
from .mesh import data_sharding, make_mesh, replicate, shard_batch

__all__ = [
    "make_mesh",
    "shard_batch",
    "data_sharding",
    "replicate",
    "distributed",
]
