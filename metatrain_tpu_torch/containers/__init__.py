from .block import TensorBlock, TensorMap
from .labels import Labels
from .system import (
    NeighborData,
    System,
    SystemBatch,
    batch_from_systems,
    bucket_atoms,
    bucket_neighbors,
    bucket_size,
)

__all__ = [
    "Labels",
    "NeighborData",
    "System",
    "SystemBatch",
    "TensorBlock",
    "TensorMap",
    "batch_from_systems",
    "bucket_atoms",
    "bucket_neighbors",
    "bucket_size",
]
