from .conv import (DGData, DGRegData, SparseConv3d, SparseConvolution,
                   SubMConv3d)
from .modules import BatchNorm1d, SparseModule, SparseSequential
from .pool import SparseMaxPool, SparseMaxPool3d

__all__ = [
    "DGData",
    "DGRegData",
    "SparseConvolution",
    "SubMConv3d",
    "SparseConv3d",
    "BatchNorm1d",
    "SparseModule",
    "SparseSequential",
    "SparseMaxPool",
    "SparseMaxPool3d",
]
