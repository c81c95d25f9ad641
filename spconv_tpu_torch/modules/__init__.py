from .conv import DGData, SparseConvolution, SubMConv3d
from .modules import SparseModule, SparseSequential
from .pool import SparseMaxPool, SparseMaxPool3d

__all__ = [
    "DGData",
    "SparseConvolution",
    "SubMConv3d",
    "SparseModule",
    "SparseSequential",
    "SparseMaxPool",
    "SparseMaxPool3d",
]
