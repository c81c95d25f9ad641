from .conv import (DGData, DGRegData, SparseConv3d, SparseConvolution,
                   SparseInverseConv1d, SparseInverseConv2d,
                   SparseInverseConv3d, SparseInverseConv4d, SubMConv3d)
from .modules import (BatchNorm1d, SparseModule, SparseReLU,
                      SparseSequential)
from .pool import SparseMaxPool, SparseMaxPool3d
from .tables import AddTable, ConcatTable, JoinTable

__all__ = [
    "DGData",
    "DGRegData",
    "SparseConvolution",
    "SubMConv3d",
    "SparseConv3d",
    "SparseInverseConv1d",
    "SparseInverseConv2d",
    "SparseInverseConv3d",
    "SparseInverseConv4d",
    "BatchNorm1d",
    "SparseModule",
    "SparseReLU",
    "SparseSequential",
    "SparseMaxPool",
    "SparseMaxPool3d",
    "AddTable",
    "ConcatTable",
    "JoinTable",
]
