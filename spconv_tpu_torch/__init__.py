"""spconv_tpu_torch: the PyTorch / CUDA port of ``spconv_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100).  It keeps the
JAX package's public names, static-buffer semantics (a row is active iff
``indices[:, 0] >= 0``) and KRSC weight layout, and replaces its Pallas TPU
kernels with CUDA kernels written for ``sm_90a`` (``csrc/``), each with a
plain PyTorch version that CPU tensors take.  It never imports ``jax``.

Ported so far: the reference benchmark net (``benchmark.basic``) serving and
training (submanifold convs on the dynamic-gather path, forward and
backward; the 2x/stride-2 max pool), and the CenterPoint / SECOND encoder
(``models``) serving: strided ``SparseConv3d`` forward, ``BatchNorm1d``,
``SparseConvTensor.dense`` and out-bound calibration (``calibrate``).  See
ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"

from . import calibrate, checkpoint, constants, models, ops
from .checkpoint import load_jax_state_dict
from .core import SparseConvTensor, expand_nd
from .modules import (BatchNorm1d, DGData, DGRegData, SparseConv3d,
                      SparseConvolution, SparseMaxPool, SparseMaxPool3d,
                      SparseModule, SparseSequential, SubMConv3d)

__all__ = [
    "SparseConvTensor",
    "expand_nd",
    "SparseConvolution",
    "SubMConv3d",
    "SparseConv3d",
    "BatchNorm1d",
    "SparseMaxPool",
    "SparseMaxPool3d",
    "SparseModule",
    "SparseSequential",
    "DGData",
    "DGRegData",
    "load_jax_state_dict",
    "calibrate",
    "checkpoint",
    "constants",
    "models",
    "ops",
]
