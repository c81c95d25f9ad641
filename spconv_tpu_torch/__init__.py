"""spconv_tpu_torch: the PyTorch / CUDA port of ``spconv_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100).  It keeps the
JAX package's public names, static-buffer semantics (a row is active iff
``indices[:, 0] >= 0``) and KRSC weight layout, and replaces its Pallas TPU
kernels with CUDA kernels written for ``sm_90a`` (``csrc/``), each with a
plain PyTorch version that CPU tensors take.  It never imports ``jax``.

Ported so far: the reference benchmark net's forward pass (submanifold
convs on the dynamic-gather path, the 2x/stride-2 max pool); see ROADMAP.md
for what is still to come.
"""

__version__ = "0.1.0"

from . import checkpoint, constants, ops
from .checkpoint import load_jax_state_dict
from .core import SparseConvTensor, expand_nd
from .modules import (DGData, SparseConvolution, SparseMaxPool,
                      SparseMaxPool3d, SparseModule, SparseSequential,
                      SubMConv3d)

__all__ = [
    "SparseConvTensor",
    "expand_nd",
    "SparseConvolution",
    "SubMConv3d",
    "SparseMaxPool",
    "SparseMaxPool3d",
    "SparseModule",
    "SparseSequential",
    "DGData",
    "load_jax_state_dict",
    "checkpoint",
    "constants",
    "ops",
]
