"""spconv_tpu_torch: the PyTorch / CUDA port of ``spconv_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100).  It keeps the
JAX package's public names, static-buffer semantics (a row is active iff
``indices[:, 0] >= 0``) and KRSC weight layout, and replaces its Pallas TPU
kernels with CUDA kernels written for ``sm_90a`` (``csrc/``), each with a
plain PyTorch version that CPU tensors take.  It never imports ``jax``.

Ported so far: the reference benchmark net (``benchmark.basic``) serving and
training (submanifold convs on the dynamic-gather path, forward and
backward; the 2x/stride-2 max and average pools on the segment route and
on the sorted-key route, whose kernel is B6, and the global pools); the
CenterPoint / SECOND encoder
(``models``: strided ``SparseConv3d``, ``BatchNorm1d``,
``SparseConvTensor.dense`` and out-bound calibration, ``calibrate``); and
the segmentation ``SparseUNet`` serving and training, through
``SparseInverseConv3d`` and ``JoinTable``.  The strided, the inverse and
the transposed conv (``SparseConvTranspose1d``-``4d``) run forward and
backward; the subm and regular convs come in 1 to 4
dimensions, and a subm conv without an ``indice_key`` runs table-free
search kernels.  Int8 post-training quantization
(``quantization``: ``quantize_encoder`` and friends) serves the encoder
through an int8 kernel, and quantization-aware training (``prepare_qat``,
``qat_observe``, ``convert_qat``) serves a trained net there too; the
small modules (``Lambda``, ``ToDense``, ``SparseSigmoid`` and the rest),
``SparseClassifier`` and the JAX package's MNIST examples
(``examples.mnist_sparse``, ``examples.mnist_qat``) come with them.
Input that is not key-sorted, ``algo="native"``, grids whose keys need
int64, keyed, subm and other pools, and the int8 transposed conv take the
native rulebook path (``ops.rulebook`` builds the JAX package's rulebooks,
whose pair tables the same kernels run).  Raw point clouds come in
through the voxelizer (``utils.PointToVoxel``, ``ops.point2voxel``); the
smaller ops ``sparse_add``, ``RemoveDuplicate`` and ``HashTable``,
checkpoints (``checkpoint``: npz, reference state dicts in any weight
layout, JAX state dicts), box ops (``utils.boxops``), the point-cloud codec
(``utils.pcc``) and the JAX package's other examples
(``examples.voxel_gen``, ``fuse_bn_act``, ``int8_ptq_encoder``) come with
it.  ``tools`` runs the JAX package's ``tools/`` probe scripts on the card
(``ops.probes``) and holds the timers (``KernelTimer``,
``benchmark_model``).  ``algo="auto"`` resolves through the conv tuner
(``tuner.CONV_TUNER``: cached winners, tune-on-first-call with
``SPCONV_TPU_TUNE=1``, B2's tile on the native path), ``benchmark=True``
tensors record each conv's and pool's time and voxel counts, and
``parallel`` trains data-parallel over ``torch.distributed`` with
``SparseSyncBatchNorm`` (and runs a column-parallel conv).  Every kernel
is a ``torch.library`` op (``ops.library``), so ``export`` traces a net
into a ``torch.export`` program that is saved, reloaded and served bit
for bit (``examples.export_model`` writes a deployment artifact).
Constructors, input builders and the probes put their tensors on the CUDA
card unless given ``device``.
See ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"

from . import (calibrate, checkpoint, constants, debug_utils, functional,
               hash, models, ops, parallel, quantization, tools, tuner,
               utils)
from .checkpoint import (load_checkpoint, load_jax_state_dict,
                         load_torch_state_dict, save_checkpoint)
from .constants import ConvAlgo
from .core import (IndiceData, SparseConvTensor, default_device, expand_nd,
                   scatter_nd)
from .functional import sparse_add
from .hash import HashTable
from .models import SparseUNet
from .modules import (AddTable, BatchNorm1d, ConcatTable, DGData, DGRegData,
                      Identity, JoinTable, Lambda, PrintCurrentTime,
                      PrintTensorMeta, RemoveDuplicate, SparseAvgPool, SparseAvgPool1d,
                      SparseAvgPool2d, SparseAvgPool3d, SparseBatchNorm,
                      SparseConv1d, SparseConv2d, SparseConv3d, SparseConv4d,
                      SparseConvolution, SparseConvTranspose1d,
                      SparseConvTranspose2d, SparseConvTranspose3d,
                      SparseConvTranspose4d, SparseGlobalAvgPool,
                      SparseGlobalMaxPool, SparseIdentity,
                      SparseInverseConv1d, SparseInverseConv2d,
                      SparseInverseConv3d, SparseInverseConv4d,
                      SparseLeakyReLU, SparseMaxPool, SparseMaxPool1d,
                      SparseMaxPool2d, SparseMaxPool3d, SparseMaxPool4d,
                      SparseModule, SparseReLU, SparseSequential,
                      SparseSigmoid, SparseSyncBatchNorm, SubMConv1d,
                      SubMConv2d, SubMConv3d, SubMConv4d, ToDense,
                      assign_name_for_sparse_modules)
from .tuner import CONV_TUNER, ConvTuner

__all__ = [
    "SparseConvTensor",
    "IndiceData",
    "default_device",
    "expand_nd",
    "scatter_nd",
    "SparseConvolution",
    "SubMConv1d",
    "SubMConv2d",
    "SubMConv3d",
    "SubMConv4d",
    "SparseConv1d",
    "SparseConv2d",
    "SparseConv3d",
    "SparseConv4d",
    "SparseInverseConv1d",
    "SparseInverseConv2d",
    "SparseInverseConv3d",
    "SparseInverseConv4d",
    "SparseConvTranspose1d",
    "SparseConvTranspose2d",
    "SparseConvTranspose3d",
    "SparseConvTranspose4d",
    "AddTable",
    "ConcatTable",
    "JoinTable",
    "SparseUNet",
    "BatchNorm1d",
    "SparseBatchNorm",
    "SparseSyncBatchNorm",
    "SparseMaxPool",
    "SparseMaxPool1d",
    "SparseMaxPool2d",
    "SparseMaxPool3d",
    "SparseMaxPool4d",
    "SparseAvgPool",
    "SparseAvgPool1d",
    "SparseAvgPool2d",
    "SparseAvgPool3d",
    "SparseGlobalMaxPool",
    "SparseGlobalAvgPool",
    "SparseModule",
    "SparseSequential",
    "Lambda",
    "SparseIdentity",
    "Identity",
    "SparseReLU",
    "SparseLeakyReLU",
    "SparseSigmoid",
    "ToDense",
    "PrintTensorMeta",
    "PrintCurrentTime",
    "assign_name_for_sparse_modules",
    "RemoveDuplicate",
    "sparse_add",
    "HashTable",
    "DGData",
    "DGRegData",
    "load_jax_state_dict",
    "save_checkpoint",
    "load_checkpoint",
    "load_torch_state_dict",
    "ConvAlgo",
    "ConvTuner",
    "CONV_TUNER",
    "calibrate",
    "checkpoint",
    "constants",
    "debug_utils",
    "functional",
    "hash",
    "models",
    "ops",
    "parallel",
    "quantization",
    "tools",
    "tuner",
    "utils",
]
