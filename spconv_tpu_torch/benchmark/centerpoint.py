"""The CenterPoint encoder benchmark input and net (counterpart of
``spconv_tpu/benchmark/centerpoint.py``).

The JAX package voxelizes the reference's real LiDAR scan
(``benchmark-pc.npz``) at 0.1 m over ``[-51.2, 51.2]^2 x [-5, 3]`` into an
``[80, 1024, 1024]`` grid.  That file is not in the repository, and the
voxelizer (``PointToVoxel``) is not ported yet, so
:func:`synthetic_centerpoint_input` stands in: a seeded
``basic.synthetic_scan`` on the same grid with 113,000 voxels and the
nuScenes intensity and timestamp columns added, as the JAX loader adds
them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..calibrate import apply_out_bounds, calibrate_out_bounds
from ..core import SparseConvTensor, default_device
from ..models import SparseEncoder, centerpoint_encoder
from .basic import synthetic_scan

__all__ = ["CP_SHAPE", "CP_VOXELS", "synthetic_centerpoint_input",
           "build_calibrated_encoder"]

CP_SHAPE = (80, 1024, 1024)
CP_VOXELS = 113_000


def synthetic_centerpoint_input(
    seed: int = 0, batch: int = 1, shape: Sequence[int] = CP_SHAPE,
    n_target: int = CP_VOXELS, dtype: torch.dtype = torch.float32,
    bucket: int = 1024, device: Optional[torch.device] = None,
) -> Tuple[SparseConvTensor, int]:
    """A key-sorted 5-feature scan ``(x, n_active)``: the 3 position
    features of ``synthetic_scan(seed, shape, n_target)``, intensity 1.0
    and timestamp 0.0, padded to a multiple of ``bucket`` rows (113,664
    at the default size).  ``batch`` > 1 repeats the scan at every batch
    index (batch-major rows stay key-sorted), as the JAX loader does.
    ``device`` None is the CUDA card."""
    device = default_device(device)
    voxels, coors, grid = synthetic_scan(seed, shape, n_target)
    nv = voxels.shape[0]
    nbuf = max(bucket, -(-(nv * batch) // bucket) * bucket)
    fp = np.zeros((nbuf, 5), np.float32)
    ip = np.full((nbuf, 4), -1, np.int32)
    for b in range(batch):
        rows = slice(b * nv, (b + 1) * nv)
        fp[rows, :3] = voxels
        fp[rows, 3] = 1.0  # intensity placeholder
        fp[rows, 4] = 0.0  # timestamp (nuScenes 5-feature)
        ip[rows, 0] = b
        ip[rows, 1:] = coors[:, 1:]
    # synthetic_scan's voxels come in ascending key order
    x = SparseConvTensor(torch.from_numpy(fp).to(device=device, dtype=dtype),
                         torch.from_numpy(ip).to(device=device), grid, batch,
                         keys_sorted=True)
    return x, nv * batch


def build_calibrated_encoder(x: SparseConvTensor,
                             dtype: torch.dtype = torch.bfloat16,
                             algo: Optional[str] = None,
                             bounds: Optional[Sequence[Optional[int]]] = None,
                             seed: int = 0) -> SparseEncoder:
    """The ``bn=False`` CenterPoint encoder (BN folded out, as served) in
    eval mode, its buffers calibrated on ``x`` in f32 (margin 1.15,
    rounded to 512) or set from ``bounds``
    (``calibrate.export_out_bounds``), then cast to ``dtype``."""
    net32 = centerpoint_encoder(in_channels=5, bn=False, algo=algo,
                                device=x.features.device, seed=seed).eval()
    if bounds is not None:
        net32 = apply_out_bounds(net32, bounds)
    else:
        x32 = x.replace_feature(x.features.float())
        net32 = calibrate_out_bounds(net32, lambda m, t: m.bev(t), [x32],
                                     margin=1.15, mult=512)
    return net32.to(dtype)
