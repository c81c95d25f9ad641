"""The CenterPoint encoder benchmark input and net (counterpart of
``spconv_tpu/benchmark/centerpoint.py``).

The JAX package voxelizes the reference's real LiDAR scan
(``benchmark-pc.npz``) at 0.1 m over ``[-51.2, 51.2]^2 x [-5, 3]`` into an
``[80, 1024, 1024]`` grid.  That file is not in the repository, so a
seeded ``basic.synthetic_scan`` on the same grid with 113,000 voxels stands
in for its voxels.  :func:`voxelized_centerpoint_input` follows the JAX
loader from points to the tensor: it voxelizes a point cloud
(:func:`synthetic_centerpoint_points`, 1-3 points inside each voxel of the
stand-in scan and about 5 % outside the range, or a user's scan) with the
loader's ``PointToVoxel`` and adds the nuScenes intensity and timestamp
columns.  :func:`synthetic_centerpoint_input` builds the same sites
straight from the stand-in scan, without the voxelizer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..calibrate import apply_out_bounds, calibrate_out_bounds
from ..core import SparseConvTensor, default_device
from ..models import SparseEncoder, centerpoint_encoder
from ..utils import PointToVoxel
from .basic import synthetic_scan

__all__ = ["CP_SHAPE", "CP_VOXELS", "CP_VSIZE", "CP_RANGE", "CP_MAX_VOXELS",
           "synthetic_centerpoint_input", "synthetic_centerpoint_points",
           "voxelized_centerpoint_input", "build_calibrated_encoder"]

CP_SHAPE = (80, 1024, 1024)
CP_VOXELS = 113_000
# the JAX loader's PointToVoxel: 0.1 m voxels over [-51.2, 51.2]^2 x [-5, 3]
# (ZYX grid CP_SHAPE), at most 200,000 voxels of one point each
CP_VSIZE = (0.1, 0.1, 0.1)
CP_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
CP_MAX_VOXELS = 200_000


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


def synthetic_centerpoint_points(seed: int = 0,
                                 shape: Sequence[int] = CP_SHAPE,
                                 n_target: int = CP_VOXELS) -> np.ndarray:
    """A seeded ``[N, 3]`` f32 xyz cloud in metres whose voxels at
    ``CP_VSIZE`` over ``CP_RANGE`` are those of ``synthetic_scan(seed,
    shape, n_target)``: 1-3 points strictly inside each such voxel, at its
    centre +- 0.4 of a voxel on every axis (about 226,000 at the default
    size), plus 1 point outside the range for every 19 inside (5 % of the
    cloud), in shuffled order."""
    _, coors, _ = synthetic_scan(seed, shape, n_target)
    rng = np.random.default_rng([seed, 1])
    vsize = np.asarray(CP_VSIZE)
    lower, upper = np.asarray(CP_RANGE[:3]), np.asarray(CP_RANGE[3:])
    per_voxel = rng.integers(1, 4, coors.shape[0])
    vox_xyz = np.repeat(coors[:, :0:-1], per_voxel, axis=0)
    inside = (lower + (vox_xyz + 0.5) * vsize
              + rng.uniform(-0.4, 0.4, vox_xyz.shape) * vsize)
    # outside: a point of a larger box pushed past one face of the range
    n_out = inside.shape[0] // 19
    outside = rng.uniform(lower - 5, upper + 5, (n_out, 3))
    axis = rng.integers(0, 3, n_out)
    below = rng.random(n_out) < 0.5
    gap = rng.uniform(0.01, 5.0, n_out)
    rows = np.arange(n_out)
    outside[rows, axis] = np.where(below, lower[axis] - gap,
                                   upper[axis] + gap)
    pts = np.concatenate([inside, outside]).astype(np.float32)
    return pts[rng.permutation(pts.shape[0])]


def voxelized_centerpoint_input(
    seed: int = 0, dtype: torch.dtype = torch.float32, bucket: int = 1024,
    device: Optional[torch.device] = None, points=None,
) -> Tuple[SparseConvTensor, int]:
    """The JAX loader's path from points to the encoder's input ``(x,
    n_active)``: ``points`` (``[N, 3+]``, numpy or a tensor; default
    :func:`synthetic_centerpoint_points(seed)`) voxelized on ``device``
    with the loader's ``PointToVoxel`` (``CP_VSIZE``, ``CP_RANGE``, 3
    features, ``CP_MAX_VOXELS`` voxels of 1 point); features = each voxel's
    first point's xyz, intensity 1.0 and timestamp 0.0; batch index 0;
    rows cut to the voxel count, one host read as the loader's ``int(nv)``,
    and padded to a multiple of ``bucket``.  The voxels come in key order,
    so the tensor is ``keys_sorted``.  ``device`` None is the CUDA card."""
    device = default_device(device)
    if points is None:
        points = synthetic_centerpoint_points(seed)
    gen = PointToVoxel(CP_VSIZE, CP_RANGE, 3, CP_MAX_VOXELS, 1,
                       device=device)
    voxels, coords, _, _, num_voxels = gen.generate_voxel_with_id(points)
    nv = int(num_voxels)
    nbuf = max(bucket, -(-nv // bucket) * bucket)
    fp = torch.zeros((nbuf, 5), dtype=torch.float32, device=device)
    ip = torch.full((nbuf, 4), -1, dtype=torch.int32, device=device)
    fp[:nv, :3] = voxels[:nv, 0, :3].float()
    fp[:nv, 3] = 1.0  # intensity placeholder; timestamp 0 (nuScenes)
    ip[:nv, 0] = 0
    ip[:nv, 1:] = coords[:nv]
    x = SparseConvTensor(fp.to(dtype), ip, gen.grid_size, 1,
                         keys_sorted=True)
    return x, nv


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
