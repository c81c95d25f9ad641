"""Voxelization example (counterpart of ``examples/voxel_gen.py``): a raw
point cloud -> ``PointToVoxel`` -> ``SparseConvTensor`` -> one
``SubMConv3d(4, 16, 3)`` -> per-voxel features mapped back to the points.

Usage: python -m spconv_tpu_torch.examples.voxel_gen
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import SparseConvTensor, default_device
from ..modules import SubMConv3d
from ..utils import PointToVoxel, gather_features_by_pc_voxel_id

__all__ = ["make_points", "make_generator", "voxel_tensor", "run", "main"]


def make_points(seed: int = 0) -> np.ndarray:
    """The example's cloud: 20,000 points ``[x, y, z, feature]``, x and y
    in [-10, 10), z in [-2, 2), drawn as the JAX example draws them."""
    rng = np.random.RandomState(seed)
    pc = rng.uniform(-10, 10, size=(20000, 4)).astype(np.float32)
    pc[:, 2] = rng.uniform(-2, 2, 20000)
    return pc


def make_generator(device=None) -> PointToVoxel:
    """0.25 m voxels over [-10, 10]^2 x [-2, 2], up to 20,000 voxels of 5
    points."""
    return PointToVoxel(vsize_xyz=[0.25, 0.25, 0.25],
                        coors_range_xyz=[-10, -10, -2, 10, 10, 2],
                        num_point_features=4, max_num_voxels=20000,
                        max_num_points_per_voxel=5, device=device)


def voxel_tensor(gen: PointToVoxel, pc):
    """``(x, pc_voxel_id, num_voxels)``: ``pc`` voxelized with empty-slot
    means, each voxel's feature the mean of its points, batch index 0
    prefixed to the ZYX coordinates.  The voxels come in key order, so
    ``x`` is ``keys_sorted``."""
    voxels, coords, num_per_voxel, pc_voxel_id, num_voxels = \
        gen.generate_voxel_with_id(pc, empty_mean=True)
    feats = voxels.sum(1) / num_per_voxel.clamp(min=1)[:, None].to(
        voxels.dtype)
    inds = torch.cat([torch.where(coords[:, :1] >= 0, 0, -1).int(), coords],
                     dim=1)
    feats = torch.where((inds[:, 0] >= 0)[:, None], feats,
                        torch.zeros_like(feats))
    x = SparseConvTensor(feats, inds, gen.grid_size, 1,
                         num_voxels=num_voxels, keys_sorted=True)
    return x, pc_voxel_id, num_voxels


def run(conv: SubMConv3d, gen: PointToVoxel, pc) -> torch.Tensor:
    """Per-point features ``[N, 16]`` of ``conv`` on the voxelized
    cloud (0 for a dropped point)."""
    x, pc_voxel_id, _ = voxel_tensor(gen, pc)
    with torch.no_grad():
        y = conv(x).features
    return gather_features_by_pc_voxel_id(y, pc_voxel_id)


def main(device=None, seed: int = 0) -> torch.Tensor:
    """The example on ``device`` (None: the CUDA card), weights drawn from
    ``seed``; prints the shapes and returns the per-point features."""
    device = default_device(device)
    gen = make_generator(device)
    pc = make_points(seed)
    conv = SubMConv3d(4, 16, 3, indice_key="c1", device=device,
                      generator=torch.Generator().manual_seed(seed))
    x, _, num_voxels = voxel_tensor(gen, pc)
    print(f"voxels: {tuple(x.features.shape)} rows, active: "
          f"{int(num_voxels)}")
    per_point = run(conv, gen, pc)
    print(f"per-point features: {tuple(per_point.shape)}")
    return per_point


if __name__ == "__main__":
    main()
