"""User-facing utilities (counterpart of ``spconv_tpu/utils``): the voxel
generator :class:`PointToVoxel` and its per-dimension aliases, box ops
(``boxops``) and the point-cloud codec (``pcc``)."""

from __future__ import annotations

from typing import Sequence

import torch

from ..core import default_device
from ..ops.point2voxel import (gather_features_by_pc_voxel_id, grid_zyx,
                               point_to_voxel)

__all__ = [
    "PointToVoxel",
    "Point2VoxelCPU1d", "Point2VoxelCPU2d", "Point2VoxelCPU3d",
    "Point2VoxelCPU4d",
    "Point2VoxelGPU1d", "Point2VoxelGPU2d", "Point2VoxelGPU3d",
    "Point2VoxelGPU4d",
    "gather_features_by_pc_voxel_id",
]


class PointToVoxel:
    """Voxel generator with the JAX package's constructor and calls
    (:func:`~spconv_tpu_torch.ops.point2voxel.point_to_voxel` with this
    generator's parameters).  Its buffers live on ``default_device(device)``
    (the CUDA card unless the caller passes one); a numpy array or a tensor
    on another device is moved there.  ``grid_size`` is ZYX.

    It returns static-size buffers and a ``num_voxels`` 0-d device tensor:
    use it (or the -1 padding of ``coords``) instead of slicing, so that no
    host read is forced."""

    def __init__(
        self,
        vsize_xyz: Sequence[float],
        coors_range_xyz: Sequence[float],
        num_point_features: int,
        max_num_voxels: int,
        max_num_points_per_voxel: int,
        device=None,
    ):
        self.ndim = len(vsize_xyz)
        self.vsize_xyz = tuple(float(v) for v in vsize_xyz)
        self.coors_range_xyz = tuple(float(v) for v in coors_range_xyz)
        self.num_point_features = num_point_features
        self.max_num_voxels = max_num_voxels
        self.max_num_points_per_voxel = max_num_points_per_voxel
        self.device = default_device(device)
        self.grid_size = grid_zyx(self.vsize_xyz, self.coors_range_xyz)

    def __call__(self, pc, clear_voxels: bool = True,
                 empty_mean: bool = False):
        """``(voxels, coords, num_per_voxel)``."""
        v, c, n, _, _ = self.generate_voxel_with_id(pc, clear_voxels,
                                                    empty_mean)
        return v, c, n

    def generate_voxel_with_id(self, pc, clear_voxels: bool = True,
                               empty_mean: bool = False):
        """``(voxels, coords, num_per_voxel, pc_voxel_id, num_voxels)``.
        ``clear_voxels`` is accepted for the reference's signature: the
        buffers are made anew on every call."""
        del clear_voxels
        return point_to_voxel(
            torch.as_tensor(pc).to(self.device),
            vsize_xyz=self.vsize_xyz,
            coors_range_xyz=self.coors_range_xyz,
            max_num_voxels=self.max_num_voxels,
            max_num_points_per_voxel=self.max_num_points_per_voxel,
            empty_mean=empty_mean,
        )


# the reference's per-dimension CPU / GPU classes; one implementation serves
# them all
Point2VoxelCPU1d = Point2VoxelCPU2d = Point2VoxelCPU3d = Point2VoxelCPU4d = \
    PointToVoxel
Point2VoxelGPU1d = Point2VoxelGPU2d = Point2VoxelGPU3d = Point2VoxelGPU4d = \
    PointToVoxel
