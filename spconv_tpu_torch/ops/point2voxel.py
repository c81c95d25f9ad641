"""Point-cloud voxelization (counterpart of
``spconv_tpu/ops/point2voxel.py``).

Quantize -> linearize -> one stable sort -> segment starts -> each voxel's
run of points gathered into a ``[M, maxpts, C]`` buffer.  The
outputs are static-size buffers (``max_num_voxels`` /
``max_num_points_per_voxel``); ``num_voxels`` is a 0-d device tensor, so the
function reads nothing back to the host.

The user passes ``vsize_xyz`` / ``coors_range_xyz`` in XYZ order; the voxel
coordinates come out in **ZYX** order, ready to be prefixed with a batch
index for a :class:`SparseConvTensor`.  Voxels come out in ascending key
order (row-major over ZYX), so a tensor built from them is key-sorted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import coords as C

__all__ = ["point_to_voxel", "gather_features_by_pc_voxel_id"]


def grid_zyx(vsize_xyz: Sequence[float],
             coors_range_xyz: Sequence[float]) -> Tuple[int, ...]:
    """The voxel grid in ZYX order, ``round((upper - lower) / vsize)`` per
    axis, evaluated in f64 on the host as the JAX package does."""
    ndim = len(vsize_xyz)
    grid = np.round((np.array(coors_range_xyz[ndim:])
                     - np.array(coors_range_xyz[:ndim]))
                    / np.array(vsize_xyz)).astype(np.int64)
    return tuple(int(g) for g in grid[::-1])


def _consts(rows: Sequence[Sequence[float]],
            device: torch.device) -> torch.Tensor:
    """A small f32 table of constants on ``device`` in one copy: from
    pinned memory without blocking where ``device`` is the card (a copy
    from pageable memory would wait for the device)."""
    t = torch.tensor(rows, dtype=torch.float32)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def point_to_voxel(
    pc: torch.Tensor,
    *,
    vsize_xyz: Sequence[float],
    coors_range_xyz: Sequence[float],
    max_num_voxels: int,
    max_num_points_per_voxel: int,
    empty_mean: bool = False,
):
    """``pc`` ``[N, ndim+]`` (xyz first, then any extra features) ->
    ``(voxels [M, P, C] in pc's dtype, coords [M, ndim] ZYX int32 (-1 pad),
    num_per_voxel [M] int32, pc_voxel_id [N] int32 (-1 for dropped
    points), num_voxels 0-d int32)`` on ``pc``'s device.

    A point is kept where it lies in ``[lower, upper)`` on every axis (NaN
    and +-inf points are dropped) and its voxel is among the first
    ``max_num_voxels`` in key order; inside a voxel the first
    ``max_num_points_per_voxel`` points in input order are written.  With
    ``empty_mean`` the unfilled slots of a voxel take the mean of its
    points."""
    ndim = len(vsize_xyz)
    n, c = pc.shape
    m, p = int(max_num_voxels), int(max_num_points_per_voxel)
    dev = pc.device
    i32 = torch.int32
    grid = grid_zyx(vsize_xyz, coors_range_xyz)
    # rows: lower, upper, vsize (each rounded to f32 as the JAX package
    # does), the grid (exact in f32)
    lower, upper, vsize, grid_xyz = _consts(
        [coors_range_xyz[:ndim], coors_range_xyz[ndim:], vsize_xyz,
         grid[::-1]], dev)

    # quantize in f32 as (xyz - lower) / vsize, a true division; the range
    # test on the floats decides before any cast, so a NaN or +-inf point
    # never reaches the integer cast.  Inside the box q >= 0, and q < grid
    # compares integers exactly in f32
    xyz = pc[:, :ndim].float()
    in_box = ((xyz >= lower) & (xyz < upper)).all(dim=-1)
    q = torch.floor((xyz - lower) / vsize)
    in_range = in_box & (q < grid_xyz).all(dim=-1)
    vox_zyx = torch.where(in_box[:, None], q,
                          torch.zeros_like(q)).to(i32).flip(-1)

    # keys over a zero batch column: int32, or int64 on a grid past
    # _KEY32_LIMIT; one stable sort keeps first-come order inside a voxel
    pseudo = torch.cat([torch.zeros((n, 1), dtype=i32, device=dev),
                        vox_zyx], dim=-1)
    key, sentinel = C.linearize(pseudo, grid, 1, in_range)
    sk, order = C.sort_with_ids(key)
    not_sent = sk != sentinel
    is_first = torch.cat([not_sent[:1], (sk[1:] != sk[:-1]) & not_sent[1:]])
    vid = torch.cumsum(is_first, 0, dtype=i32) - 1
    total = is_first.sum(dtype=i32)

    if n == 0:
        # nothing to gather from: every buffer stays empty
        return (pc.new_zeros((m, p, c)), torch.full((m, ndim), -1, dtype=i32,
                                                    device=dev),
                torch.zeros(m, dtype=i32, device=dev), vid, total)

    # each voxel's points are one run of the sorted order: its start is
    # the first row whose voxel id reaches it, its end the next voxel's
    # start (the last voxel's, the valid rows' count); searches and
    # gathers, so no two writes meet
    vox = torch.arange(m + 1, dtype=i32, device=dev)
    bounds = torch.searchsorted(vid, vox)
    starts = bounds[:m]
    ends = torch.minimum(bounds[1:], not_sent.sum())
    num_per_voxel = (ends - starts).clamp(0, p).to(i32)

    # order is a permutation: every write is unique
    keep_voxel = (vid < m) & not_sent
    pc_voxel_id = torch.empty(n, dtype=i32, device=dev)
    pc_voxel_id[order] = torch.where(keep_voxel, vid, torch.full_like(vid, -1))

    slots = torch.arange(p, device=dev)
    filled = slots < num_per_voxel[:, None]
    rows = order[torch.where(filled, starts[:, None] + slots,
                             torch.zeros_like(filled, dtype=torch.int64))]
    voxels = torch.where(filled[..., None], pc[rows], pc.new_zeros(()))

    has = num_per_voxel > 0
    coords = torch.where(has[:, None], vox_zyx[rows[:, 0]],
                         torch.full_like(vox_zyx[:1], -1))

    if empty_mean:
        # slot by slot in order: the same sums on every device
        acc = voxels[:, 0]
        for s in range(1, p):
            acc = acc + voxels[:, s]
        mean = acc / num_per_voxel.clamp(min=1)[:, None].to(voxels.dtype)
        filled = (torch.arange(p, device=dev)[None, :, None]
                  < num_per_voxel[:, None, None])
        voxels = torch.where(filled, voxels, mean[:, None, :])

    return voxels, coords, num_per_voxel, pc_voxel_id, total.clamp(max=m)


def gather_features_by_pc_voxel_id(seg_res_features: torch.Tensor,
                                   pc_voxel_id: torch.Tensor,
                                   invalid_value=0) -> torch.Tensor:
    """Per-voxel rows mapped back to the points (``[N, ...]``): each point
    takes its voxel's row, a dropped point (id -1) ``invalid_value``."""
    g = seg_res_features[pc_voxel_id.clamp(min=0).long()]
    mask = (pc_voxel_id >= 0).reshape(
        (-1,) + (1,) * (seg_res_features.ndim - 1))
    fill = torch.full((), invalid_value, dtype=g.dtype, device=g.device)
    return torch.where(mask, g, fill)
