"""The reference benchmark net (counterpart of
``spconv_tpu/benchmark/basic.py``): 14 ``SubMConv3d``
(3->64->64->96->96->128->128->160->160->192->192->224->224->256->256,
``bias=False``, paired by ``indice_key`` ``c0``..``c6``) with 6
``SparseMaxPool3d(2, 2)`` between the pairs, on a key-sorted scan on an
``[80, 1600, 1600]`` grid.

The reference's real 125,562-voxel scan is not in the repository, so
:func:`synthetic_scan` makes a deterministic LiDAR-like scan from a seed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import SparseConvTensor
from ..modules import SparseMaxPool3d, SubMConv3d

__all__ = [
    "CHANNELS",
    "BenchNet",
    "make_bench_input",
    "measure_pool_bounds",
    "synthetic_scan",
    "matched_offsets_per_voxel",
]

CHANNELS = (3, 64, 64, 96, 96, 128, 128, 160, 160, 192, 192, 224, 224, 256,
            256)
BASIC_SHAPE = (80, 1600, 1600)
BASIC_VOXELS = 125_562


def _round_bucket(n: int, mult: int = 1024) -> int:
    return max(mult, -(-n // mult) * mult)


class BenchNet(nn.Module):
    """The benchmark net with per-stage static pool buffers
    (``pool_bounds``; None sizes each pool's buffer to its input's).
    Attribute names (``convs``, ``pools``) match the JAX package's, so its
    state dict loads one to one.  Weights are drawn from ``seed``."""

    def __init__(self, shape: Sequence[int], dtype: torch.dtype = torch.float32,
                 pool_bounds: Optional[Sequence[int]] = None,
                 algo: Optional[str] = None,
                 device: Optional[torch.device] = None, seed: int = 0):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        gen = torch.Generator().manual_seed(seed)
        self.convs = nn.ModuleList(
            SubMConv3d(CHANNELS[i], CHANNELS[i + 1], 3, bias=False,
                       indice_key=f"c{i // 2}", algo=algo, dtype=dtype,
                       device=device, generator=gen)
            for i in range(14))
        self.pool_bounds = tuple(pool_bounds) if pool_bounds else None
        self.pools = nn.ModuleList(
            SparseMaxPool3d(2, 2, out_bound=(self.pool_bounds[i]
                                             if self.pool_bounds else None),
                            out_bound_ratio=1.0)
            for i in range(6))

    def forward_stages(self, x: SparseConvTensor) -> List[SparseConvTensor]:
        """The output of each conv pair (stages ``c0``..``c6``); the last
        one is the net's output."""
        stages = []
        for stage in range(7):
            if stage:
                x = self.pools[stage - 1](x)
            x = self.convs[2 * stage](x)
            x = self.convs[2 * stage + 1](x)
            stages.append(x)
        return stages

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        return self.forward_stages(x)[-1]


def make_bench_input(voxels: np.ndarray, coors: np.ndarray,
                     spatial_shape: Sequence[int],
                     dtype: torch.dtype = torch.float32, bucket: int = 1024,
                     device: Optional[torch.device] = None
                     ) -> SparseConvTensor:
    """Sort the voxels by key, pad to a multiple of ``bucket`` rows and
    flag the tensor ``keys_sorted``."""
    n = voxels.shape[0]
    nbuf = _round_bucket(n, bucket)
    shape = [int(s) for s in spatial_shape]
    key = coors[:, 0].astype(np.int64)
    for i, s in enumerate(shape):
        key = key * s + coors[:, i + 1]
    order = np.argsort(key, kind="stable")
    feats = np.zeros((nbuf, voxels.shape[1]), np.float32)
    feats[:n] = voxels[order]
    inds = np.full((nbuf, coors.shape[1]), -1, np.int32)
    inds[:n] = coors[order]
    return SparseConvTensor(
        torch.from_numpy(feats).to(device=device, dtype=dtype),
        torch.from_numpy(inds).to(device=device), shape, 1,
        keys_sorted=True)


@torch.no_grad()
def measure_pool_bounds(shape: Sequence[int],
                        x: SparseConvTensor) -> List[int]:
    """One eager pass that sizes each pool's buffer: its active count
    plus 5 %, rounded up to 512.  The buffer of the next stage shrinks to
    that bound."""
    net = BenchNet(shape, dtype=x.features.dtype, device=x.features.device)
    bounds = []
    for stage in range(6):
        x = net.convs[2 * stage](x)
        x = net.convs[2 * stage + 1](x)
        x = net.pools[stage](x)
        b = _round_bucket(int(int(x.num_voxels) * 1.05), 512)
        bounds.append(b)
        # pool output is key-ordered with its invalid rows at the tail, so
        # the truncated buffer stays sorted
        x = SparseConvTensor(x.features[:b], x.indices[:b], x.spatial_shape,
                             x.batch_size, keys_sorted=True)
    return bounds


def matched_offsets_per_voxel(stage_out: SparseConvTensor,
                              indice_key: str = "c0") -> float:
    """Mean number of kernel offsets with a match per active voxel, read
    from the stage's cached match table."""
    pos = stage_out.indice_dict[indice_key].pos
    return float((pos >= 0).sum()) / max(1, int(stage_out.num_voxels))


# ---------------------------------------------------------------------------
# synthetic LiDAR-like scan
# ---------------------------------------------------------------------------

def _box_surface(rng, n, centre, size, yaw):
    """``n`` points uniform by area on the 4 sides and the top of a box
    standing on its base; ``centre`` = (z_base, y, x), ``size`` =
    (height, length, width)."""
    h, ln, wd = size
    areas = np.array([ln * h, ln * h, wd * h, wd * h, ln * wd])
    face = rng.choice(5, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(0.0, 1.0, n)
    along = np.where(face < 2, u * ln, np.where(face < 4, np.where(
        face == 2, 0.5, -0.5) * ln, u * ln))
    across = np.where(face < 2, np.where(face == 0, 0.5, -0.5) * wd,
                      np.where(face < 4, u * wd,
                               rng.uniform(-0.5, 0.5, n) * wd))
    up = np.where(face < 4, v * h, h)
    c, s = np.cos(yaw), np.sin(yaw)
    y = centre[1] + c * along - s * across
    x = centre[2] + s * along + c * across
    return np.stack([centre[0] + up, y, x], axis=1)


def _pole_surface(rng, n, centre, radius, height):
    t = rng.uniform(0, 2 * np.pi, n)
    return np.stack([centre[0] + rng.uniform(0, height, n),
                     centre[1] + radius * np.sin(t),
                     centre[2] + radius * np.cos(t)], axis=1)


def synthetic_scan(seed: int = 0, shape: Sequence[int] = BASIC_SHAPE,
                   n_target: int = BASIC_VOXELS
                   ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """A deterministic LiDAR-like scan with exactly ``n_target`` voxels
    (fewer only if the grid cannot hold them).

    The scene, in voxel units of a ``(z, y, x)`` grid (0.1 m voxels at the
    default shape): a ground surface with a smooth height field, boxes
    (cars), poles and long walls standing on it, and a sensor at the grid
    centre 1.7 m above the ground.  Points fall on the surfaces with a
    density that decays with range r from the sensor: as 1/r**4 on the
    ground and 1/r**3 on surfaces facing the sensor (a single LiDAR sweep
    decays as 1/r**3 on the ground; the steeper law keeps the voxel budget
    on a connected surface near the sensor rather than spreading it as dust
    over the far field).  A random stream of points is voxelized and cut
    where it has hit ``n_target`` distinct voxels.  Features (3 channels) are each
    voxel's mean point position relative to the sensor, scaled to about
    [-1, 1].

    Returns ``(voxels [n, 3] f32, coors [n, 4] int32 (batch 0, z, y, x),
    shape)``.
    """
    d, h, w = (int(s) for s in shape)
    rng = np.random.default_rng(seed)
    s = w / 1600.0  # object sizes scale with the grid
    cy, cx = h / 2.0, w / 2.0
    waves = [(rng.uniform(0.6, 2.5), rng.uniform(0, 2 * np.pi),
              rng.uniform(0, 2 * np.pi), d * rng.uniform(0.01, 0.04))
             for _ in range(4)]
    z0 = 0.3 * d

    def ground(y, x):
        z = np.full(np.shape(y), z0)
        for f, a, p, amp in waves:
            z = z + amp * np.sin(2 * np.pi * f * (np.cos(a) * y / h
                                                  + np.sin(a) * x / w) + p)
        return z

    h_sensor = max(2.0, 17.0 * s)
    z_sensor = float(ground(cy, cx)) + h_sensor
    r_min, r_max = 0.02 * w, 0.49 * min(h, w)
    inv_sq_span = r_min ** -2 - r_max ** -2

    # objects: (kind, centre (z_base, y, x), dims, yaw, range)
    objects = []
    for kind, count, rlo in (("car", 40, 0.04), ("pole", 60, 0.04),
                             ("wall", 4, 0.1)):
        for _ in range(count):
            r = rng.uniform(rlo, 0.45) * w
            t = rng.uniform(0, 2 * np.pi)
            y, x = cy + r * np.sin(t), cx + r * np.cos(t)
            base = float(ground(y, x))
            if kind == "car":
                dims = (max(2.0, 16 * s), max(3.0, 45 * s), max(2.0, 20 * s))
                yaw = rng.uniform(0, np.pi)
            elif kind == "pole":
                dims = (min(0.9 * d - base, max(3.0, 60 * s)),
                        max(1.0, 1.5 * s))
                yaw = 0.0
            else:
                dims = (min(0.9 * d - base, max(3.0, 50 * s)),
                        rng.uniform(100, 300) * s, max(2.0, 3 * s))
                yaw = t + np.pi / 2  # facing the sensor
            objects.append((kind, (base, y, x), dims, yaw, r))

    m = 4 * n_target
    while True:
        # ground: areal density ~ 1/r**4, i.e. r with pdf ~ r**-3
        t = rng.uniform(0, 2 * np.pi, m)
        r = (r_min ** -2 - rng.uniform(0, 1, m) * inv_sq_span) ** -0.5
        gy, gx = cy + r * np.sin(t), cx + r * np.cos(t)
        parts = [np.stack([ground(gy, gx), gy, gx], axis=1)]
        # a surface facing the sensor is hit head-on, not at the grazing
        # angle h_sensor / r of the ground: r / h_sensor times the ground's
        # density m / (pi inv_sq_span r**4)
        for kind, centre, dims, yaw, rng_r in objects:
            if kind == "pole":
                area = 2 * np.pi * dims[1] * dims[0]
            else:
                hh, ln, wd = dims
                area = 2 * (ln + wd) * hh + ln * wd
            k = rng.poisson(area * m / (np.pi * inv_sq_span * h_sensor
                                        * rng_r ** 3))
            if kind == "pole":
                parts.append(_pole_surface(rng, k, centre, dims[1], dims[0]))
            else:
                parts.append(_box_surface(rng, k, centre, dims, yaw))
        pts = np.concatenate(parts)
        pts += rng.normal(0, 0.3, pts.shape)  # range noise
        pts = pts[rng.permutation(len(pts))]
        vox = np.floor(pts).astype(np.int64)
        inside = np.all((vox >= 0) & (vox < np.array([d, h, w])), axis=1)
        pts, vox = pts[inside], vox[inside]
        lin = (vox[:, 0] * h + vox[:, 1]) * w + vox[:, 2]
        uniq, first = np.unique(lin, return_index=True)
        if len(uniq) >= n_target or m >= 64 * n_target:
            break
        m *= 2

    n = min(n_target, len(uniq))
    cut = np.sort(first)[n - 1] + 1  # stream prefix that hits n voxels
    lin, pts = lin[:cut], pts[:cut]
    uniq, inv = np.unique(lin, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    rel = (pts - np.array([z_sensor, cy, cx])) / np.array([d, h / 2, w / 2])
    voxels = np.stack([np.bincount(inv, weights=rel[:, a],
                                   minlength=len(uniq)) / cnt
                       for a in range(3)], axis=1).astype(np.float32)
    coors = np.zeros((len(uniq), 4), np.int32)
    coors[:, 1] = uniq // (h * w)
    coors[:, 2] = (uniq // w) % h
    coors[:, 3] = uniq % w
    return voxels, coors, [d, h, w]
