"""A frozen copy of the port's seeded LiDAR-like scan generator
(``spconv_tpu_torch/benchmark/basic.py::synthetic_scan`` and its two
surface samplers, copied unchanged), so that no later change to the
program can move the benchmark's inputs.

Returns voxels in ascending key order, ``(voxels [n, 3] f32, coors [n, 4]
int32 (batch 0, z, y, x), shape)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

BASIC_SHAPE = (80, 1600, 1600)
BASIC_VOXELS = 125_562


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
