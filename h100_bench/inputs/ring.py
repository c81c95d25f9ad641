"""The ring of request batches a cell cycles through.

The ring has ``ring`` slots of ``B = scans_per_request`` scans.  Scan
``q`` of the ring (``0 <= q < ring * B``) is transform ``q mod 8`` of the
8 rotations and mirrors of the square ``(y, x)`` grid about its centre,
applied to the base scan ``synthetic_scan(scan_seeds[q // 8])``; slot
``r`` holds scans ``r * B`` to ``r * B + B - 1``, so no scan repeats in
the ring, every seed sees the same scans and the same buffer sizes, and
``--seed`` draws only the order of the scans within each batch and, for
unsorted traffic, the order of the rows.  A base scan costs about a
second on the host at full size; each is made once and kept in
``h100_bench/.cache/scans/`` (a fixed directory inside the checkout), so
only a checkout's first run makes it.

Rows are batch-major.  ``row_order`` is ``"key_sorted"`` (ascending
linear key, what the port's own voxelizer hands over) or ``"shuffled"``
(the active rows in a seeded random order, as an unsorted voxelizer hands
them over).  The buffer is padded with inactive rows (indices -1,
features 0) to a multiple of ``bucket`` rows.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

import numpy as np

from .synthetic_scan import synthetic_scan

ROW_ORDERS = ("key_sorted", "shuffled")
CACHE = Path(__file__).resolve().parent.parent / ".cache" / "scans"


@dataclass
class Batch:
    """One request's input: ``features [nbuf, C]`` f32, ``indices [nbuf,
    4]`` int32 (batch, z, y, x; -1 rows at the tail), the active row count,
    the grid and the batch size."""

    features: np.ndarray
    indices: np.ndarray
    n_active: int
    shape: List[int]
    batch_size: int
    keys_sorted: bool


def dihedral(coors: np.ndarray, feats: np.ndarray, t: int, h: int, w: int):
    """Transform ``t`` (0-7) of the square grid about its centre: bit 0
    swaps y and x, bit 1 mirrors y, bit 2 mirrors x.  The position
    features (relative z, y, x about the grid centre) move with the
    coordinates."""
    if h != w:
        raise ValueError(f"the grid's y and x must be equal, got {h}, {w}")
    c, f = coors.copy(), feats.copy()
    if t & 1:
        c[:, [2, 3]] = c[:, [3, 2]]
        f[:, [1, 2]] = f[:, [2, 1]]
    if t & 2:
        c[:, 2] = h - 1 - c[:, 2]
        f[:, 1] = -f[:, 1]
    if t & 4:
        c[:, 3] = w - 1 - c[:, 3]
        f[:, 2] = -f[:, 2]
    return c, f


@functools.lru_cache(maxsize=8)
def base_scan(seed: int, shape: tuple, n: int):
    """``synthetic_scan(seed, shape, n)``'s voxels and coordinates, read
    from the checkout's cache, or made and written there."""
    path = CACHE / (f"scan-{seed}-" + "x".join(map(str, shape))
                    + f"-{n}.npz")
    if path.exists():
        with np.load(path) as z:
            voxels, coors = z["voxels"], z["coors"]
    else:
        voxels, coors, _ = synthetic_scan(seed, list(shape), n)
        CACHE.mkdir(parents=True, exist_ok=True)
        part = path.with_name(path.stem + "-part.npz")
        np.savez(part, voxels=voxels, coors=coors)
        os.replace(part, path)
    voxels.flags.writeable = False
    coors.flags.writeable = False
    return voxels, coors


def _keys(coors: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    key = coors[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * int(s) + coors[:, a + 1]
    return key


def make_ring(*, grid: Sequence[int], voxels_per_scan: int,
              in_channels: int, feature_fill: Sequence[float],
              ring: int, scan_seeds: Sequence[int], scans_per_request: int,
              row_order: str, seed: int, bucket: int = 1024) -> List[Batch]:
    """The ring's batches (see the module docstring).  Features are the 3
    position features of the scan, then the constants ``feature_fill`` up
    to ``in_channels`` columns."""
    if row_order not in ROW_ORDERS:
        raise ValueError(f"row_order must be one of {ROW_ORDERS}")
    if len(feature_fill) != in_channels - 3:
        raise ValueError("feature_fill must fill the columns after the 3 "
                         "position features")
    b = int(scans_per_request)
    if len(scan_seeds) * 8 < int(ring) * b:
        raise ValueError(f"{ring} slots of {b} scans need "
                         f"{-(-int(ring) * b // 8)} base scans, "
                         f"{len(scan_seeds)} given")
    shape = [int(s) for s in grid]
    slots = []
    for r in range(int(ring)):
        rng = np.random.default_rng([int(seed) % 2**63, r])
        order = rng.permutation(b)
        parts_c, parts_f = [], []
        for j in range(b):
            q = r * b + int(order[j])
            voxels, coors = base_scan(int(scan_seeds[q // 8]), tuple(shape),
                                      int(voxels_per_scan))
            c, f = dihedral(coors, voxels, q % 8, shape[1], shape[2])
            c[:, 0] = j
            parts_c.append(c)
            parts_f.append(f)
        c = np.concatenate(parts_c)
        f = np.concatenate(parts_f)
        if row_order == "key_sorted":
            perm = np.argsort(_keys(c, shape), kind="stable")
        else:
            perm = rng.permutation(c.shape[0])
        c, f = c[perm], f[perm]
        n = c.shape[0]
        nbuf = max(bucket, -(-n // bucket) * bucket)
        feats = np.zeros((nbuf, in_channels), np.float32)
        feats[:n, :3] = f
        for k, v in enumerate(feature_fill):
            feats[:n, 3 + k] = v
        inds = np.full((nbuf, 4), -1, np.int32)
        inds[:n] = c
        slots.append(Batch(feats, inds, n, shape, b,
                           row_order == "key_sorted"))
    return slots
