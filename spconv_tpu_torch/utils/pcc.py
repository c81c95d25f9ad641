"""Point-cloud compression (the port's own copy of
``spconv_tpu/utils/pcc.py``, which writes the same bytes): lossy XYZ_8 /
XYZI_8 per-voxel delta encoding.  Points are bucketed into coarse voxels,
each point stored as its voxel id plus int8 offsets from the voxel centre.

A host codec in numpy: compression belongs to the data pipeline and
storage, not to the card, as in the reference, whose codec is CPU C++."""

from __future__ import annotations

import io
import struct
from enum import Enum

import numpy as np

__all__ = ["EncodeType", "encode_xyz", "decode_xyz"]

_MAGIC = b"SPTC"


class EncodeType(Enum):
    XYZ_8 = 0
    XYZI_8 = 1


def encode_xyz(points: np.ndarray, error: float = 0.02,
               encode_type: EncodeType = None) -> bytes:
    """Compress [N, 3] (XYZ_8) or [N, 4] (XYZI_8, intensity kept f32).

    ``error``: max absolute coordinate error; voxel size = 255·error so the
    int8 offset resolution equals the error bound."""
    points = np.asarray(points, np.float32)
    n, c = points.shape
    if encode_type is None:
        encode_type = EncodeType.XYZ_8 if c == 3 else EncodeType.XYZI_8
    xyz = points[:, :3]
    vsize = 255.0 * error
    vmin = xyz.min(0) if n else np.zeros(3, np.float32)
    vox = np.floor((xyz - vmin) / vsize).astype(np.int64)
    center = vmin + (vox + 0.5) * vsize
    off = np.clip(np.round((xyz - center) / error), -127, 127).astype(np.int8)

    # group by voxel
    dims = vox.max(0) + 1 if n else np.ones(3, np.int64)
    key = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, counts = np.unique(key_s, return_counts=True)

    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<iiffff", encode_type.value, n, error,
                          *vmin.tolist()))
    buf.write(struct.pack("<qqq", *dims.tolist()))
    buf.write(struct.pack("<i", len(uniq)))
    buf.write(uniq.astype(np.int64).tobytes())
    buf.write(counts.astype(np.int32).tobytes())
    buf.write(off[order].tobytes())
    if encode_type == EncodeType.XYZI_8:
        buf.write(points[order, 3].astype(np.float32).tobytes())
    return buf.getvalue()


def decode_xyz(data: bytes) -> np.ndarray:
    buf = io.BytesIO(data)
    if buf.read(4) != _MAGIC:
        raise ValueError("not a spconv_tpu pcc stream")
    etype, n, error, mx, my, mz = struct.unpack("<iiffff", buf.read(24))
    dims = np.array(struct.unpack("<qqq", buf.read(24)), np.int64)
    (nv,) = struct.unpack("<i", buf.read(4))
    uniq = np.frombuffer(buf.read(8 * nv), np.int64)
    counts = np.frombuffer(buf.read(4 * nv), np.int32)
    off = np.frombuffer(buf.read(3 * n), np.int8).reshape(n, 3)
    vmin = np.array([mx, my, mz], np.float32)
    vsize = 255.0 * error

    vox_ids = np.repeat(uniq, counts)
    vz = vox_ids // (dims[1] * dims[2])
    vy = (vox_ids // dims[2]) % dims[1]
    vx = vox_ids % dims[2]
    vox = np.stack([vz, vy, vx], 1)
    center = vmin + (vox + 0.5) * vsize
    xyz = center + off.astype(np.float32) * error
    if etype == EncodeType.XYZI_8.value:
        inten = np.frombuffer(buf.read(4 * n), np.float32)
        return np.concatenate([xyz, inten[:, None]], 1).astype(np.float32)
    return xyz.astype(np.float32)
