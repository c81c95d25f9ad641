"""Coordinate math (counterpart of ``spconv_tpu/ops/coords.py``).

Keys are batch-major and row-major over the spatial axes.  Invalid rows take
the key ``prod(spatial_shape) * batch_size``, which sorts after every valid
key.  Only single-word int32 keys are ported: a grid whose
``batch * volume`` reaches 2**31 raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "get_conv_output_size",
    "kernel_offsets",
    "grid_sentinel",
    "linearize",
    "delinearize",
]

_KEY32_LIMIT = 2**31 - 1


def get_conv_output_size(
    input_size: Sequence[int],
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
) -> List[int]:
    """Standard conv output size, with the ksize == -1 (global) convention."""
    out = []
    for i in range(len(input_size)):
        if kernel_size[i] == -1:
            out.append(1)
        else:
            out.append(int((input_size[i] + 2 * padding[i]
                            - dilation[i] * (kernel_size[i] - 1) - 1)
                           // stride[i] + 1))
    return out


def kernel_offsets(ksize: Sequence[int]) -> np.ndarray:
    """``[kv, ndim]`` kernel offsets, row-major over the kernel dims (the
    ``'ij'`` meshgrid order).  This order fixes which slice of a KRSC weight
    belongs to which offset."""
    grids = np.meshgrid(*[np.arange(k) for k in ksize], indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


def grid_sentinel(spatial_shape: Sequence[int], batch_size: int) -> int:
    """The invalid-row key; raises for grids beyond single-word keys."""
    vol = int(np.prod([int(s) for s in spatial_shape])) * int(batch_size)
    if vol >= _KEY32_LIMIT:
        raise NotImplementedError(
            f"grid batch*{tuple(spatial_shape)} needs two-word keys, which "
            "the port does not have yet (ROADMAP A3: one int64 key)")
    return vol


def linearize(
    indices: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """``[N, ndim+1]`` batch-first coordinates -> (``[N]`` int32 keys,
    sentinel).  Rows that are not ``valid`` (default: ``indices[:,0] < 0``)
    take the sentinel."""
    shape = [int(s) for s in spatial_shape]
    sentinel = grid_sentinel(shape, batch_size)
    if valid is None:
        valid = indices[:, 0] >= 0
    # int64 arithmetic so that rows about to be masked cannot overflow
    key = indices[:, 0].long()
    for i, s in enumerate(shape):
        key = key * s + indices[:, i + 1].long()
    key = torch.where(valid, key, torch.full_like(key, sentinel))
    return key.int(), sentinel


def delinearize(keys: torch.Tensor, spatial_shape: Sequence[int],
                valid: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`linearize` -> ``[N, ndim+1]`` int32, -1 where not
    ``valid``."""
    coords = []
    rem = keys.long()
    for s in reversed([int(s) for s in spatial_shape]):
        coords.append(rem % s)
        rem = rem // s
    coords.append(rem)
    out = torch.stack(coords[::-1], dim=-1).int()
    return torch.where(valid[:, None], out, torch.full_like(out, -1))
