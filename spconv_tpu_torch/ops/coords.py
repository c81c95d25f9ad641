"""Coordinate math (counterpart of ``spconv_tpu/ops/coords.py``).

Keys are batch-major and row-major over the spatial axes.  Invalid rows take
the key ``prod(spatial_shape) * batch_size``, which sorts after every valid
key.  A grid whose ``batch * volume`` stays below ``_KEY32_LIMIT`` (2**31 -
1) has int32 keys; a larger one has one int64 key per row, the JAX
package's two-word ``(hi, lo)`` key read as one number (``hi * lo_prod +
lo``, which is the same row-major key), so the two sort alike.  The
dynamic-gather and sorted-key kernels take int32 keys only: a large grid
takes the native rulebook path (``ops/rulebook.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "get_conv_output_size",
    "get_deconv_output_size",
    "kernel_offsets",
    "use_int64_keys",
    "grid_sentinel",
    "linearize",
    "delinearize",
    "sort_with_ids",
]

# Grids whose batch * volume reaches this have int64 keys.  Module-level, so
# that tests can lower it to take the int64 path on small grids.
_KEY32_LIMIT = 2**31 - 1
# the JAX package's two-word keys: the trailing spatial axes whose product
# stays below this go to the low word, the rest and the batch to the high
# word, which must stay below 2**31 - 1
_LO_LIMIT = 2**30


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


def get_deconv_output_size(
    input_size: Sequence[int],
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    output_padding: Sequence[int],
) -> List[int]:
    """Transposed-conv output size ``(in - 1) * s - 2p + k +
    output_padding`` per axis.  Like the JAX package's (and the
    reference's), it has no dilation term: at dilation > 1 the candidates
    past the grid are dropped."""
    out = []
    for i in range(len(input_size)):
        if kernel_size[i] == -1:
            raise ValueError("deconv doesn't support kernel_size < 0")
        out.append(int((input_size[i] - 1) * stride[i] - 2 * padding[i]
                       + kernel_size[i] + output_padding[i]))
    return out


def kernel_offsets(ksize: Sequence[int]) -> np.ndarray:
    """``[kv, ndim]`` kernel offsets, row-major over the kernel dims (the
    ``'ij'`` meshgrid order).  This order fixes which slice of a KRSC weight
    belongs to which offset."""
    grids = np.meshgrid(*[np.arange(k) for k in ksize], indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


def use_int64_keys(spatial_shape: Sequence[int], batch_size: int) -> bool:
    """True when the grid's keys are int64: ``batch * volume`` reaches
    ``_KEY32_LIMIT`` (the JAX package's ``use_pair_keys``)."""
    vol = int(np.prod([int(s) for s in spatial_shape])) * int(batch_size)
    return vol >= _KEY32_LIMIT


def _check_key_capacity(shape: Sequence[int], batch_size: int) -> None:
    """Raises where the JAX package's ``_split_dims`` raises: the high word
    of its two-word key, the batch times the leading axes that do not fit
    the low word, reaches 2**31 - 1."""
    shape = [int(s) for s in shape]
    lo, cut = 1, len(shape)
    while cut > 0 and lo * shape[cut - 1] < _LO_LIMIT:
        lo *= shape[cut - 1]
        cut -= 1
    if int(batch_size) * int(np.prod(shape[:cut], dtype=np.int64)) \
            >= 2**31 - 1:
        raise NotImplementedError(
            f"grid batch*{tuple(shape)} exceeds two-word int32 key capacity "
            "(~2^61 sites)")


def grid_sentinel(spatial_shape: Sequence[int], batch_size: int) -> int:
    """The invalid-row key, ``batch * volume``; raises where the JAX
    package's keys run out (:func:`_check_key_capacity`)."""
    if use_int64_keys(spatial_shape, batch_size):
        _check_key_capacity(spatial_shape, batch_size)
    return int(np.prod([int(s) for s in spatial_shape])) * int(batch_size)


def linearize(
    indices: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """``[N, ndim+1]`` batch-first coordinates -> (``[N]`` keys, sentinel),
    int32 keys, or int64 on a grid of :func:`use_int64_keys`.  Rows that
    are not ``valid`` (default: ``indices[:,0] < 0``) take the sentinel."""
    shape = [int(s) for s in spatial_shape]
    sentinel = grid_sentinel(shape, batch_size)
    if valid is None:
        valid = indices[:, 0] >= 0
    # int64 arithmetic so that rows about to be masked cannot overflow
    key = indices[:, 0].long()
    for i, s in enumerate(shape):
        key = key * s + indices[:, i + 1].long()
    key = torch.where(valid, key, torch.full_like(key, sentinel))
    return (key if use_int64_keys(shape, batch_size) else key.int()), sentinel


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


def sort_with_ids(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted keys, order)``: a stable ascending sort, so rows of equal
    keys keep their order (the JAX package's ``sort_with_ids``; the pool
    rulebook's slot order depends on it).  ``order`` is int64."""
    return torch.sort(keys, stable=True)
