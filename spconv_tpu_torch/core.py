"""SparseConvTensor for the PyTorch port (counterpart of
``spconv_tpu/core.py``).

A ``[N, C]`` feature matrix plus a ``[N, ndim+1]`` int32 coordinate matrix
(batch index first), a dense ``spatial_shape``, ``batch_size`` and an
``indice_dict`` cache keyed by ``indice_key``.  The buffers are padded to a
fixed ``N``: row ``i`` is active iff ``indices[i, 0] >= 0``, and inactive rows
carry indices of -1 and features of 0.  Every op of the port keeps that
invariant.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["SparseConvTensor", "expand_nd"]


def expand_nd(ndim: int, val: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    """Broadcast a scalar conv parameter to ``ndim`` dims."""
    if isinstance(val, (int, np.integer)):
        return (int(val),) * ndim
    val = tuple(int(v) for v in val)
    if len(val) != ndim:
        raise ValueError(f"expected length {ndim}, got {val}")
    return val


class SparseConvTensor:
    """Sparse tensor on static buffers; see the module docstring.

    ``keys_sorted`` states that rows are ordered by linearized coordinate
    key (batch-major, row-major spatial; invalid rows at the tail).  The
    dynamic-gather conv requires it.  ``num_voxels`` and ``num_out_total``
    are 0-d device tensors, so reading them never syncs inside a forward.
    """

    def __init__(
        self,
        features: torch.Tensor,
        indices: torch.Tensor,
        spatial_shape: Sequence[int],
        batch_size: int,
        num_voxels: Optional[torch.Tensor] = None,
        indice_dict: Optional[Dict[str, Any]] = None,
        keys_sorted: bool = False,
        num_out_total: Optional[torch.Tensor] = None,
    ):
        if features.ndim != 2:
            raise ValueError("features must be [N, C]")
        if indices.ndim != 2:
            raise ValueError("indices must be [N, ndim+1]")
        if len(spatial_shape) != indices.shape[1] - 1:
            raise ValueError("spatial shape must have ndim entries")
        self.features = features
        self.indices = indices
        self.spatial_shape = tuple(int(s) for s in spatial_shape)
        self.batch_size = int(batch_size)
        if num_voxels is None:
            num_voxels = (indices[:, 0] >= 0).sum(dtype=torch.int32)
        self.num_voxels = num_voxels
        self.indice_dict: Dict[str, Any] = (
            {} if indice_dict is None else indice_dict)
        self.keys_sorted = bool(keys_sorted)
        # pre-clamp output count of the bounded op that made this tensor
        # (None when no bounded discovery ran); num_out_total > num_voxels
        # means the op dropped sites
        self.num_out_total = num_out_total

    @property
    def ndim(self) -> int:
        return self.indices.shape[1] - 1

    @property
    def valid_mask(self) -> torch.Tensor:
        """``[N]`` bool: active rows."""
        return self.indices[:, 0] >= 0

    def find_indice_pair(self, key: Optional[str]):
        if key is None:
            return None
        return self.indice_dict.get(key)

    def sort_by_key(self) -> "SparseConvTensor":
        """Reorder rows by linearized coordinate and set ``keys_sorted``.
        Drops the cached match tables (row ids change)."""
        from .ops import coords as C

        keys, _ = C.linearize(self.indices, self.spatial_shape,
                              self.batch_size)
        order = torch.sort(keys, stable=True).indices
        return SparseConvTensor(
            self.features[order], self.indices[order], self.spatial_shape,
            self.batch_size, num_voxels=self.num_voxels, keys_sorted=True)

    def shadow_copy(self) -> "SparseConvTensor":
        """Shallow copy with its own ``indice_dict``."""
        new = object.__new__(SparseConvTensor)
        new.__dict__.update(self.__dict__)
        new.indice_dict = dict(self.indice_dict)
        return new

    def __repr__(self):
        return (f"SparseConvTensor[shape={tuple(self.features.shape)}, "
                f"spatial={self.spatial_shape}, batch={self.batch_size}]")
