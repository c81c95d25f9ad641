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

__all__ = ["SparseConvTensor", "default_device", "expand_nd"]


def default_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device of a constructor or input builder: ``device`` when given,
    else the CUDA card.  With no device given and no CUDA available it
    raises ``RuntimeError``: the port's entry points run on the card unless
    the caller asks for the CPU (``device="cpu"``), and never fall back to
    it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")


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
    ``q_scale`` is the quantization scale of int8 features (a 0-d f32
    tensor, set by ``quantization.QuantizedSequential``), None otherwise;
    :meth:`replace_feature` and :meth:`shadow_copy` carry it.
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
        q_scale: Optional[torch.Tensor] = None,
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
        self.q_scale = q_scale

    @property
    def ndim(self) -> int:
        return self.indices.shape[1] - 1

    @property
    def valid_mask(self) -> torch.Tensor:
        """``[N]`` bool: active rows."""
        return self.indices[:, 0] >= 0

    def replace_feature(self, feature: torch.Tensor) -> "SparseConvTensor":
        """Shallow copy with ``feature`` in place of the features.  The new
        features must keep inactive rows at 0; use
        :meth:`replace_feature_masked` for ops where ``f(0) != 0``."""
        new = self.shadow_copy()
        new.features = feature
        return new

    def replace_feature_masked(self, feature: torch.Tensor
                               ) -> "SparseConvTensor":
        """:meth:`replace_feature` that sets inactive rows back to 0."""
        return self.replace_feature(torch.where(
            self.valid_mask[:, None], feature, torch.zeros_like(feature)))

    @property
    def overflowed(self) -> Optional[torch.Tensor]:
        """0-d device bool: the bounded op that made this tensor dropped
        output sites (``num_out_total > num_voxels``).  None when no
        bounded discovery made it.  Reading it needs no sync."""
        if self.num_out_total is None:
            return None
        return self.num_out_total > self.num_voxels

    def check_overflow(self, context: str = "") -> None:
        """Raise ``ValueError`` if the producing op's ``out_bound`` cut the
        active set.  Reads two counts on the host, so it syncs: call it
        once on a representative input after choosing bounds, not inside a
        served forward."""
        if self.num_out_total is None:
            return
        total, got = int(self.num_out_total), int(self.num_voxels)
        if total > got:
            raise ValueError(
                f"sparse op output overflowed its static out_bound"
                f"{' in ' + context if context else ''}: {total} active "
                f"sites produced, only {got} kept (buffer "
                f"{self.indices.shape[0]}). Raise out_bound / "
                f"out_bound_ratio on the producing layer.")

    def find_indice_pair(self, key: Optional[str]):
        if key is None:
            return None
        return self.indice_dict.get(key)

    def dense(self, channels_first: bool = True) -> torch.Tensor:
        """Densify to ``[B, C, *spatial]`` (``[B, *spatial, C]`` without
        ``channels_first``); inactive rows are dropped.  Sync-free: every
        inactive row writes one spare row past the grid, which is cut."""
        from .ops import coords as C

        keys, sentinel = C.linearize(self.indices, self.spatial_shape,
                                     self.batch_size)
        c = self.features.shape[1]
        flat = self.features.new_zeros((sentinel + 1, c))
        flat[keys.long()] = self.features
        res = flat[:sentinel].reshape(self.batch_size, *self.spatial_shape,
                                      c)
        if not channels_first:
            return res
        return res.permute(0, self.ndim + 1, *range(1, self.ndim + 1))

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
