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

__all__ = ["SparseConvTensor", "IndiceData", "ImplicitGemmIndiceData",
           "default_device", "expand_nd", "scatter_nd"]


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


def scatter_nd(indices: torch.Tensor, updates: torch.Tensor,
               shape: Sequence[int]) -> torch.Tensor:
    """TF-style scatter_nd: a zero tensor of ``shape`` whose entries at
    ``indices`` (``[..., d]``, the leading ``d`` axes of ``shape``) take
    ``updates`` (``[..., *shape[d:]]``).  A negative index counts from the
    end of its axis, as in the JAX package; what still lies outside
    ``shape`` is dropped.  Where two indices are equal, one of the writes
    wins.  Reads nothing back to the host."""
    shape = tuple(int(s) for s in shape)
    d = indices.shape[-1]
    lead, rest = shape[:d], shape[d:]
    idx = indices.reshape(-1, d).long()
    flat = torch.zeros_like(idx[:, 0])
    ok = torch.ones_like(idx[:, 0], dtype=torch.bool)
    for a, s in enumerate(lead):
        i = torch.where(idx[:, a] < 0, idx[:, a] + s, idx[:, a])
        ok &= (i >= 0) & (i < s)
        flat = flat * s + i
    n = int(np.prod(lead, dtype=np.int64))
    # every dropped write lands on one spare row past the end, cut below
    flat = torch.where(ok, flat, torch.full_like(flat, n))
    out = updates.new_zeros((n + 1, *rest))
    out[flat] = updates.reshape(-1, *rest)
    return out[:n].reshape(shape)


class IndiceData:
    """Rulebook record of the native path (the JAX package's
    ``IndiceData``, built by ``ops.rulebook``):

    * ``pair_fwd`` ``[kv, N_out]`` int32: the input row feeding output ``o``
      through offset ``k``, or -1;
    * ``pair_bwd`` ``[kv, N_in]`` int32: the output row fed by input ``i``
      through offset ``k``, or -1 (a subm rulebook's is ``pair_fwd`` with
      its offset axis reversed);
    * ``out_indices`` ``[N_out, ndim+1]`` and ``indices`` (the layer's
      input coordinates, the inverse conv's output sites);
    * ``num_out``, ``num_in`` and ``num_out_total`` (outputs before the
      ``out_bound`` cut), 0-d int32 device tensors;
    * the static geometry, and ``in_sorted``: whether the layer's input rows
      were key-sorted (the inverse conv's output inherits it).

    ``rank_slots`` (the port's own field) marks ``build_pool2_rulebook``'s
    record: its ``pair_fwd`` slots are the children's rank, not kernel
    offsets, and its ``pair_bwd`` holds only row 0, so the two tables are
    not each other's mirror."""

    def __init__(
        self,
        pair_fwd: torch.Tensor,
        pair_bwd: torch.Tensor,
        out_indices: torch.Tensor,
        indices: torch.Tensor,
        num_out: torch.Tensor,
        num_in: Optional[torch.Tensor] = None,
        num_out_total: Optional[torch.Tensor] = None,
        *,
        is_subm: bool,
        spatial_shape: Sequence[int],
        out_spatial_shape: Sequence[int],
        ksize: Sequence[int],
        stride: Sequence[int],
        padding: Sequence[int],
        dilation: Sequence[int],
        transposed: bool = False,
        in_sorted: bool = False,
        rank_slots: bool = False,
    ):
        self.pair_fwd = pair_fwd
        self.pair_bwd = pair_bwd
        self.out_indices = out_indices
        self.indices = indices
        self.num_out = num_out
        self.num_in = ((indices[:, 0] >= 0).sum(dtype=torch.int32)
                       if num_in is None else num_in)
        self.num_out_total = num_out if num_out_total is None \
            else num_out_total
        self.is_subm = bool(is_subm)
        self.spatial_shape = tuple(int(s) for s in spatial_shape)
        self.out_spatial_shape = tuple(int(s) for s in out_spatial_shape)
        self.ksize = tuple(int(k) for k in ksize)
        self.stride = tuple(int(s) for s in stride)
        self.padding = tuple(int(p) for p in padding)
        self.dilation = tuple(int(d) for d in dilation)
        self.transposed = bool(transposed)
        self.in_sorted = bool(in_sorted)
        self.rank_slots = bool(rank_slots)


# the reference's name for the implicit-GEMM record; one record serves both
ImplicitGemmIndiceData = IndiceData


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

    @classmethod
    def from_dense(cls, x: torch.Tensor,
                   pad_to: Optional[int] = None) -> "SparseConvTensor":
        """From a dense ``[B, *spatial, C]`` tensor: a site is active where
        any channel is non-zero.  Rows come in row-major flat order over
        ``(batch, *spatial)``, the key order, so ``keys_sorted`` is set.
        ``pad_to`` fixes the buffer's rows (active sites past it are cut);
        without it the buffer holds the active count, read on the host."""
        batch, spatial = x.shape[0], tuple(x.shape[1:-1])
        flat_mask = (x != 0).any(dim=-1).reshape(-1)
        n = int(flat_mask.sum()) if pad_to is None else int(pad_to)
        order = torch.sort((~flat_mask).to(torch.uint8), stable=True
                           ).indices[:n]
        found = flat_mask[order]
        coords = torch.stack(torch.unravel_index(order, (batch, *spatial)),
                             dim=-1).int()
        coords = torch.where(found[:, None], coords,
                             torch.full_like(coords, -1))
        feats = x.reshape(-1, x.shape[-1])[order]
        feats = torch.where(found[:, None], feats, torch.zeros_like(feats))
        return cls(feats, coords, spatial, batch,
                   num_voxels=found.sum(dtype=torch.int32), keys_sorted=True)

    def select_by_index(self, valid_indices: torch.Tensor
                        ) -> "SparseConvTensor":
        """The rows ``valid_indices``, with the count recomputed and the
        cached rulebooks dropped (row ids change).  Every other attribute,
        ``keys_sorted`` included, is kept as the JAX package keeps it."""
        new = self.shadow_copy()
        new.features = self.features[valid_indices]
        new.indices = self.indices[valid_indices]
        new.num_voxels = (new.indices[:, 0] >= 0).sum(dtype=torch.int32)
        new.indice_dict = {}
        return new

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
