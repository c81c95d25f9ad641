"""Sparse pooling modules (counterpart of ``spconv_tpu/modules/pool.py``).

Ported: ``SparseMaxPool`` on the ``pool2_seg`` path, which is the
kernel-2 / stride-2 / pad-0 / dilation-1 pool without an ``indice_key``.
Every other geometry, and ``algo`` other than ``"auto"``/``"seg"``, raises
``NotImplementedError`` (ROADMAP A7)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from ..core import SparseConvTensor, expand_nd
from ..ops import coords as C
from ..ops.pool import pool2_seg
from .modules import SparseModule

__all__ = ["SparseMaxPool", "SparseMaxPool3d"]

IntOrSeq = Union[int, Sequence[int]]


class SparseMaxPool(SparseModule):
    def __init__(
        self,
        ndim: int,
        kernel_size: IntOrSeq = 3,
        stride: Optional[IntOrSeq] = 1,
        padding: IntOrSeq = 0,
        dilation: IntOrSeq = 1,
        indice_key: Optional[str] = None,
        subm: bool = False,
        algo: Optional[str] = None,
        out_bound: Optional[int] = None,
        out_bound_ratio: float = 1.0,
        name: Optional[str] = None,
    ):
        super().__init__()
        self.ndim = ndim
        self.kernel_size = expand_nd(ndim, kernel_size)
        self.stride = (self.kernel_size if stride is None
                       else expand_nd(ndim, stride))
        self.padding = expand_nd(ndim, padding)
        self.dilation = expand_nd(ndim, dilation)
        self.indice_key = indice_key
        self.subm = subm
        self.algo = algo or "auto"
        self.out_bound = out_bound
        self.out_bound_ratio = out_bound_ratio
        self.name = name
        two = (2,) * ndim
        if (subm or indice_key is not None or self.kernel_size != two
                or self.stride != two or self.padding != (0,) * ndim
                or self.dilation != (1,) * ndim):
            raise NotImplementedError(
                "only the 2x/stride-2 pool without indice_key (pool2_seg) "
                "is ported; other pools wait for ROADMAP A7")
        if self.algo not in ("auto", "seg"):
            raise NotImplementedError(
                f"pool algo={self.algo!r}: only pool2_seg is ported "
                "(ROADMAP A7)")

    def extra_repr(self) -> str:
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"out_bound={self.out_bound}")

    def _resolve_out_bound(self, n_in: int) -> int:
        """Static output buffer: ``out_bound`` when given, else ``n_in``
        times ``out_bound_ratio``, rounded up to a multiple of 128."""
        if self.out_bound is not None:
            return self.out_bound
        b = int(n_in * self.out_bound_ratio)
        return max(128, -(-b // 128) * 128)

    def forward(self, input: SparseConvTensor) -> SparseConvTensor:
        two = (2,) * self.ndim
        out_shape = C.get_conv_output_size(
            input.spatial_shape, two, two, (0,) * self.ndim,
            (1,) * self.ndim)
        out_feat, out_indices, num_out, num_out_total = pool2_seg(
            input.features, input.indices,
            spatial_shape=input.spatial_shape,
            batch_size=input.batch_size,
            out_bound=self._resolve_out_bound(input.indices.shape[0]),
        )
        return SparseConvTensor(
            out_feat, out_indices, out_shape, input.batch_size,
            num_voxels=num_out,
            indice_dict=dict(input.indice_dict),
            # discovery emits ascending unique keys
            keys_sorted=True,
            num_out_total=num_out_total,
        )


class SparseMaxPool3d(SparseMaxPool):
    def __init__(self, kernel_size: IntOrSeq = 3, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 indice_key: Optional[str] = None, subm: bool = False,
                 algo: Optional[str] = None, out_bound: Optional[int] = None,
                 out_bound_ratio: float = 1.0, name: Optional[str] = None):
        super().__init__(3, kernel_size, stride, padding, dilation,
                         indice_key, subm, algo, out_bound, out_bound_ratio,
                         name)
