"""Sparse pooling modules (counterpart of ``spconv_tpu/modules/pool.py``):
``SparseMaxPool`` and ``SparseAvgPool`` with their 1-4d variants, and the
global pools.

Ported: the kernel-2 / stride-2 / pad-0 / dilation-1 pool without an
``indice_key``, on two routes, in both modes:

* ``algo="auto"`` / ``"seg"``: ``ops.pool.pool2_seg`` (torch ops; output
  discovery and a segment reduction);
* ``algo="sk"``: output discovery (``ops.rulebook.build_pool2_outputs``)
  and the sorted-key pool ``ops.sorted_pool.sk_pool2_ad`` (kernel B6 on the
  card), on key-sorted input.

The two routes reproduce the JAX package's two routes, which differ on
non-finite values and on the max's gradient at ties (``ops/sorted_pool.py``).

Refused with ``NotImplementedError``, because the JAX package sends them to
the native rulebook path (``indice_maxpool`` / ``indice_avgpool``), which is
not ported yet: a pool of another geometry, a subm pool, a pool with an
``indice_key``, ``algo="native"`` (any other algo), and ``algo="sk"`` on
input that is not key-sorted (the JAX route's rulebook fallback)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import calibrate
from ..core import SparseConvTensor, expand_nd
from ..debug_utils import maybe_assert_overflow
from ..ops import coords as C
from ..ops.pool import global_pool, pool2_seg
from ..ops.rulebook import build_pool2_outputs
from ..ops.sorted_pool import sk_pool2_ad
from .modules import SparseModule

__all__ = [
    "SparseMaxPool", "SparseAvgPool",
    "SparseMaxPool1d", "SparseMaxPool2d", "SparseMaxPool3d", "SparseMaxPool4d",
    "SparseAvgPool1d", "SparseAvgPool2d", "SparseAvgPool3d",
    "SparseGlobalMaxPool", "SparseGlobalAvgPool",
]

IntOrSeq = Union[int, Sequence[int]]

_NATIVE = ("the native rulebook path (indice_maxpool / indice_avgpool), "
           "which is not ported yet")


class _SparsePoolBase(SparseModule):
    _mode = "max"

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
                "only the 2x/stride-2 pool without indice_key is ported; "
                f"subm, keyed and other pools take {_NATIVE}")
        if self.algo not in ("auto", "seg", "sk"):
            raise NotImplementedError(
                f"pool algo={self.algo!r}: the seg and sk routes are "
                f"ported; any other algo takes {_NATIVE}")

    def extra_repr(self) -> str:
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"algo={self.algo!r}, out_bound={self.out_bound}")

    def _resolve_out_bound(self, n_in: int) -> int:
        """Static output buffer: ``out_bound`` when given, else ``n_in``
        times ``out_bound_ratio`` (at least 2 for a stride-1 pool), rounded
        up to a multiple of 128."""
        if self.out_bound is not None:
            return self.out_bound
        ratio = self.out_bound_ratio
        if all(s == 1 for s in self.stride):
            ratio = max(ratio, 2.0)
        b = int(n_in * ratio)
        return max(128, -(-b // 128) * 128)

    def forward(self, input: SparseConvTensor) -> SparseConvTensor:
        in_shape = tuple(input.spatial_shape)
        two = (2,) * self.ndim
        out_shape = tuple(C.get_conv_output_size(
            in_shape, two, two, (0,) * self.ndim, (1,) * self.ndim))
        out_bound = self._resolve_out_bound(input.indices.shape[0])
        context = self.name or type(self).__name__
        if self.algo == "sk":
            if not input.keys_sorted:
                raise NotImplementedError(
                    "algo='sk' pools key-sorted input (call sort_by_key()); "
                    f"unsorted input takes {_NATIVE}")
            out_indices, out_keys, num_out, num_out_total = \
                build_pool2_outputs(input.indices, spatial_shape=in_shape,
                                    batch_size=input.batch_size,
                                    out_bound=out_bound)
            maybe_assert_overflow(num_out_total, out_bound, context)
            in_keys, _ = C.linearize(input.indices, in_shape,
                                     input.batch_size)
            out_feat = sk_pool2_ad(input.features, in_keys, out_keys,
                                   in_shape=in_shape, out_shape=out_shape,
                                   batch_size=input.batch_size,
                                   mode=self._mode)
        else:
            out_feat, out_indices, num_out, num_out_total = pool2_seg(
                input.features, input.indices, spatial_shape=in_shape,
                batch_size=input.batch_size, out_bound=out_bound,
                mode=self._mode)
            maybe_assert_overflow(num_out_total, out_bound, context)
        calibrate._maybe_record(self, num_out)
        return SparseConvTensor(
            out_feat, out_indices, out_shape, input.batch_size,
            num_voxels=num_out,
            indice_dict=dict(input.indice_dict),
            # discovery emits ascending unique keys
            keys_sorted=True,
            num_out_total=num_out_total,
        )


class SparseMaxPool(_SparsePoolBase):
    _mode = "max"


class SparseAvgPool(_SparsePoolBase):
    """Mean over the present children of each output site."""
    _mode = "mean"


def _pool_variant(ndim: int, base: type, name: str) -> type:
    def __init__(self, kernel_size: IntOrSeq = 3,
                 stride: Optional[IntOrSeq] = 1, padding: IntOrSeq = 0,
                 dilation: IntOrSeq = 1, indice_key: Optional[str] = None,
                 subm: bool = False, algo: Optional[str] = None,
                 out_bound: Optional[int] = None,
                 out_bound_ratio: float = 1.0, name: Optional[str] = None):
        base.__init__(self, ndim, kernel_size, stride, padding, dilation,
                      indice_key, subm, algo, out_bound, out_bound_ratio,
                      name)

    return type(name, (base,), {"__init__": __init__,
                                "__module__": __name__})


SparseMaxPool1d = _pool_variant(1, SparseMaxPool, "SparseMaxPool1d")
SparseMaxPool2d = _pool_variant(2, SparseMaxPool, "SparseMaxPool2d")
SparseMaxPool3d = _pool_variant(3, SparseMaxPool, "SparseMaxPool3d")
SparseMaxPool4d = _pool_variant(4, SparseMaxPool, "SparseMaxPool4d")
SparseAvgPool1d = _pool_variant(1, SparseAvgPool, "SparseAvgPool1d")
SparseAvgPool2d = _pool_variant(2, SparseAvgPool, "SparseAvgPool2d")
SparseAvgPool3d = _pool_variant(3, SparseAvgPool, "SparseAvgPool3d")


class SparseGlobalMaxPool(SparseModule):
    """Max over each batch element's active sites -> dense ``[B, C]``
    (``ops.pool.global_pool``)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, input: SparseConvTensor) -> torch.Tensor:
        return global_pool(input.features, input.indices, input.batch_size,
                           "max")


class SparseGlobalAvgPool(SparseModule):
    """Mean over each batch element's active sites -> dense ``[B, C]``
    (``ops.pool.global_pool``)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, input: SparseConvTensor) -> torch.Tensor:
        return global_pool(input.features, input.indices, input.batch_size,
                           "mean")
