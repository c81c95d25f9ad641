"""Sparse pooling modules (counterpart of ``spconv_tpu/modules/pool.py``):
``SparseMaxPool`` and ``SparseAvgPool`` with their 1-4d variants, and the
global pools.

The kernel-2 / stride-2 / pad-0 / dilation-1 pool without an
``indice_key`` on a grid of int32 keys has two routes, in both modes:

* ``algo="auto"`` / ``"seg"``: ``ops.pool.pool2_seg`` (torch ops; output
  discovery and a segment reduction);
* ``algo="sk"``: output discovery (``ops.rulebook.build_pool2_outputs``)
  and the sorted-key pool ``ops.sorted_pool.sk_pool2_ad`` (kernel B6 on the
  card) on key-sorted input; on input that is not, the JAX route's
  fallback branch (the native pool over ``build_pool2_rulebook``) with the
  same backward.

The two routes reproduce the JAX package's two routes, which differ on
non-finite values and on the max's gradient at ties (``ops/sorted_pool.py``).

Every other pool takes the native rulebook path, as in the JAX package: a
subm pool, a pool with an ``indice_key``, any other geometry,
``algo="native"``, and the 2x pool on a grid of int64 keys.  It builds the
rulebook (``build_subm_rulebook``; ``build_pool2_rulebook`` for the 2x
geometry; else ``build_conv_rulebook``), or reuses the one under
``indice_key``, and reduces over its ``pair_fwd``
(``ops.pool.indice_maxpool`` / ``indice_avgpool``).  A keyed pool
registers its rulebook under its key, so a ``SparseInverseConv`` of the
same key can swap it (of a 2x pool rulebook only slot 0 of ``pair_bwd`` is
filled, so that inverse conv gives every child ``W[0]``, as the JAX
package's does).

Inside the layer's range (``modules.run_layer``) output discovery and the
rulebooks run in ``spconv.rulebook`` spans and the reduction in a
``spconv.pool`` span (``tracing``); each discovery or rulebook built adds
one to ``tracing.table_counts["pool.built"]``."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import calibrate
from ..core import IndiceData, SparseConvTensor, expand_nd
from ..debug_utils import maybe_assert_overflow
from ..ops import coords as C
from ..ops.pool import (global_pool, indice_avgpool, indice_maxpool,
                        pool2_seg)
from ..ops.rulebook import (build_conv_rulebook, build_pool2_outputs,
                            build_pool2_rulebook, build_subm_rulebook)
from ..ops.sorted_pool import sk_pool2_ad
from ..tracing import span, table_counts
from .modules import SparseModule, run_layer

__all__ = [
    "SparseMaxPool", "SparseAvgPool",
    "SparseMaxPool1d", "SparseMaxPool2d", "SparseMaxPool3d", "SparseMaxPool4d",
    "SparseAvgPool1d", "SparseAvgPool2d", "SparseAvgPool3d",
    "SparseGlobalMaxPool", "SparseGlobalAvgPool",
]

IntOrSeq = Union[int, Sequence[int]]

ALGOS = ("auto", "seg", "sk", "native")


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
        if self.algo not in ALGOS:
            raise ValueError(f"pool algo must be one of {ALGOS}, got "
                             f"{self.algo!r}")

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

    def _is_pool2(self, input: SparseConvTensor) -> bool:
        """The 2x/stride-2 geometry without a key on a grid of int32 keys,
        which the seg and sk routes serve."""
        two = (2,) * self.ndim
        return (not self.subm and self.indice_key is None
                and (self.kernel_size, self.stride, self.padding,
                     self.dilation) == (two, two, (0,) * self.ndim,
                                        (1,) * self.ndim)
                and not C.use_int64_keys(input.spatial_shape,
                                         input.batch_size))

    def forward(self, input: SparseConvTensor) -> SparseConvTensor:
        """The pool of ``input``, under :func:`modules.run_layer`'s
        profiler range and benchmark record."""
        return run_layer(self, input)

    def _forward(self, input: SparseConvTensor) -> SparseConvTensor:
        if self.algo == "native" or not self._is_pool2(input):
            return self._call_native(input)
        in_shape = tuple(input.spatial_shape)
        two = (2,) * self.ndim
        out_shape = tuple(C.get_conv_output_size(
            in_shape, two, two, (0,) * self.ndim, (1,) * self.ndim))
        out_bound = self._resolve_out_bound(input.indices.shape[0])
        context = self.name or type(self).__name__
        table_counts["pool.built"] += 1
        if self.algo == "sk":
            with span("spconv.rulebook"):
                out_indices, out_keys, num_out, num_out_total = \
                    build_pool2_outputs(input.indices,
                                        spatial_shape=in_shape,
                                        batch_size=input.batch_size,
                                        out_bound=out_bound)
                maybe_assert_overflow(num_out_total, out_bound, context)
                in_keys, _ = C.linearize(input.indices, in_shape,
                                         input.batch_size)
                pair_fwd = (None if input.keys_sorted else
                            build_pool2_rulebook(
                                input.indices, spatial_shape=in_shape,
                                batch_size=input.batch_size,
                                out_bound=out_bound).pair_fwd)
            out_feat = sk_pool2_ad(input.features, in_keys, out_keys,
                                   in_shape=in_shape, out_shape=out_shape,
                                   batch_size=input.batch_size,
                                   mode=self._mode, pair_fwd=pair_fwd)
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

    def _call_native(self, input: SparseConvTensor) -> SparseConvTensor:
        """The native path (the JAX package's ``pool.py:175-272``): the
        rulebook under ``indice_key`` when it is of the right kind (subm
        for a subm pool, else not subm; its geometry is not checked, as the
        JAX package does not), else a new one; the max or mean over its
        ``pair_fwd``; a new rulebook is registered under a free
        ``indice_key``."""
        data = input.find_indice_pair(self.indice_key)
        if not isinstance(data, IndiceData) or data.is_subm != self.subm:
            data = None
        geom = dict(spatial_shape=input.spatial_shape,
                    batch_size=input.batch_size)
        if data is None:
            table_counts["pool.built"] += 1
        if self.subm:
            if data is None:
                with span("spconv.rulebook"):
                    data = build_subm_rulebook(input.indices,
                                               ksize=self.kernel_size,
                                               dilation=self.dilation,
                                               **geom)
            out_indices, out_shape = input.indices, input.spatial_shape
            num_out = input.num_voxels
        else:
            if data is None:
                out_bound = self._resolve_out_bound(input.indices.shape[0])
                two = (2,) * self.ndim
                with span("spconv.rulebook"):
                    if (self.kernel_size, self.stride, self.padding,
                            self.dilation) == (two, two, (0,) * self.ndim,
                                               (1,) * self.ndim):
                        data = build_pool2_rulebook(
                            input.indices, out_bound=out_bound, **geom)
                    else:
                        data = build_conv_rulebook(
                            input.indices, ksize=self.kernel_size,
                            stride=self.stride, padding=self.padding,
                            dilation=self.dilation, out_bound=out_bound,
                            **geom)
                    maybe_assert_overflow(data.num_out_total, out_bound,
                                          self.name or type(self).__name__)
            out_indices, out_shape = data.out_indices, data.out_spatial_shape
            num_out = data.num_out
            calibrate._maybe_record(self, num_out)
        pool = indice_maxpool if self._mode == "max" else indice_avgpool
        with span("spconv.pool"):
            out_feat = pool(input.features, data.pair_fwd)
        out = SparseConvTensor(
            out_feat, out_indices, out_shape,
            input.batch_size, num_voxels=num_out,
            indice_dict=dict(input.indice_dict),
            keys_sorted=input.keys_sorted if self.subm else True,
            num_out_total=None if self.subm else data.num_out_total)
        if (self.indice_key is not None
                and self.indice_key not in out.indice_dict):
            out.indice_dict[self.indice_key] = data
        return out


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
