"""Sparse convolution modules (counterpart of
``spconv_tpu/modules/conv.py``).

Ported: the submanifold conv, the regular (strided) conv, the inverse conv
and the transposed conv on the dynamic-gather (DG) path, each forward and
backward, in 1 to 4 dimensions, and the 1x1 path (kernel 1 with a subm or
stride-1 geometry, the inverse and transposed convs' included: a plain
matmul on the input's own sites).  A
subm stage's match table is built once per ``indice_key`` and geometry
(kernel size and dilation), cached in ``indice_dict`` with the geometry it
was built for, and reused by every later layer of the stage that has that
geometry: the stage's first geometry under ``indice_key`` itself, another
one under ``DGData.cache_key(indice_key, ksize, dilation)``.  Its reversed
table (the backward's) is added to the same record the first time a layer
of the stage runs with a gradient wanted, and never under
``torch.no_grad()`` or ``torch.inference_mode()``.  A subm conv without an
``indice_key`` builds no table and caches nothing: its kernels search each
row's matches themselves (``ops.dg_conv.dg_subm_conv_search``), as the JAX
package's DG kernels do with ``pos=None``.

A regular conv discovers its output sites (``ops.rulebook.
build_conv_outputs``, bounded by ``out_bound``), builds its affine match
table and caches both in a :class:`DGRegData` record under
``__dgreg__<indice_key>``, with the input indices under
``__dgreg_in__<indice_key>``.  The divide table, the affine one's inverse,
joins the record once per key: built by the regular conv when a gradient
is wanted (its backward gathers through it), else by the paired inverse
conv (``SparseInverseConv3d`` with the same ``indice_key``), whose forward
gathers through it to map the features back onto the regular conv's input
sites.

A transposed conv discovers its output sites (``ops.rulebook.
build_deconv_outputs``) and runs as the inverse conv with the two spaces
swapped, as the JAX package does: the divide table over its expanded output
rows is its forward's table, the affine table over its input rows (built
only when a gradient is wanted) its backward's.  Its record carries
``transposed=True``, so a regular conv never reuses it, and an inverse conv
under its key raises.

``algo="sk"`` (the JAX package's sorted-key kernels, which compute the DG
conv's function through a one-hot key join on the TPU) runs the same match
tables through the same kernels; its regular-conv record lives under
``__skreg__``/``__skreg_in__`` as in the JAX package.  ``"auto"`` resolves
per call through ``tuner.CONV_TUNER.resolve`` (``select_algo``'s rules):
a winner cached for the layer's signature, else
``"dg"`` wherever the DG route serves the input; with tuning on (``SPCONV_TPU_TUNE=1``) and no winner cached, the
first call times the candidates on the live tensor and caches the winner
(``ConvTuner.tune_conv_algo``).  The layer's records keep the namespace of
its own ``algo``.  The reference's ``ConvAlgo`` enum is accepted for
``algo``.

Every forward runs through ``modules.run_layer``: a
``torch.profiler.record_function`` range under the layer's name while a
profiler records, and the per-layer record of ``benchmark=True`` input.
Inside it each table build opens a ``spconv.rulebook`` span, the product a
``spconv.product`` span and the epilogue a ``spconv.epilogue`` span
(``tracing``), and each build or reuse of a record adds one to its entry
of ``tracing.table_counts``.

The native rulebook path (``algo="native"``, and ``"auto"``, ``"dg"`` or
``"sk"`` wherever the DG route does not serve: input that is not
key-sorted, a grid whose keys are int64 (``coords.use_int64_keys``), an
inverse conv whose regular conv left no DG record) builds the JAX
package's rulebooks (``ops.rulebook``) and runs ``ops.gather_gemm.
indice_conv`` on them, which launches the DG kernels on the pair tables
(``path="native"``).  Its records are ``IndiceData`` under ``indice_key``
itself, as in the JAX package: a subm stage's rulebook is built once and
reused; a regular conv's is reused only on the same geometry, and a paired
inverse conv swaps its two tables.  Where a DG subm stage meets an
``IndiceData`` under its key, its table goes under
``DGData.cache_key`` instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import calibrate, tuner
from ..constants import DEFAULT_ALGO
from ..core import IndiceData, SparseConvTensor, default_device, expand_nd
from ..debug_utils import maybe_assert_overflow
from ..ops import coords as C
from ..ops.dg_conv import (build_dg_pos, dg_regular_conv, dg_subm_conv,
                           dg_subm_conv_search)
from ..ops.epilogue import bias_add_act
from ..ops.gather_gemm import indice_conv
from ..ops.rulebook import (build_conv_outputs, build_conv_rulebook,
                            build_deconv_outputs, build_subm_rulebook)
from ..tracing import span, table_counts
from .modules import SparseModule, run_layer

__all__ = ["DGData", "DGRegData", "SparseConvolution", "SubMConv1d",
           "SubMConv2d", "SubMConv3d", "SubMConv4d", "SparseConv1d",
           "SparseConv2d", "SparseConv3d", "SparseConv4d",
           "SparseInverseConv1d", "SparseInverseConv2d",
           "SparseInverseConv3d", "SparseInverseConv4d",
           "SparseConvTranspose1d", "SparseConvTranspose2d",
           "SparseConvTranspose3d", "SparseConvTranspose4d"]

IntOrSeq = Union[int, Sequence[int]]

ALGOS = ("auto", "dg", "sk", "native")


class DGData:
    """Cached state of an ``indice_key`` stage: the sorted keys, the match
    table ``pos`` ``[kv, N]``, the reversed table ``pos_rev`` (None until a
    layer of the stage needs a gradient) and the geometry they were built
    for."""

    def __init__(self, keys: torch.Tensor, pos: torch.Tensor, *,
                 ksize: Tuple[int, ...], dilation: Tuple[int, ...],
                 spatial_shape: Tuple[int, ...],
                 pos_rev: Optional[torch.Tensor] = None):
        self.keys = keys
        self.pos = pos
        self.pos_rev = pos_rev
        self.ksize = tuple(ksize)
        self.dilation = tuple(dilation)
        self.spatial_shape = tuple(spatial_shape)

    @staticmethod
    def cache_key(indice_key: str, ksize: Sequence[int],
                  dilation: Sequence[int]) -> str:
        """The ``indice_dict`` key of a stage's record for a kernel size or
        dilation other than that of the record under ``indice_key`` (the
        JAX package's ``DGData.cache_key`` without its TPU window and row
        terms)."""
        return (f"__dg__{indice_key}/{tuple(int(k) for k in ksize)}"
                f"/{tuple(int(d) for d in dilation)}")


class DGRegData:
    """Cached state of a regular or transposed conv under its
    ``indice_key`` (the port's ``SKRegData``): the input and output keys,
    the output sites and their counts, two match tables and the geometry
    they were built for.  A regular conv's are the affine table ``pos``
    ``[kv, N_out]`` (None until a conv of the record gathers through it)
    and its inverse, the divide table ``pos_div`` ``[kv, N_in]`` (None
    until a gradient of the regular conv or the paired inverse conv needs
    it).  A transposed conv's (``transposed``) are those of the swapped
    spaces: ``pos_div`` ``[kv, N_out]``, the divide table over its output
    rows, is its forward's table, and ``pos`` ``[kv, N_in]`` its
    backward's."""

    def __init__(self, in_keys: torch.Tensor, out_keys: torch.Tensor,
                 out_indices: torch.Tensor, num_out: torch.Tensor,
                 num_out_total: torch.Tensor, pos: Optional[torch.Tensor],
                 *,
                 ksize: Tuple[int, ...], stride: Tuple[int, ...],
                 padding: Tuple[int, ...], dilation: Tuple[int, ...],
                 in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 output_padding: Tuple[int, ...],
                 transposed: bool = False,
                 pos_div: Optional[torch.Tensor] = None):
        self.in_keys = in_keys
        self.out_keys = out_keys
        self.out_indices = out_indices
        self.num_out = num_out
        self.num_out_total = num_out_total
        self.pos = pos
        self.pos_div = pos_div
        self.ksize = tuple(ksize)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dilation = tuple(dilation)
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.output_padding = tuple(output_padding)
        self.transposed = bool(transposed)


class SparseConvolution(SparseModule):
    """Base sparse convolution with a KRSC weight ``[K, *ksize, C]``."""

    def __init__(
        self,
        ndim: int,
        in_channels: int,
        out_channels: int,
        kernel_size: IntOrSeq = 3,
        stride: IntOrSeq = 1,
        padding: IntOrSeq = 0,
        dilation: IntOrSeq = 1,
        groups: int = 1,
        bias: bool = True,
        subm: bool = False,
        output_padding: IntOrSeq = 0,
        transposed: bool = False,
        inverse: bool = False,
        indice_key: Optional[str] = None,
        algo: Optional[str] = None,
        out_bound: Optional[int] = None,
        out_bound_ratio: float = 2.0,
        act_type: str = "none",
        act_alpha: float = 0.0,
        act_beta: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
        name: Optional[str] = None,
    ):
        super().__init__()
        if groups != 1:
            raise ValueError("groups are not supported")
        self.ndim = ndim
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = expand_nd(ndim, kernel_size)
        self.stride = expand_nd(ndim, stride)
        self.padding = expand_nd(ndim, padding)
        self.dilation = expand_nd(ndim, dilation)
        self.output_padding = expand_nd(ndim, output_padding)
        kv = int(np.prod(self.kernel_size))
        # as the JAX package: kernel 1 with a subm or stride-1 geometry is
        # a plain matmul on the input's sites, an inverse conv's too
        self.kv = kv
        self.conv1x1 = kv == 1 and (subm or self.stride == (1,) * ndim)
        if inverse and indice_key is None:
            raise ValueError("an inverse conv requires the indice_key of "
                             "the regular conv it inverts")
        if self.conv1x1 and not subm and self.padding != (0,) * ndim:
            raise ValueError("padding must be zero for a 1x1 conv")
        if subm and any(k % 2 == 0 for k in self.kernel_size):
            raise ValueError("subm conv requires an odd kernel size")
        self.subm = subm
        self.transposed = transposed
        self.inverse = inverse
        self.indice_key = indice_key
        # the reference's ConvAlgo enum stands for its value
        self.algo = getattr(algo, "value", algo) or DEFAULT_ALGO
        self.out_bound = out_bound
        self.out_bound_ratio = out_bound_ratio
        self.act_type = act_type
        self.act_alpha = act_alpha
        self.act_beta = act_beta
        self.name = name

        # kaiming uniform with a = sqrt(5) over fan_in = C * kv (the
        # reference's KRSC init, the same bounds as torch's Conv default);
        # drawn in f32 on the CPU so a seed gives the same weights on any
        # device and dtype
        device = default_device(device)
        fan_in = in_channels * kv
        bound = math.sqrt(3.0) * math.sqrt(2.0 / 6.0) / math.sqrt(fan_in)
        w = torch.empty((out_channels, *self.kernel_size, in_channels))
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w.to(device=device, dtype=dtype))
        if bias:
            bb = 1.0 / math.sqrt(fan_in)
            b = torch.empty(out_channels).uniform_(-bb, bb,
                                                   generator=generator)
            self.bias = nn.Parameter(b.to(device=device, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, subm={self.subm}, "
                f"transposed={self.transposed}, inverse={self.inverse}, "
                f"indice_key={self.indice_key!r}, algo={self.algo!r}, "
                f"out_bound={self.out_bound}")

    def _resolve_out_bound(self, n_in: int) -> int:
        """Static output buffer of a regular or transposed conv:
        ``out_bound`` when given, else ``n_in`` times ``out_bound_ratio`` (at
        least ``2 * prod(stride)`` for a transposed conv, which expands the
        active set by up to ``prod(stride)``; at least 2 for a stride-1
        conv), rounded up to a multiple of 128."""
        if self.out_bound is not None:
            return self.out_bound
        ratio = self.out_bound_ratio
        if self.transposed:
            ratio = max(ratio, 2.0 * float(np.prod(self.stride)))
        elif all(s == 1 for s in self.stride):
            ratio = max(ratio, 2.0)
        b = int(n_in * ratio)
        return max(128, -(-b // 128) * 128)

    def forward(self, input: SparseConvTensor,
                add_input: Optional[SparseConvTensor] = None
                ) -> SparseConvTensor:
        """The conv of ``input`` (plus ``add_input``'s features before the
        activation), under :func:`modules.run_layer`'s profiler range and
        benchmark record."""
        return run_layer(self, input, add_input)

    def _num_pairs(self, input: SparseConvTensor, out: SparseConvTensor):
        """The benchmark record's pair count, as the JAX package counts it:
        the input's active rows on the 1x1 path, the matched pairs of the
        native rulebook under ``indice_key`` in ``out``, else None."""
        if self.conv1x1:
            return input.num_voxels
        data = out.find_indice_pair(self.indice_key)
        return ((data.pair_fwd >= 0).sum() if isinstance(data, IndiceData)
                else None)

    def _forward(self, input: SparseConvTensor,
                 add_input: Optional[SparseConvTensor]) -> SparseConvTensor:
        if self.conv1x1:
            with span("spconv.product"):
                w = self.weight.reshape(self.out_channels, self.in_channels)
                out_feat = input.features @ w.t()
            out_feat = self._epilogue(out_feat, input.indices, add_input)
            out = input.shadow_copy()
            out.features = out_feat
            return out
        if self.algo not in ALGOS:
            raise ValueError(f"algo must be one of {ALGOS}, got "
                             f"{self.algo!r}")
        dg_ok = self._dg_supported(input)
        algo = (tuner.CONV_TUNER.resolve(self, input, dg_ok)
                if self.algo == "auto" else self.algo)
        if algo == "native" or not dg_ok:
            return self._call_native(input, add_input)
        if self.subm:
            return self._call_dg(input, add_input)
        if self.inverse:
            return self._call_inverse(input, add_input)
        if self.transposed:
            return self._call_transposed(input, add_input)
        return self._call_dg_regular(input, add_input)

    def _epilogue(self, out_feat, out_indices, add_input):
        """Bias, residual add and activation, then 0 on the rows that are
        not active in ``out_indices`` (the output sites)."""
        with span("spconv.epilogue"):
            out_feat = bias_add_act(
                out_feat, self.bias, self.act_type, self.act_alpha,
                self.act_beta,
                add_input.features if add_input is not None else None)
            return torch.where((out_indices[:, 0] >= 0)[:, None], out_feat,
                               torch.zeros_like(out_feat))

    def _out_shape(self, in_shape: Sequence[int]) -> Tuple[int, ...]:
        """The output grid of a regular or transposed conv on
        ``in_shape``."""
        conv = (tuple(in_shape), self.kernel_size, self.stride, self.padding,
                self.dilation)
        return tuple(
            C.get_deconv_output_size(*conv, self.output_padding)
            if self.transposed else C.get_conv_output_size(*conv))

    def _dg_supported(self, input: SparseConvTensor) -> bool:
        """Whether the DG route serves ``input`` (the JAX package's
        ``_dg_supported``): key-sorted rows on a grid of int32 keys; for a
        regular or transposed conv also a non-empty output grid of int32
        keys; for an inverse conv the record of its regular conv under
        ``__dgreg__`` (``__skreg__`` for ``algo="sk"``).  Elsewhere the
        native path runs."""
        if (not input.keys_sorted
                or C.use_int64_keys(input.spatial_shape, input.batch_size)):
            return False
        if self.subm:
            return True
        if self.inverse:
            return isinstance(input.indice_dict.get(self._record_keys()[0]),
                              DGRegData)
        out_shape = self._out_shape(input.spatial_shape)
        return (all(v > 0 for v in out_shape)
                and not C.use_int64_keys(out_shape, input.batch_size))

    def _stage_key(self, input: SparseConvTensor) -> str:
        """The ``indice_dict`` key of this layer's subm record:
        ``indice_key`` unless that holds a record of another kernel size or
        dilation, or the native path's ``IndiceData``, then
        :meth:`DGData.cache_key`.  A key that holds anything else raises."""
        rec = input.indice_dict.get(self.indice_key)
        if rec is not None and not isinstance(rec, (DGData, IndiceData)):
            raise ValueError(
                f"indice_key={self.indice_key!r} holds a "
                f"{type(rec).__name__}, not a subm match table")
        if rec is None or (isinstance(rec, DGData)
                           and (rec.ksize, rec.dilation)
                           == (self.kernel_size, self.dilation)):
            return self.indice_key
        return DGData.cache_key(self.indice_key, self.kernel_size,
                                self.dilation)

    def _stage_pos(self, input: SparseConvTensor, need_rev: bool):
        """The match tables ``(pos, pos_rev, new)`` of this layer's
        ``indice_key`` stage: reused from ``indice_dict`` when a layer of
        this key and geometry already built them, else built (``new`` is
        then the pair ``(key, record)`` to cache).  ``pos_rev`` is built
        only when ``need_rev``, once per stage: it is added to a cached
        record that lacks it.  A record whose spatial shape or buffer size
        differs from ``input``'s raises."""
        shape = tuple(input.spatial_shape)
        geom = dict(ksize=self.kernel_size, dilation=self.dilation,
                    spatial_shape=shape, batch_size=input.batch_size)
        key = self._stage_key(input)
        rec = input.find_indice_pair(key)
        if rec is not None:
            mismatch = [
                (what, got, want) for what, got, want in (
                    ("spatial shape", rec.spatial_shape, shape),
                    ("buffer N", rec.pos.shape[1], input.indices.shape[0]),
                ) if got != want]
            if mismatch:
                raise ValueError(
                    f"subm match-table reuse mismatch under indice_key="
                    f"{self.indice_key!r}: " + ", ".join(
                        f"{w} {g} vs {x}" for w, g, x in mismatch))
            table_counts["subm.reused"] += 1
            if need_rev and rec.pos_rev is None:
                with span("spconv.rulebook"):
                    rec.pos_rev = build_dg_pos(rec.keys, reverse=True,
                                               **geom)
            return rec.pos, rec.pos_rev, None
        table_counts["subm.built"] += 1
        with span("spconv.rulebook"):
            keys, _ = C.linearize(input.indices, shape, input.batch_size)
            pos = build_dg_pos(keys, **geom)
            pos_rev = (build_dg_pos(keys, reverse=True, **geom) if need_rev
                       else None)
        return pos, pos_rev, (key, DGData(
            keys, pos, ksize=self.kernel_size, dilation=self.dilation,
            spatial_shape=shape, pos_rev=pos_rev))

    def _search_keys(self, input: SparseConvTensor) -> torch.Tensor:
        """The keys a table-free subm conv searches: ``input``'s rows
        linearized, ascending with the sentinel tail (key-sorted input)."""
        with span("spconv.rulebook"):
            return C.linearize(input.indices, input.spatial_shape,
                               input.batch_size)[0]

    def _call_dg(self, input: SparseConvTensor,
                 add_input: Optional[SparseConvTensor]) -> SparseConvTensor:
        """Subm conv on the DG path: through the stage's match tables under
        ``indice_key`` (:meth:`_stage_pos`), or, without a key, through the
        search-mode kernels, which build no table and cache nothing."""
        new = None
        if self.indice_key is None:
            out_feat = dg_subm_conv_search(
                input.features, self._search_keys(input), self.weight,
                spatial_shape=tuple(input.spatial_shape),
                batch_size=input.batch_size, dilation=self.dilation)
        else:
            need_rev = torch.is_grad_enabled() and (
                input.features.requires_grad or self.weight.requires_grad)
            pos, pos_rev, new = self._stage_pos(input, need_rev)
            out_feat = dg_subm_conv(input.features, self.weight, pos,
                                    pos_rev)
        out = SparseConvTensor(
            self._epilogue(out_feat, input.indices, add_input),
            input.indices,
            input.spatial_shape,
            input.batch_size,
            num_voxels=input.num_voxels,
            indice_dict=dict(input.indice_dict),
            keys_sorted=True,
        )
        if new is not None:
            out.indice_dict[new[0]] = new[1]
        return out

    def _regular_record(self, input: SparseConvTensor) -> DGRegData:
        """This regular (or transposed) conv's record: the one under
        ``__dgreg__<indice_key>`` (``__skreg__`` for ``algo="sk"``) when its
        geometry, ``transposed`` and ``output_padding`` included, matches
        exactly, else a new one from output discovery, with no table yet,
        which :meth:`_cache_record` caches."""
        indices = input.indices
        in_shape = tuple(input.spatial_shape)
        out_shape = self._out_shape(in_shape)
        geom = dict(ksize=self.kernel_size, stride=self.stride,
                    padding=self.padding, dilation=self.dilation,
                    in_shape=in_shape, out_shape=out_shape,
                    output_padding=self.output_padding,
                    transposed=self.transposed)
        rec = (input.indice_dict.get(self._record_keys()[0])
               if self.indice_key is not None else None)
        if (isinstance(rec, DGRegData)
                and rec.in_keys.shape[0] == indices.shape[0]
                and all(getattr(rec, k) == v for k, v in geom.items())):
            table_counts["regular.reused"] += 1
            return rec
        table_counts["regular.built"] += 1
        discover = dict(
            spatial_shape=in_shape, batch_size=input.batch_size,
            ksize=self.kernel_size, stride=self.stride,
            padding=self.padding, dilation=self.dilation,
            out_bound=self._resolve_out_bound(indices.shape[0]))
        with span("spconv.rulebook"):
            if self.transposed:
                found = build_deconv_outputs(
                    indices, out_padding=self.output_padding, **discover)
            else:
                found = build_conv_outputs(indices, **discover)
            out_indices, out_keys, num_out, num_out_total = found
            maybe_assert_overflow(num_out_total, out_keys.shape[0],
                                  self.name or type(self).__name__)
            in_keys, _ = C.linearize(indices, in_shape, input.batch_size)
        return DGRegData(in_keys, out_keys, out_indices, num_out,
                         num_out_total, None, **geom)

    def _record_keys(self) -> Tuple[str, str]:
        """The ``indice_dict`` keys of the regular conv's record under
        ``indice_key`` and of its input indices."""
        ns = "__skreg" if self.algo == "sk" else "__dgreg"
        return f"{ns}__{self.indice_key}", f"{ns}_in__{self.indice_key}"

    def _cache_record(self, input: SparseConvTensor,
                      out: SparseConvTensor, rec: DGRegData) -> None:
        """Caches a new record in ``out`` with the input indices beside it,
        unless ``indice_key`` is None or already holds a record (one whose
        geometry did not match stays as it is)."""
        if self.indice_key is None:
            return
        ck, ck_in = self._record_keys()
        if not isinstance(input.indice_dict.get(ck), DGRegData):
            out.indice_dict[ck] = rec
            out.indice_dict[ck_in] = input.indices

    def _call_dg_regular(self, input: SparseConvTensor,
                         add_input: Optional[SparseConvTensor]
                         ) -> SparseConvTensor:
        """Regular (strided) conv on the DG path: output discovery, the
        affine match table, B2; with a gradient wanted also the divide
        table, which the backward gathers through.  The tables join the
        record (:meth:`_regular_record`)."""
        rec = self._regular_record(input)
        out_feat, rec.pos, rec.pos_div = dg_regular_conv(
            input.features, rec.in_keys, rec.out_keys, self.weight,
            in_shape=rec.in_shape, out_shape=rec.out_shape,
            batch_size=input.batch_size, stride=self.stride,
            padding=self.padding, dilation=self.dilation, pos=rec.pos,
            pos_bwd=rec.pos_div)
        return self._regular_output(input, add_input, rec, out_feat)

    def _call_transposed(self, input: SparseConvTensor,
                         add_input: Optional[SparseConvTensor]
                         ) -> SparseConvTensor:
        """Transposed conv on the DG path: output discovery
        (``build_deconv_outputs``), then the inverse conv's kernels with the
        spaces swapped (the JAX package's ``conv.py:816-826``): B1 divide
        over the expanded output rows and B2 through it, with ``W[k]`` as
        it is; with a gradient wanted also the affine table over the input
        rows, which the backward gathers through.  The tables join the
        record (:meth:`_regular_record`)."""
        rec = self._regular_record(input)
        out_feat, rec.pos_div, rec.pos = dg_regular_conv(
            input.features, rec.out_keys, rec.in_keys, self.weight,
            in_shape=rec.out_shape, out_shape=rec.in_shape,
            batch_size=input.batch_size, stride=self.stride,
            padding=self.padding, dilation=self.dilation, path="transposed",
            pos=rec.pos_div, pos_bwd=rec.pos)
        return self._regular_output(input, add_input, rec, out_feat)

    def _regular_output(self, input: SparseConvTensor,
                        add_input: Optional[SparseConvTensor],
                        rec: DGRegData, out_feat: torch.Tensor
                        ) -> SparseConvTensor:
        """The output of a regular or transposed conv on ``rec``'s output
        sites: the epilogue on their mask, the calibration record, and
        ``rec`` cached (:meth:`_cache_record`)."""
        calibrate._maybe_record(self, rec.num_out)
        out = SparseConvTensor(
            self._epilogue(out_feat, rec.out_indices, add_input),
            rec.out_indices, rec.out_shape, input.batch_size,
            num_voxels=rec.num_out, indice_dict=dict(input.indice_dict),
            # discovery emits ascending unique keys, invalid rows last
            keys_sorted=True, num_out_total=rec.num_out_total)
        self._cache_record(input, out, rec)
        return out

    def _inverse_record(self, input: SparseConvTensor
                        ) -> Tuple[DGRegData, torch.Tensor]:
        """The record of the regular conv this inverse conv inverts and
        that conv's input indices (the inverse's output sites), checked
        against this conv and ``input``."""
        ck, ck_in = self._record_keys()
        rec = input.indice_dict.get(ck)
        enc_in = input.indice_dict.get(ck_in)
        if not isinstance(rec, DGRegData) or enc_in is None:
            raise ValueError(
                f"an inverse conv reads the record of the regular conv "
                f"under indice_key={self.indice_key!r} ({ck} and its input "
                "indices), and the input carries none")
        if rec.transposed:
            raise ValueError(
                f"an inverse conv cannot reuse the transposed-conv record "
                f"under indice_key={self.indice_key!r}")
        mismatch = [
            (what, got, want) for what, got, want in (
                ("kernel size", self.kernel_size, rec.ksize),
                ("input spatial shape", tuple(input.spatial_shape),
                 rec.out_shape),
                ("input buffer N", input.indices.shape[0],
                 rec.out_keys.shape[0]),
            ) if got != want]
        if mismatch:
            raise ValueError(
                f"inverse conv mismatch with the regular conv under "
                f"indice_key={self.indice_key!r}: " + ", ".join(
                    f"{w} {g} vs {x}" for w, g, x in mismatch))
        table_counts["regular.reused"] += 1
        return rec, enc_in

    def _call_inverse(self, input: SparseConvTensor,
                      add_input: Optional[SparseConvTensor]
                      ) -> SparseConvTensor:
        """Inverse conv on the DG path: maps the features on a regular
        conv's output sites back onto its input sites, read from that
        conv's record (:meth:`_inverse_record`), through the divide table
        and B2.  The divide table is cached on the record; its backward
        gathers through the record's affine table."""
        rec, enc_in = self._inverse_record(input)
        out_feat, rec.pos_div, _ = dg_regular_conv(
            input.features, rec.in_keys, rec.out_keys, self.weight,
            in_shape=rec.in_shape, out_shape=rec.out_shape,
            batch_size=input.batch_size, stride=rec.stride,
            padding=rec.padding, dilation=rec.dilation, path="inverse",
            pos=rec.pos_div, pos_bwd=rec.pos)
        return SparseConvTensor(
            self._epilogue(out_feat, enc_in, add_input), enc_in,
            rec.in_shape, input.batch_size,
            indice_dict=dict(input.indice_dict), keys_sorted=True)

    def _key_record(self, input: SparseConvTensor) -> Optional[IndiceData]:
        """The native record under ``indice_key``, None when the key holds
        none (or a record of the DG path)."""
        rec = input.find_indice_pair(self.indice_key)
        return rec if isinstance(rec, IndiceData) else None

    def _native_inverse_record(self, input: SparseConvTensor) -> IndiceData:
        """The rulebook an inverse conv swaps (the JAX package's
        ``conv.py:292-349``): the ``IndiceData`` under ``indice_key``, else
        one rebuilt from the regular conv's DG record (``__skreg__`` or
        ``__dgreg__``, with its input indices) when that conv ran the DG
        route, whose input was key-sorted.  Checked against this conv and
        ``input``."""
        data = self._key_record(input)
        if data is not None:
            table_counts["native.reused"] += 1
        else:
            for ns in ("__skreg", "__dgreg"):
                rec = input.indice_dict.get(f"{ns}__{self.indice_key}")
                enc_in = input.indice_dict.get(f"{ns}_in__{self.indice_key}")
                if isinstance(rec, DGRegData) and enc_in is not None:
                    table_counts["native.built"] += 1
                    with span("spconv.rulebook"):
                        data = build_conv_rulebook(
                            enc_in, spatial_shape=rec.in_shape,
                            batch_size=input.batch_size, ksize=rec.ksize,
                            stride=rec.stride, padding=rec.padding,
                            dilation=rec.dilation,
                            out_padding=rec.output_padding,
                            transposed=rec.transposed,
                            out_bound=rec.out_keys.shape[0])
                    data.in_sorted = True
                    break
        if data is None:
            raise ValueError(
                f"an inverse conv reads the rulebook of the regular conv "
                f"under indice_key={self.indice_key!r} (or its DG record), "
                "and the input carries none")
        mismatch = [
            (what, got, want) for what, got, want in (
                ("subm record", data.is_subm, False),
                ("kernel size", self.kernel_size, data.ksize),
                ("input spatial shape", tuple(input.spatial_shape),
                 data.out_spatial_shape),
                ("input buffer N", input.indices.shape[0],
                 data.pair_fwd.shape[1]),
            ) if got != want]
        if mismatch:
            raise ValueError(
                f"inverse conv mismatch with the rulebook under "
                f"indice_key={self.indice_key!r}: " + ", ".join(
                    f"{w} {g} vs {x}" for w, g, x in mismatch))
        return data

    def _native_subm_record(self, input: SparseConvTensor):
        """``(rulebook, new)`` of a subm conv: the ``IndiceData`` under
        ``indice_key``, checked as the JAX package checks its reuse, else a
        new one (``new`` True)."""
        data = self._key_record(input)
        if data is None:
            table_counts["native.built"] += 1
            with span("spconv.rulebook"):
                return build_subm_rulebook(
                    input.indices, spatial_shape=input.spatial_shape,
                    batch_size=input.batch_size, ksize=self.kernel_size,
                    dilation=self.dilation), True
        mismatch = [
            (what, got, want) for what, got, want in (
                ("subm", data.is_subm, True),
                ("ksize", data.ksize, self.kernel_size),
                ("dilation", data.dilation, self.dilation),
                ("spatial shape", data.spatial_shape,
                 tuple(input.spatial_shape))) if got != want]
        if mismatch:
            raise ValueError(
                f"subm rulebook reuse mismatch under indice_key="
                f"{self.indice_key!r}: " + ", ".join(
                    f"{w} {g} vs {x}" for w, g, x in mismatch))
        table_counts["native.reused"] += 1
        return data, False

    def _native_regular_record(self, input: SparseConvTensor,
                               out_padding: Optional[Sequence[int]] = None):
        """``(rulebook, new)`` of a regular or transposed conv: the
        ``IndiceData`` of a regular conv under ``indice_key`` when its
        geometry, ``transposed`` included, is this conv's (another raises),
        else a new one whose ``in_sorted`` records the input's flag.  A new
        transposed rulebook takes ``out_padding`` (default this conv's
        ``output_padding``)."""
        data = self._key_record(input)
        if data is not None and not data.is_subm:
            got = (data.ksize, data.stride, data.padding, data.dilation,
                   data.transposed, data.spatial_shape)
            want = (self.kernel_size, self.stride, self.padding,
                    self.dilation, self.transposed,
                    tuple(input.spatial_shape))
            if got != want:
                raise ValueError(
                    f"rulebook reuse mismatch under indice_key="
                    f"{self.indice_key!r}: cached (ksize, stride, padding, "
                    f"dilation, transposed, spatial) {got} vs layer {want}")
            table_counts["native.reused"] += 1
            return data, False
        table_counts["native.built"] += 1
        with span("spconv.rulebook"):
            data = build_conv_rulebook(
                input.indices, spatial_shape=input.spatial_shape,
                batch_size=input.batch_size, ksize=self.kernel_size,
                stride=self.stride, padding=self.padding,
                dilation=self.dilation,
                out_padding=(self.output_padding if out_padding is None
                             else out_padding),
                transposed=self.transposed,
                out_bound=self._resolve_out_bound(input.indices.shape[0]))
        data.in_sorted = input.keys_sorted
        return data, True

    def _call_native(self, input: SparseConvTensor,
                     add_input: Optional[SparseConvTensor]
                     ) -> SparseConvTensor:
        """The native rulebook path (the JAX package's
        ``conv.py:292-494``): this conv's rulebook (built, or reused from
        ``indice_key``), :func:`ops.gather_gemm.indice_conv` on its tables
        (swapped for an inverse conv), the epilogue, and the output's
        count and ``keys_sorted``: a subm conv keeps its input's, an
        inverse conv takes ``in_sorted`` of the rulebook it swaps, and a
        regular or transposed conv's sites come in ascending key order."""
        new = False
        if self.inverse:
            data = self._native_inverse_record(input)
            pair_fwd, pair_bwd = data.pair_bwd, data.pair_fwd
            out_indices, out_shape = data.indices, data.spatial_shape
            num_voxels, out_sorted, total = data.num_in, data.in_sorted, None
        elif self.subm:
            data, new = self._native_subm_record(input)
            pair_fwd, pair_bwd = data.pair_fwd, data.pair_bwd
            out_indices, out_shape = input.indices, input.spatial_shape
            num_voxels, out_sorted = input.num_voxels, input.keys_sorted
            total = None
        else:
            data, new = self._native_regular_record(input)
            pair_fwd, pair_bwd = data.pair_fwd, data.pair_bwd
            out_indices, out_shape = data.out_indices, data.out_spatial_shape
            num_voxels, out_sorted = data.num_out, True
            total = data.num_out_total
            calibrate._maybe_record(self, data.num_out)
            maybe_assert_overflow(data.num_out_total, pair_fwd.shape[1],
                                  self.name or type(self).__name__)
        out_feat = indice_conv(input.features, self.weight, pair_fwd,
                               pair_bwd, is_subm=self.subm,
                               mirrored=not data.rank_slots)
        out = SparseConvTensor(
            self._epilogue(out_feat, out_indices, add_input),
            out_indices, out_shape, input.batch_size, num_voxels=num_voxels,
            indice_dict=dict(input.indice_dict), keys_sorted=out_sorted,
            num_out_total=total)
        if new and self.indice_key is not None:
            out.indice_dict[self.indice_key] = data
        return out


def _make_conv(ndim: int, subm: bool):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq = 3, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 indice_key: Optional[str] = None,
                 algo: Optional[str] = None, **kwargs):
        SparseConvolution.__init__(
            self, ndim, in_channels, out_channels, kernel_size, stride,
            padding, dilation, groups, bias, subm=subm,
            indice_key=indice_key, algo=algo, **kwargs)

    return __init__


class SubMConv1d(SparseConvolution):
    __init__ = _make_conv(1, subm=True)


class SubMConv2d(SparseConvolution):
    __init__ = _make_conv(2, subm=True)


class SubMConv3d(SparseConvolution):
    """Submanifold 3-d conv: its output sites are its input's.  With an
    ``indice_key`` its stage's match tables are cached and shared; without
    one its kernels search each row's matches (see the module's
    docstring)."""
    __init__ = _make_conv(3, subm=True)


class SubMConv4d(SparseConvolution):
    __init__ = _make_conv(4, subm=True)


class SparseConv1d(SparseConvolution):
    __init__ = _make_conv(1, subm=False)


class SparseConv2d(SparseConvolution):
    __init__ = _make_conv(2, subm=False)


class SparseConv3d(SparseConvolution):
    """Regular 3-d sparse conv (strided downsample).  Its output buffer
    holds ``out_bound`` rows (default: ``out_bound_ratio`` times the input
    buffer); see :meth:`SparseConvolution._resolve_out_bound`."""
    __init__ = _make_conv(3, subm=False)


class SparseConv4d(SparseConvolution):
    __init__ = _make_conv(4, subm=False)


def _make_inverse(ndim: int):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq = 3, indice_key: Optional[str] = None,
                 algo: Optional[str] = None, **kwargs):
        SparseConvolution.__init__(
            self, ndim, in_channels, out_channels, kernel_size,
            inverse=True, indice_key=indice_key, algo=algo, **kwargs)

    return __init__


class SparseInverseConv1d(SparseConvolution):
    __init__ = _make_inverse(1)


class SparseInverseConv2d(SparseConvolution):
    __init__ = _make_inverse(2)


class SparseInverseConv3d(SparseConvolution):
    """Inverse of the regular conv under the same ``indice_key``: its
    output sites are that conv's input sites, its output spatial shape that
    conv's input shape.  Its own stride, padding and dilation are not read:
    the record's are."""
    __init__ = _make_inverse(3)


class SparseInverseConv4d(SparseConvolution):
    __init__ = _make_inverse(4)


def _make_transposed(ndim: int):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq = 3, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 indice_key: Optional[str] = None,
                 algo: Optional[str] = None, output_padding: IntOrSeq = 0,
                 out_bound: Optional[int] = None,
                 out_bound_ratio: float = 2.0, **kwargs):
        SparseConvolution.__init__(
            self, ndim, in_channels, out_channels, kernel_size, stride,
            padding, dilation, groups, bias, output_padding=output_padding,
            transposed=True, indice_key=indice_key, algo=algo,
            out_bound=out_bound, out_bound_ratio=out_bound_ratio, **kwargs)

    return __init__


class SparseConvTranspose1d(SparseConvolution):
    __init__ = _make_transposed(1)


class SparseConvTranspose2d(SparseConvolution):
    __init__ = _make_transposed(2)


class SparseConvTranspose3d(SparseConvolution):
    """Transposed 3-d sparse conv: each input site reaches the output sites
    ``i * stride + k * dilation - padding`` on the grid of
    ``coords.get_deconv_output_size``.  Its output buffer holds
    ``out_bound`` rows (default: ``max(out_bound_ratio, 2 * prod(stride))``
    times the input buffer)."""
    __init__ = _make_transposed(3)


class SparseConvTranspose4d(SparseConvolution):
    __init__ = _make_transposed(4)
