"""Sparse convolution modules (counterpart of
``spconv_tpu/modules/conv.py``).

Ported: the submanifold conv on the dynamic-gather (DG) path and the 1x1
path.  The stage's match table is built once per ``indice_key``, cached in
``indice_dict`` with the geometry it was built for, and reused by every
later layer of the stage.

Not ported yet, and refused with ``NotImplementedError`` rather than
computed some other way: the native rulebook path (any ``algo`` other than
``"auto"``/``"dg"``, and input that is not key-sorted; ROADMAP A4-A5) and
strided, transposed and inverse convs (ROADMAP A9).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..constants import DEFAULT_ALGO
from ..core import SparseConvTensor, expand_nd
from ..ops import coords as C
from ..ops.dg_conv import build_dg_pos, dg_subm_conv
from ..ops.epilogue import bias_add_act
from .modules import SparseModule

__all__ = ["DGData", "SparseConvolution", "SubMConv3d"]

IntOrSeq = Union[int, Sequence[int]]


class DGData:
    """Cached state of an ``indice_key`` stage: the sorted keys, the match
    table ``pos`` ``[kv, N]`` and the geometry they were built for."""

    def __init__(self, keys: torch.Tensor, pos: torch.Tensor, *,
                 ksize: Tuple[int, ...], dilation: Tuple[int, ...],
                 spatial_shape: Tuple[int, ...]):
        self.keys = keys
        self.pos = pos
        self.ksize = tuple(ksize)
        self.dilation = tuple(dilation)
        self.spatial_shape = tuple(spatial_shape)


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
        transposed: bool = False,
        inverse: bool = False,
        indice_key: Optional[str] = None,
        algo: Optional[str] = None,
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
        kv = int(np.prod(self.kernel_size))
        self.conv1x1 = kv == 1 and (subm or self.stride == (1,) * ndim)
        if transposed or inverse or not (subm or self.conv1x1):
            raise NotImplementedError(
                "only submanifold and 1x1 convs are ported; strided, "
                "transposed and inverse convs wait for ROADMAP A9")
        if self.conv1x1 and not subm and self.padding != (0,) * ndim:
            raise ValueError("padding must be zero for a 1x1 conv")
        if subm and any(k % 2 == 0 for k in self.kernel_size):
            raise ValueError("subm conv requires an odd kernel size")
        self.subm = subm
        self.indice_key = indice_key
        self.algo = algo or DEFAULT_ALGO
        self.act_type = act_type
        self.act_alpha = act_alpha
        self.act_beta = act_beta
        self.name = name

        # kaiming uniform with a = sqrt(5) over fan_in = C * kv (the
        # reference's KRSC init, the same bounds as torch's Conv default);
        # drawn in f32 on the CPU so a seed gives the same weights on any
        # device and dtype
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
                f"kernel_size={self.kernel_size}, subm={self.subm}, "
                f"indice_key={self.indice_key!r}, algo={self.algo!r}")

    def forward(self, input: SparseConvTensor,
                add_input: Optional[SparseConvTensor] = None
                ) -> SparseConvTensor:
        if self.conv1x1:
            w = self.weight.reshape(self.out_channels, self.in_channels)
            out_feat = self._epilogue(input.features @ w.t(), input,
                                      add_input)
            out = input.shadow_copy()
            out.features = out_feat
            return out
        if self.algo not in ("auto", "dg"):
            raise NotImplementedError(
                f"algo={self.algo!r}: only the dynamic-gather path is "
                "ported; the native rulebook path waits for ROADMAP A4-A5")
        if not input.keys_sorted:
            raise NotImplementedError(
                "the DG conv needs key-sorted input (call sort_by_key()); "
                "unsorted input takes the native rulebook path, which "
                "waits for ROADMAP A4-A5")
        return self._call_dg(input, add_input)

    def _epilogue(self, out_feat, input, add_input):
        out_feat = bias_add_act(
            out_feat, self.bias, self.act_type, self.act_alpha,
            self.act_beta,
            add_input.features if add_input is not None else None)
        return torch.where(input.valid_mask[:, None], out_feat,
                           torch.zeros_like(out_feat))

    def _stage_pos(self, input: SparseConvTensor):
        """The stage's match table: reused from ``indice_dict`` when this
        ``indice_key`` already built one, else built (and returned as the
        new record to cache)."""
        shape = tuple(input.spatial_shape)
        rec = input.find_indice_pair(self.indice_key)
        if rec is not None:
            if not isinstance(rec, DGData):
                raise ValueError(
                    f"indice_key={self.indice_key!r} holds a "
                    f"{type(rec).__name__}, not a subm match table")
            mismatch = [
                (what, got, want) for what, got, want in (
                    ("ksize", rec.ksize, self.kernel_size),
                    ("dilation", rec.dilation, self.dilation),
                    ("spatial shape", rec.spatial_shape, shape),
                    ("buffer N", rec.pos.shape[1], input.indices.shape[0]),
                ) if got != want]
            if mismatch:
                raise ValueError(
                    f"subm match-table reuse mismatch under indice_key="
                    f"{self.indice_key!r}: " + ", ".join(
                        f"{w} {g} vs {x}" for w, g, x in mismatch))
            return rec.pos, None
        keys, _ = C.linearize(input.indices, shape, input.batch_size)
        pos = build_dg_pos(keys, ksize=self.kernel_size,
                           dilation=self.dilation, spatial_shape=shape,
                           batch_size=input.batch_size)
        if self.indice_key is None:
            return pos, None
        return pos, DGData(keys, pos, ksize=self.kernel_size,
                           dilation=self.dilation, spatial_shape=shape)

    def _call_dg(self, input: SparseConvTensor,
                 add_input: Optional[SparseConvTensor]) -> SparseConvTensor:
        pos, new_rec = self._stage_pos(input)
        out_feat = dg_subm_conv(input.features, self.weight, pos)
        out = SparseConvTensor(
            self._epilogue(out_feat, input, add_input),
            input.indices,
            input.spatial_shape,
            input.batch_size,
            num_voxels=input.num_voxels,
            indice_dict=dict(input.indice_dict),
            keys_sorted=True,
        )
        if new_rec is not None:
            out.indice_dict[self.indice_key] = new_rec
        return out


class SubMConv3d(SparseConvolution):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq = 3, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 indice_key: Optional[str] = None,
                 algo: Optional[str] = None, **kwargs):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias, subm=True,
                         indice_key=indice_key, algo=algo, **kwargs)
