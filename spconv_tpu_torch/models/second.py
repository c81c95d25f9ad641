"""SECOND / CenterPoint sparse voxel encoders (counterpart of
``spconv_tpu/models/second.py``).

The middle encoder of SECOND, CenterPoint and PV-RCNN detectors: subm conv
blocks at 16/32/64/128 channels, a stride-2 ``SparseConv3d`` downsample
between stages, and a final ``(3, 1, 1)`` / ``(2, 1, 1)`` conv that
collapses z, densified to a BEV map ``[B, C * D, H, W]``.

Attribute names and nesting are the JAX package's (``conv_input``,
``bn_input``, ``stages.<s>.<b>.conv1``, ``downs.<i>``, ``conv_out``,
``bn_out``), so ``checkpoint.load_jax_state_dict`` loads a JAX state dict
strictly, one to one, and the layer order that ``calibrate`` shares is the
same.  The JAX ``training=`` argument is ``nn.Module.training`` here (it
only selects the BatchNorm statistics).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import SparseConvTensor, default_device
from ..modules import BatchNorm1d, SparseConv3d, SubMConv3d

__all__ = [
    "SparseBasicBlock",
    "SparseEncoder",
    "second_encoder",
    "centerpoint_encoder",
]


class SparseBasicBlock(nn.Module):
    """Two subm convs with a residual add (PV-RCNN / CenterPoint block)."""

    def __init__(self, channels: int, indice_key: str, bn: bool = True,
                 algo: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        kw = dict(bias=not bn, indice_key=indice_key, algo=algo, dtype=dtype,
                  device=device, generator=generator)
        self.conv1 = SubMConv3d(channels, channels, 3, **kw)
        self.conv2 = SubMConv3d(channels, channels, 3, **kw)
        self.bn1 = BatchNorm1d(channels, device=device) if bn else None
        self.bn2 = BatchNorm1d(channels, device=device) if bn else None

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        identity = x.features
        out = self.conv1(x)
        if self.bn1 is not None:
            out = self.bn1(out)
        out = out.replace_feature(F.relu(out.features))
        out = self.conv2(out)
        if self.bn2 is not None:
            out = self.bn2(out)
        return out.replace_feature_masked(F.relu(out.features + identity))


class SparseEncoder(nn.Module):
    """SECOND-style sparse middle encoder -> dense BEV features.

    ``out_bounds`` gives the downsamples' output buffers (None: 1.5 times
    their input buffer); ``conv_out`` keeps its input buffer size unless
    calibrated (``calibrate.calibrate_out_bounds``).  Weights are drawn
    from ``seed`` on the CPU in f32, so a seed gives the same weights on
    any device and dtype; ``device`` None is the CUDA card."""

    def __init__(
        self,
        in_channels: int = 4,
        base_channels: int = 16,
        channels: Sequence[int] = (16, 32, 64, 128),
        blocks_per_stage: int = 2,
        out_channels: int = 128,
        bn: bool = True,
        algo: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        out_bounds: Optional[Sequence[int]] = None,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        device = default_device(device)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(algo=algo, dtype=dtype, device=device, generator=gen)
        self.bn = bn
        self.conv_input = SubMConv3d(in_channels, base_channels, 3,
                                     bias=not bn, indice_key="subm0", **kw)
        self.bn_input = (BatchNorm1d(base_channels, device=device) if bn
                         else None)
        self.out_bounds = tuple(out_bounds) if out_bounds else None
        stages, downs = [], []
        prev_c = base_channels
        for si, c in enumerate(channels):
            if si > 0:
                downs.append(SparseConv3d(
                    prev_c, c, 3, stride=2, padding=1, bias=not bn,
                    indice_key=f"down{si}",
                    out_bound=(self.out_bounds[si - 1] if self.out_bounds
                               else None),
                    out_bound_ratio=1.5, **kw))
            stages.append(nn.ModuleList(
                SparseBasicBlock(c, indice_key=f"subm{si}", bn=bn, **kw)
                for _ in range(blocks_per_stage)))
            prev_c = c
        self.stages = nn.ModuleList(stages)
        self.downs = nn.ModuleList(downs)
        self.conv_out = SparseConv3d(
            prev_c, out_channels, (3, 1, 1), stride=(2, 1, 1), padding=0,
            bias=not bn, indice_key="out", out_bound_ratio=1.0, **kw)
        self.bn_out = (BatchNorm1d(out_channels, device=device) if bn
                       else None)

    def forward_stages(self, x: SparseConvTensor) -> List[SparseConvTensor]:
        """The output of every stage (after its downsample and blocks),
        then the output of ``conv_out`` (+ BN, ReLU): the last entry is the
        encoder's output."""
        x = self.conv_input(x)
        if self.bn_input is not None:
            x = self.bn_input(x)
        x = x.replace_feature(F.relu(x.features))
        outs = []
        for si, blocks in enumerate(self.stages):
            if si > 0:
                x = self.downs[si - 1](x)
            for block in blocks:
                x = block(x)
            outs.append(x)
        x = self.conv_out(x)
        if self.bn_out is not None:
            x = self.bn_out(x)
        outs.append(x.replace_feature(F.relu(x.features)))
        return outs

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        return self.forward_stages(x)[-1]

    def bev(self, x: SparseConvTensor) -> torch.Tensor:
        """Forward + densify to BEV ``[B, C * D, H, W]``."""
        dense = self(x).dense()  # [B, C, D, H, W]
        b, c, d, h, w = dense.shape
        return dense.reshape(b, c * d, h, w)


def second_encoder(in_channels: int = 4, dtype: torch.dtype = torch.float32,
                   **kw) -> SparseEncoder:
    """SECOND (KITTI) middle extractor config."""
    return SparseEncoder(in_channels=in_channels, base_channels=16,
                         channels=(16, 32, 64, 128), dtype=dtype, **kw)


def centerpoint_encoder(in_channels: int = 5,
                        dtype: torch.dtype = torch.float32,
                        **kw) -> SparseEncoder:
    """CenterPoint (nuScenes) sparse backbone config."""
    return SparseEncoder(in_channels=in_channels, base_channels=16,
                         channels=(16, 32, 64, 128), dtype=dtype, **kw)
