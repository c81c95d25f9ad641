"""Sparse U-Net for semantic segmentation (counterpart of
``spconv_tpu/models/unet.py``; the reference's inverse-conv decoder,
``docs/USAGE.md:124-146``).

An encoder of ``SubMConv3d`` stages with a k3 s2 p1 ``SparseConv3d``
downsample between them, cached under ``indice_key="down<i>"``; a decoder
whose ``SparseInverseConv3d`` layers read those records to restore the
encoder's exact site sets, each joined (``JoinTable``) with the encoder
stage's output and fused by a subm conv that reuses the stage's match
table; a 1x1 head.  The output has exactly the input's sites.

Attribute names are the JAX package's (``enc_subm.<i>``, ``enc_down.<i>``,
``dec_up.<j>``, ``dec_subm.<j>``, ``head``), so
``checkpoint.load_jax_state_dict`` loads a JAX state dict strictly, one to
one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import SparseConvTensor, default_device
from ..modules import (JoinTable, SparseConv3d, SparseInverseConv3d,
                       SubMConv3d)

__all__ = ["SparseUNet"]


class SparseUNet(nn.Module):
    """``len(channels)`` encoder stages, ``len(channels) - 1`` downsamples
    and decoder stages, ``num_classes`` outputs per site.  The downsamples'
    output buffers hold twice their input's rows unless calibrated
    (``calibrate.calibrate_out_bounds``).  Weights are drawn from ``seed``
    on the CPU in f32, so a seed gives the same weights on any device and
    dtype; ``device`` None is the CUDA card."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (16, 32, 64),
                 num_classes: int = 16, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        kw = dict(dtype=dtype, device=device,
                  generator=torch.Generator().manual_seed(seed))
        last = len(channels) - 1
        self.enc_subm = nn.ModuleList()
        self.enc_down = nn.ModuleList()
        prev = in_channels
        for i, c in enumerate(channels):
            self.enc_subm.append(SubMConv3d(prev, c, 3,
                                            indice_key=f"subm{i}", **kw))
            if i < last:
                self.enc_down.append(SparseConv3d(
                    c, channels[i + 1], 3, stride=2, padding=1,
                    indice_key=f"down{i}", **kw))
            prev = channels[i + 1] if i < last else c
        self.dec_up = nn.ModuleList()
        self.dec_subm = nn.ModuleList()
        for i in reversed(range(last)):
            self.dec_up.append(SparseInverseConv3d(
                channels[i + 1], channels[i], 3, indice_key=f"down{i}", **kw))
            self.dec_subm.append(SubMConv3d(2 * channels[i], channels[i], 3,
                                            indice_key=f"subm{i}", **kw))
        self.head = SubMConv3d(channels[0], num_classes, 1, **kw)
        self.join = JoinTable()

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        skips = []
        for i, subm in enumerate(self.enc_subm):
            x = _relu(subm(x))
            skips.append(x)
            if i < len(self.enc_down):
                x = _relu(self.enc_down[i](x))
        for j, (up, subm) in enumerate(zip(self.dec_up, self.dec_subm)):
            x = _relu(up(x))
            x = self.join([x, skips[len(self.enc_subm) - 2 - j]])
            x = _relu(subm(x))
        return self.head(x)


def _relu(x: SparseConvTensor) -> SparseConvTensor:
    # relu(0) = 0 keeps the inactive rows at 0
    return x.replace_feature(F.relu(x.features))
