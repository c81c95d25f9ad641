"""Small sparse classifier (counterpart of
``spconv_tpu/models/classifier.py``: the reference's minimal end-to-end
model, ``example/mnist``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import SparseConvTensor, default_device
from ..modules import (SparseConv2d, SparseConv3d, SparseGlobalAvgPool,
                       SubMConv2d, SubMConv3d)

__all__ = ["SparseClassifier"]


class SparseClassifier(nn.Module):
    """SubMConv -> SparseConv s2 -> SubMConv -> SparseConv s2, each followed
    by ReLU, then a global average pool and a linear head ``w_head [4 *
    width, num_classes]``, ``b_head``; returns the logits ``[B,
    num_classes]``.  2-d or 3-d.  The attribute names are the JAX
    module's, so ``checkpoint.load_jax_state_dict`` loads a JAX state dict
    strictly.  Weights are drawn from ``seed`` on the CPU in f32; ``device``
    None is the CUDA card."""

    def __init__(self, ndim: int, in_channels: int, num_classes: int,
                 width: int = 32, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        device = default_device(device)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, device=device, generator=gen)
        conv = {2: SubMConv2d, 3: SubMConv3d}[ndim]
        down = {2: SparseConv2d, 3: SparseConv3d}[ndim]
        self.c1 = conv(in_channels, width, 3, indice_key="s1", **kw)
        self.d1 = down(width, width * 2, 3, stride=2, padding=1, **kw)
        self.c2 = conv(width * 2, width * 2, 3, indice_key="s2", **kw)
        self.d2 = down(width * 2, width * 4, 3, stride=2, padding=1, **kw)
        self.pool = SparseGlobalAvgPool()
        bound = 1.0 / math.sqrt(width * 4)
        w = torch.empty((width * 4, num_classes)).uniform_(-bound, bound,
                                                           generator=gen)
        self.w_head = nn.Parameter(w.to(device=device, dtype=dtype))
        self.b_head = nn.Parameter(
            torch.zeros(num_classes, dtype=dtype, device=device))

    def forward(self, x: SparseConvTensor) -> torch.Tensor:
        for layer in (self.c1, self.d1, self.c2, self.d2):
            x = layer(x)
            x = x.replace_feature(F.relu(x.features))
        return self.pool(x) @ self.w_head + self.b_head
