"""Containers (counterpart of ``spconv_tpu/modules/modules.py``; only
``SparseSequential`` is ported)."""

from __future__ import annotations

import torch
from torch import nn

from ..core import SparseConvTensor

__all__ = ["SparseModule", "SparseSequential"]


class SparseModule(nn.Module):
    """Marker: the module takes and returns a :class:`SparseConvTensor`."""


class SparseSequential(SparseModule):
    """Sequential container of sparse modules and dense feature ops.

    A :class:`SparseModule` receives the tensor.  Any other module receives
    ``x.features``; its result replaces the features, with inactive rows
    set back to 0 (for ops where ``f(0) != 0``)."""

    def __init__(self, *layers: nn.Module, **named_layers: nn.Module):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)
        for name, layer in named_layers.items():
            self.add_module(name, layer)

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]

    def __len__(self) -> int:
        return len(self._modules)

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        for layer in self._modules.values():
            if isinstance(layer, SparseModule):
                x = layer(x)
            else:
                out = layer(x.features)
                x = x.shadow_copy()
                x.features = torch.where(x.valid_mask[:, None], out,
                                         torch.zeros_like(out))
        return x
