"""Table containers (counterpart of ``spconv_tpu/modules/tables.py``):
``AddTable`` (sum the features of aligned sparse tensors), ``JoinTable``
(concatenate them along channels) and ``ConcatTable`` (apply several
modules to one input, return the list)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core import SparseConvTensor
from .modules import SparseModule

__all__ = ["AddTable", "ConcatTable", "JoinTable"]


class AddTable(SparseModule):
    """Sum the features of sparse tensors whose index buffers are aligned
    (the usual residual add); the result keeps the first one's indices and
    cache."""

    def forward(self, inputs: Sequence[SparseConvTensor]) -> SparseConvTensor:
        if not inputs:
            raise ValueError("AddTable needs at least one input")
        out = inputs[0].shadow_copy()
        out.features = sum((t.features for t in inputs[1:]),
                           inputs[0].features)
        return out


class JoinTable(SparseModule):
    """Concatenate the features of aligned sparse tensors along channels;
    the result keeps the first one's indices and cache."""

    def forward(self, inputs: Sequence[SparseConvTensor]) -> SparseConvTensor:
        if not inputs:
            raise ValueError("JoinTable needs at least one input")
        out = inputs[0].shadow_copy()
        out.features = torch.cat([t.features for t in inputs], dim=1)
        return out


class ConcatTable(SparseModule):
    """Apply each sub-module to the same input and return the list of
    results."""

    def __init__(self, *modules: nn.Module):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def add(self, module: nn.Module) -> "ConcatTable":
        """A new table with ``module`` appended (the JAX ``add``)."""
        return ConcatTable(*self._modules.values(), module)

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]

    def __len__(self) -> int:
        return len(self._modules)

    def forward(self, x: SparseConvTensor) -> list:
        return [m(x) for m in self._modules.values()]
