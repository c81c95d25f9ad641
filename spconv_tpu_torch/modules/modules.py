"""Containers and normalization (counterpart of
``spconv_tpu/modules/modules.py``; ``SparseSequential``, ``BatchNorm1d``
and ``SparseReLU`` are ported)."""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from ..core import SparseConvTensor, default_device

__all__ = ["SparseModule", "SparseSequential", "BatchNorm1d", "SparseReLU"]


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


class BatchNorm1d(SparseModule):
    """Feature-row batch norm whose statistics cover active rows only (a
    dense BN over the padded buffer would count the zero padding).

    In training mode (``module.train()``) it normalizes with the masked
    batch statistics, otherwise with the running ones.  Statistics and the
    normalization are f32; the result is cast back to the features' dtype
    and inactive rows are 0.  Its tensors are exactly the JAX module's
    leaves, ``weight``, ``bias`` (parameters, when ``affine``),
    ``running_mean`` and ``running_var`` (f32 buffers), so a JAX state
    dict loads strictly; there is no ``num_batches_tracked``.  The
    running-stat update (the JAX ``updated``) is not ported yet.

    Takes a :class:`SparseConvTensor` or a plain ``[N, C]`` tensor (all
    rows active).  ``device`` None is the CUDA card."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        device = default_device(device)
        if affine:
            self.weight = nn.Parameter(
                torch.ones(num_features, dtype=dtype, device=device))
            self.bias = nn.Parameter(
                torch.zeros(num_features, dtype=dtype, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}"

    @staticmethod
    def _batch_stats(feats, mask):
        m = mask[:, None].float()
        f32 = feats.float() * m
        cnt = m.sum().clamp(min=1.0)
        mean = f32.sum(0) / cnt
        var = (f32 * f32).sum(0) / cnt - mean * mean
        return mean, var.clamp(min=0.0)

    def forward(self, x: Union[SparseConvTensor, torch.Tensor]
                ) -> Union[SparseConvTensor, torch.Tensor]:
        sparse = isinstance(x, SparseConvTensor)
        feats = x.features if sparse else x
        if self.training:
            mask = (x.valid_mask if sparse else
                    torch.ones(feats.shape[0], dtype=torch.bool,
                               device=feats.device))
            mean, var = self._batch_stats(feats, mask)
        else:
            mean, var = self.running_mean, self.running_var
        out = (feats.float() - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            out = out * self.weight + self.bias
        out = out.to(feats.dtype)
        if sparse:
            return x.replace_feature_masked(out)
        return out


class SparseReLU(SparseModule):
    """ReLU of the features (any dtype, int8 included); inactive rows stay
    0."""

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        return x.replace_feature(torch.relu(x.features))
