"""BN + activation folding for inference (counterpart of
``spconv_tpu/quantization/fuse.py``)."""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn

from ..modules.conv import SparseConvolution
from ..modules.modules import BatchNorm1d, SparseReLU, SparseSequential

__all__ = ["fuse_bn_weights", "fuse_conv_bn", "fuse_bn_act_in_sequential"]


def fuse_bn_weights(weight: torch.Tensor, bias: Optional[torch.Tensor],
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float, gamma: torch.Tensor, beta: torch.Tensor):
    """KRSC weight and bias folded with BN statistics, in the JAX order:
    ``w' = w * (gamma / sqrt(var + eps))`` per output channel and
    ``b' = beta + (b - mean) * gamma / sqrt(var + eps)``."""
    # the root in f64, rounded once: the correctly rounded f32 root, as
    # the JAX package's (torch's vectorized f32 sqrt on the CPU can be one
    # ulp off, which moves a per-channel weight scale)
    inv = gamma / torch.sqrt((running_var + eps).double()).float()
    w = weight * inv.reshape((-1,) + (1,) * (weight.ndim - 1)).to(
        weight.dtype)
    if bias is None:
        bias = torch.zeros_like(running_mean).to(weight.dtype)
    b = (beta + (bias.float() - running_mean) * inv).to(weight.dtype)
    return w, b


def fuse_conv_bn(conv: SparseConvolution,
                 bn: BatchNorm1d) -> SparseConvolution:
    """A copy of ``conv`` with ``bn``'s running statistics and affine part
    folded into its weight and bias (inference only)."""
    gamma = (bn.weight if bn.weight is not None
             else torch.ones_like(bn.running_mean))
    beta = (bn.bias if bn.bias is not None
            else torch.zeros_like(bn.running_mean))
    with torch.no_grad():
        w, b = fuse_bn_weights(conv.weight, conv.bias, bn.running_mean,
                               bn.running_var, bn.eps, gamma, beta)
    fused = copy.deepcopy(conv)
    fused.weight = nn.Parameter(w)
    fused.bias = nn.Parameter(b)
    return fused


def fuse_bn_act_in_sequential(seq: SparseSequential) -> SparseSequential:
    """conv -> bn (-> relu) chains of ``seq`` folded into one fused conv
    each (the relu as its ``act_type``); other layers pass through."""
    layers = list(seq.children())
    out: List[nn.Module] = []
    i = 0
    while i < len(layers):
        layer = layers[i]
        if (isinstance(layer, SparseConvolution) and i + 1 < len(layers)
                and isinstance(layers[i + 1], BatchNorm1d)):
            fused = fuse_conv_bn(layer, layers[i + 1])
            i += 2
            if i < len(layers) and isinstance(layers[i], SparseReLU):
                fused.act_type = "relu"
                i += 1
            out.append(fused)
        else:
            out.append(layer)
            i += 1
    return SparseSequential(*out)
