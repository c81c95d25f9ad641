"""Whole-encoder int8 PTQ (counterpart of
``spconv_tpu/quantization/encoder.py``): observe the activation ranges of
a (BN-folded) ``SparseEncoder`` at every layer boundary on calibration
scans, then rebuild it from ``QuantizedSparseConv`` layers, each residual
block as conv1 (+relu) and a residual-fused ``SparseConvAddReLU``."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core import SparseConvTensor
from ..models.second import SparseEncoder
from ..modules.modules import SparseModule
from .fuse import fuse_conv_bn
from .quantize import (MinMaxObserver, PerChannelMinMaxObserver,
                       QuantizedSparseConv, SparseConvAddReLU, dequantize,
                       quantize_tensor)

__all__ = ["QuantizedSparseBasicBlock", "QuantizedSparseEncoder",
           "quantize_encoder", "observe_encoder_scales"]


def _fused_conv(conv, bn):
    return fuse_conv_bn(conv, bn) if bn is not None else conv


def _qconv(conv, scale_in: float, scale_out: float, act: str = "relu",
           cls=QuantizedSparseConv):
    wobs = PerChannelMinMaxObserver()
    wobs.observe(conv.weight)
    if cls is SparseConvAddReLU:
        return cls(conv, wobs.scale, scale_in, scale_out)
    return cls(conv, wobs.scale, scale_in, scale_out, act_type=act)


class QuantizedSparseBasicBlock(SparseModule):
    """int8 residual block: ``q1`` (+relu), then ``q2`` with the block's
    int8 input added in its epilogue at ``q2.add_scale``."""

    def __init__(self, q1: QuantizedSparseConv, q2: SparseConvAddReLU):
        super().__init__()
        self.q1 = q1
        self.q2 = q2

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        return self.q2(self.q1(x), add_input=x, add_scale=self.q2.add_scale)


class QuantizedSparseEncoder(nn.Module):
    """int8 SECOND / CenterPoint encoder made by :func:`quantize_encoder`:
    quantizes the fp input once at ``input_scale``, runs ``layers`` in int8
    and dequantizes the output at ``out_scale``."""

    def __init__(self, input_scale: float, layers: Sequence[nn.Module],
                 out_scale: float):
        super().__init__()
        self.input_scale = float(input_scale)
        self.layers = nn.ModuleList(layers)
        self.out_scale = float(out_scale)

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        cur = x.replace_feature(quantize_tensor(x.features, self.input_scale))
        for layer in self.layers:
            cur = layer(cur)
        return cur.replace_feature(dequantize(cur.features, self.out_scale))

    def bev(self, x: SparseConvTensor) -> torch.Tensor:
        """Forward + densify to BEV ``[B, C * D, H, W]`` (f32)."""
        dense = self(x).dense()
        b, c, d, h, w = dense.shape
        return dense.reshape(b, c * d, h, w)


def _fuse_encoder(enc: SparseEncoder):
    """BN folded into the convs: ``(conv_in, downs, stages_f, conv_out)``
    with ``stages_f = [[(conv1, conv2), ...] per stage]``."""
    conv_in = _fused_conv(enc.conv_input, enc.bn_input)
    downs = list(enc.downs)
    stages_f = [[(_fused_conv(b.conv1, b.bn1), _fused_conv(b.conv2, b.bn2))
                 for b in blocks] for blocks in enc.stages]
    conv_out = _fused_conv(enc.conv_out, enc.bn_out)
    return conv_in, downs, stages_f, conv_out


def observe_encoder_scales(enc: SparseEncoder,
                           calib_inputs: Sequence[SparseConvTensor]) -> dict:
    """The calibration pass: runs the BN-folded fp encoder on the
    calibration scans (under ``torch.no_grad()``) recording the range at
    every layer boundary, and returns the plain-JSON dict of activation
    scales ``{"in", "cin", "down": [...], "blocks": [[[s1, s2], ...], ...],
    "out"}`` that :func:`quantize_encoder` takes as ``scales``.  It reads
    every boundary on the host; deployments cache its result."""
    conv_in, downs, stages_f, conv_out = _fuse_encoder(enc)
    obs_in, obs_cin, obs_out = (MinMaxObserver() for _ in range(3))
    obs_down = [MinMaxObserver() for _ in downs]
    obs_blocks = [[(MinMaxObserver(), MinMaxObserver()) for _ in fb]
                  for fb in stages_f]

    def relu_t(t):
        return t.replace_feature(F.relu(t.features))

    with torch.no_grad():
        for x in calib_inputs:
            obs_in.observe(x)
            cur = relu_t(conv_in(x))
            obs_cin.observe(cur)
            for si, fb in enumerate(stages_f):
                if si > 0:
                    cur = relu_t(downs[si - 1](cur))
                    obs_down[si - 1].observe(cur)
                for (c1, c2), (o1, o2) in zip(fb, obs_blocks[si]):
                    identity = cur.features
                    mid = relu_t(c1(cur))
                    o1.observe(mid)
                    out = c2(mid)
                    cur = out.replace_feature_masked(
                        F.relu(out.features + identity))
                    o2.observe(cur)
            cur = relu_t(conv_out(cur))
            obs_out.observe(cur)
    return {
        "in": obs_in.scale,
        "cin": obs_cin.scale,
        "down": [o.scale for o in obs_down],
        "blocks": [[[o1.scale, o2.scale] for o1, o2 in ob]
                   for ob in obs_blocks],
        "out": obs_out.scale,
    }


def quantize_encoder(enc: SparseEncoder,
                     calib_inputs: Optional[List[SparseConvTensor]] = None,
                     scales: Optional[dict] = None) -> QuantizedSparseEncoder:
    """Calibrate and convert a ``SparseEncoder`` to int8: observe the
    scales on ``calib_inputs`` (:func:`observe_encoder_scales`) or take a
    cached ``scales`` dict, then rebuild the encoder from quantized layers
    on the fp weights' device.  The residual of each block is dequantized
    at the block input's scale."""
    if scales is None:
        if calib_inputs is None:
            raise ValueError("quantize_encoder needs calib_inputs or cached "
                             "scales")
        scales = observe_encoder_scales(enc, calib_inputs)
    conv_in, downs, stages_f, conv_out = _fuse_encoder(enc)
    layers: List[nn.Module] = [_qconv(conv_in, scales["in"], scales["cin"])]
    prev = scales["cin"]
    for si, fb in enumerate(stages_f):
        if si > 0:
            layers.append(_qconv(downs[si - 1], prev, scales["down"][si - 1]))
            prev = scales["down"][si - 1]
        for (c1, c2), (s1, s2) in zip(fb, scales["blocks"][si]):
            q2 = _qconv(c2, s1, s2, cls=SparseConvAddReLU)
            q2.add_scale = float(prev)
            layers.append(QuantizedSparseBasicBlock(_qconv(c1, prev, s1), q2))
            prev = s2
    layers.append(_qconv(conv_out, prev, scales["out"]))
    return QuantizedSparseEncoder(scales["in"], layers, scales["out"])
