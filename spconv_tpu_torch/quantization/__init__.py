"""Int8 post-training quantization (counterpart of
``spconv_tpu/quantization``): observers, BN folding, the int8 conv on
kernel B7, ``SparseSequential`` calibration and conversion, and whole-
encoder PTQ.  The QAT half (``qat.py``) is not ported yet."""

from .encoder import (QuantizedSparseBasicBlock, QuantizedSparseEncoder,
                      observe_encoder_scales, quantize_encoder)
from .fuse import fuse_bn_act_in_sequential, fuse_bn_weights, fuse_conv_bn
from .quantize import (MinMaxObserver, PerChannelMinMaxObserver,
                       QuantizedSparseConv, SparseConvAddReLU, calibrate,
                       convert_to_int8, dequantize, quantize_tensor,
                       quantize_weight_per_channel)

__all__ = [
    "MinMaxObserver",
    "PerChannelMinMaxObserver",
    "quantize_weight_per_channel",
    "quantize_tensor",
    "dequantize",
    "QuantizedSparseConv",
    "SparseConvAddReLU",
    "calibrate",
    "convert_to_int8",
    "fuse_bn_weights",
    "fuse_conv_bn",
    "fuse_bn_act_in_sequential",
    "QuantizedSparseBasicBlock",
    "QuantizedSparseEncoder",
    "observe_encoder_scales",
    "quantize_encoder",
]
