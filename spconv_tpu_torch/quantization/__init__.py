"""Int8 quantization (counterpart of ``spconv_tpu/quantization``):
observers, BN folding, the int8 conv on kernel B7, ``SparseSequential``
calibration and conversion, whole-encoder PTQ, and quantization-aware
training (``qat``: fake quantization, the fused QAT conv, ``prepare_qat``,
``qat_observe`` and ``convert_qat`` to an int8 ``QuantizedSequential``)."""

from .encoder import (QuantizedSparseBasicBlock, QuantizedSparseEncoder,
                      observe_encoder_scales, quantize_encoder)
from .qat import (QATConvBnReLU, QATQuantStub, QuantizedSequential,
                  convert_qat, fake_quant, fake_quant_per_channel,
                  finalize_qat, prepare_qat, qat_observe)
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
    "fake_quant",
    "fake_quant_per_channel",
    "QATConvBnReLU",
    "QATQuantStub",
    "QuantizedSequential",
    "finalize_qat",
    "prepare_qat",
    "qat_observe",
    "convert_qat",
]
