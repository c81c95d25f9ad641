"""Quantization-aware training (counterpart of
``spconv_tpu/quantization/qat.py``): fake quantization with a
straight-through gradient, the fused conv(+BN)(+ReLU) QAT module that
fake-quantizes its BN-folded weight, the input stub, the whole-net rewrite
(``prepare_qat``), the observation pass (``qat_observe``) and the
conversion to an int8 net served on kernel B7 (``convert_qat``).

The JAX functions return new modules; here the observers update buffers in
place under ``torch.no_grad()`` and return the module (or ``(module,
output)`` where the JAX function returns a pair), so a training loop needs
no rebinding.  ``prepare_qat`` copies the float net's layers, so the float
net is left as it was, as in the JAX package.

Kept as the JAX package has them (ROADMAP.md queue C, ADVICE r5): BN is
folded with its running statistics only (BN-frozen QAT); ``qat_observe``
runs a layer that no QAT module absorbed in training mode and does not
advance a bare ``BatchNorm1d``'s running statistics; ``convert_qat`` passes
such layers through to the int8 net unchanged, where they see int8
features and the scale chain assumes they keep the scale.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..core import SparseConvTensor, default_device
from ..modules.conv import SparseConvolution
from ..modules.modules import (BatchNorm1d, SparseModule, SparseReLU,
                               SparseSequential, apply_layer)
from .fuse import fuse_bn_weights, fuse_conv_bn
from .quantize import (QuantizedSparseConv, _f32_scalar, dequantize,
                       quantize_tensor)

__all__ = ["fake_quant", "fake_quant_per_channel", "QATConvBnReLU",
           "QATQuantStub", "QuantizedSequential", "finalize_qat",
           "prepare_qat", "qat_observe", "convert_qat"]

_EMA = 0.95  # the scale observers' momentum


def _quant_dequant(x: torch.Tensor, s: torch.Tensor, qmin: int,
                   qmax: int) -> torch.Tensor:
    q = torch.clamp(torch.round(x / s), qmin, qmax) * s
    return x + (q - x).detach()


def fake_quant(x: torch.Tensor, scale: torch.Tensor, qmin: int = -127,
               qmax: int = 127) -> torch.Tensor:
    """Per-tensor symmetric fake quantization, ``clip(round(x / s)) * s``
    with ``s = max(scale, 1e-8)`` (rounding half to even), and the
    straight-through gradient: ``x + (q - x).detach()``, so ``x`` gets the
    incoming gradient as it is and ``scale`` none."""
    return _quant_dequant(x, torch.clamp(scale, min=1e-8), qmin, qmax)


def fake_quant_per_channel(w: torch.Tensor, scale: torch.Tensor,
                           axis: int = 0, qmin: int = -127,
                           qmax: int = 127) -> torch.Tensor:
    """:func:`fake_quant` with one scale per index of ``axis``."""
    shape = [1] * w.ndim
    shape[axis] = -1
    return _quant_dequant(w, torch.clamp(scale.reshape(shape), min=1e-8),
                          qmin, qmax)


def _ema(old: torch.Tensor, amax: torch.Tensor,
         m: float = _EMA) -> torch.Tensor:
    """``m * old + (1 - m) * amax / 127``, the JAX observers' EMA, in f32
    and in the JAX order (dividing by a 0-d tensor: on CUDA a Python
    divisor would be a multiply by its reciprocal)."""
    return m * old + (1 - m) * amax / _f32_scalar(127.0, old.device)


def _amax(x: SparseConvTensor) -> torch.Tensor:
    """``max |features|`` over the active rows, f32 (0 with none)."""
    feats = x.features.float()
    return torch.where(x.valid_mask[:, None], feats,
                       torch.zeros_like(feats)).abs().max()


class QATConvBnReLU(SparseModule):
    """Fused conv(+BN)(+ReLU) with fake-quantized weights and activations:
    the conv runs with the BN-folded weight and bias
    (:meth:`folded_weight_bias`), the weight fake-quantized per output
    channel at ``w_scale``, then the ReLU, then the output fake-quantized
    at ``act_scale`` (inactive rows 0), so the training-time rounding is
    the deployed int8 conv's.

    BN is folded with its running statistics, which get no gradient
    ("BN-frozen" QAT: the flow starts from a float-pretrained net);
    gradients reach the conv weight and BN's ``weight`` and ``bias``
    through the fold.  ``w_scale`` ``[K]`` and ``act_scale`` (0-d) are f32
    buffers, 0.05 at first, advanced by :meth:`observe` or
    :func:`qat_observe`.  The module's mode does not change its
    forward."""

    def __init__(self, conv: SparseConvolution, bn: Optional[BatchNorm1d],
                 relu: bool = True):
        super().__init__()
        self.conv = conv
        self.bn = bn
        self.relu = relu
        dev = conv.weight.device
        self.register_buffer("w_scale", torch.full(
            (conv.weight.shape[0],), 0.05, dtype=torch.float32, device=dev))
        self.register_buffer("act_scale", torch.tensor(
            0.05, dtype=torch.float32, device=dev))

    def folded_weight_bias(self) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
        """The BN-folded KRSC weight and bias (``quantization.fuse.
        fuse_bn_weights`` with the running statistics), the tensors the
        deployed int8 conv quantizes; the conv's own without BN."""
        if self.bn is None:
            return self.conv.weight, self.conv.bias
        bn = self.bn
        gamma = (bn.weight if bn.weight is not None
                 else torch.ones_like(bn.running_mean))
        beta = (bn.bias if bn.bias is not None
                else torch.zeros_like(bn.running_mean))
        return fuse_bn_weights(self.conv.weight, self.conv.bias,
                               bn.running_mean.detach(),
                               bn.running_var.detach(), bn.eps, gamma, beta)

    @torch.no_grad()
    def _observe_scales(self, out: SparseConvTensor) -> None:
        w = self.folded_weight_bias()[0].float()
        wmax = w.reshape(w.shape[0], -1).abs().amax(1)
        self.act_scale.copy_(_ema(self.act_scale, _amax(out)))
        self.w_scale.copy_(_ema(self.w_scale, wmax))

    @torch.no_grad()
    def observe(self, x: SparseConvTensor) -> "QATConvBnReLU":
        """Advances ``act_scale`` (by this batch's output) and ``w_scale``
        (by the folded weight) by their EMA, in place; returns ``self``."""
        self._observe_scales(self(x))
        return self

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        w, b = self.folded_weight_bias()
        params = {"weight": fake_quant_per_channel(w, self.w_scale)}
        if b is not None:
            params["bias"] = b
        out = functional_call(self.conv, params, (x,))
        if self.relu:
            out = out.replace_feature(F.relu(out.features))
        return out.replace_feature_masked(
            fake_quant(out.features, self.act_scale))


class QATQuantStub(SparseModule):
    """Input fake-quant stub: learns the network input's scale by EMA
    (``scale``, a 0-d f32 buffer, 0.05 at first) so that
    :func:`convert_qat` knows how to quantize real inputs.  ``device``
    None is the CUDA card."""

    def __init__(self, momentum: float = 0.95, device=None):
        super().__init__()
        self.momentum = momentum
        self.register_buffer("scale", torch.tensor(
            0.05, dtype=torch.float32, device=default_device(device)))

    @torch.no_grad()
    def observe_forward(self, x: SparseConvTensor
                        ) -> Tuple["QATQuantStub", SparseConvTensor]:
        """Advances ``scale`` by this batch, in place, and returns
        ``(self, output)`` with the new scale."""
        self.scale.copy_(_ema(self.scale, _amax(x), self.momentum))
        return self, self(x)

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        return x.replace_feature_masked(fake_quant(x.features, self.scale))


def _observe_qat_conv(m: QATConvBnReLU, x: SparseConvTensor
                      ) -> Tuple[QATConvBnReLU, SparseConvTensor]:
    """One QAT module's observation, in place under ``torch.no_grad()``:
    BN's running statistics advanced by the float conv's output on ``x``
    (``BatchNorm1d.updated``), then the module's output with them, then the
    scale EMAs.  The second conv call runs on ``x`` carrying the first
    one's ``indice_dict``, so it reuses the match tables the first built
    (a subm table under its ``indice_key``, a regular conv's record under
    ``__dgreg__<indice_key>``; a regular conv without a key keeps no
    record and discovers its outputs again).  Returns ``(m, output)``."""
    with torch.no_grad():
        if m.bn is not None:
            pre = m.conv(x)
            m.bn.updated(pre)
            x = x.shadow_copy()
            x.indice_dict = dict(pre.indice_dict)
        out = m(x)
        m._observe_scales(out)
    return m, out


def prepare_qat(seq: SparseSequential) -> SparseSequential:
    """Whole-net QAT preparation: a new :class:`SparseSequential` led by a
    :class:`QATQuantStub` (on the net's device), in which every conv (->
    BatchNorm1d) (-> SparseReLU) chain of ``seq`` is one
    :class:`QATConvBnReLU`; other layers follow as they are.  The new net
    holds copies of ``seq``'s layers, so training it leaves ``seq`` as it
    was.  Train it as usual (gradients pass the fake quantization
    straight through), calling :func:`qat_observe` in each step, then
    :func:`convert_qat`."""
    if not isinstance(seq, SparseSequential):
        raise TypeError("prepare_qat expects a SparseSequential (a "
                        "structural rewrite)")
    layers = [copy.deepcopy(layer) for layer in seq]
    dev = next((p.device for p in seq.parameters()), None)
    out: List[nn.Module] = [QATQuantStub(device=dev)]
    i = 0
    while i < len(layers):
        layer = layers[i]
        if isinstance(layer, SparseConvolution):
            bn, relu = None, False
            j = i + 1
            if j < len(layers) and isinstance(layers[j], BatchNorm1d):
                bn = layers[j]
                j += 1
            if j < len(layers) and isinstance(layers[j], SparseReLU):
                relu = True
                j += 1
            out.append(QATConvBnReLU(layer, bn, relu=relu))
            i = j
        else:
            out.append(layer)
            i += 1
    return SparseSequential(*out)


def qat_observe(seq: SparseSequential, x: SparseConvTensor
                ) -> Tuple[SparseSequential, SparseConvTensor]:
    """One observation pass through a prepared net, in place under
    ``torch.no_grad()``: the stub's input scale and every QAT module's
    scales advance by EMA, and the BN statistics they fold advance by the
    batch.  Any other layer runs in training mode (its mode restored
    after), as the JAX function runs it with ``training=True``; a bare
    ``BatchNorm1d`` there keeps its running statistics.  Returns ``(seq,
    output)``."""
    cur = x
    with torch.no_grad():
        for layer in seq:
            if isinstance(layer, QATQuantStub):
                _, cur = layer.observe_forward(cur)
            elif isinstance(layer, QATConvBnReLU):
                _, cur = _observe_qat_conv(layer, cur)
            else:
                was = layer.training
                layer.train(True)
                try:
                    cur = apply_layer(layer, cur)
                finally:
                    layer.train(was)
    return seq, cur


class QuantizedSequential(SparseModule):
    """The deployable int8 net that :func:`convert_qat` makes: quantizes
    the input once at ``input_scale`` (and sets the tensor's ``q_scale``),
    runs ``layers`` (the int8 convs on B7; other layers pass through on
    the int8 features), and dequantizes the output at ``out_scale``
    (``q_scale`` None again).  ``layers`` is a ``ModuleList``, so the
    state-dict keys are the JAX module's (``layers.<i>.``)."""

    def __init__(self, input_scale: float, layers, out_scale: float):
        super().__init__()
        self.input_scale = float(input_scale)
        self.layers = nn.ModuleList(layers)
        self.out_scale = float(out_scale)

    def extra_repr(self) -> str:
        return (f"input_scale={self.input_scale:.6g}, "
                f"out_scale={self.out_scale:.6g}")

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        cur = x.replace_feature(quantize_tensor(x.features, self.input_scale))
        cur.q_scale = _f32_scalar(self.input_scale, x.features.device)
        for layer in self.layers:
            cur = apply_layer(layer, cur)
        out = cur.replace_feature(dequantize(cur.features, self.out_scale))
        out.q_scale = None
        return out


def convert_qat(seq: SparseSequential) -> QuantizedSequential:
    """A prepared (and trained) net -> its int8 :class:`QuantizedSequential`:
    every :class:`QATConvBnReLU` becomes a ``QuantizedSparseConv``
    (:func:`finalize_qat`) whose input scale is its predecessor's
    activation scale (the stub's for the first); other layers pass through
    and the chain assumes they keep the scale.  Reads the scales on the
    host, once."""
    layers = list(seq) if isinstance(seq, SparseSequential) else None
    if not layers or not isinstance(layers[0], QATQuantStub):
        raise TypeError("convert_qat expects a net built by prepare_qat "
                        "(a SparseSequential led by a QATQuantStub)")
    prev_scale = float(layers[0].scale)
    input_scale = prev_scale
    out_layers: List[nn.Module] = []
    for layer in layers[1:]:
        if isinstance(layer, QATConvBnReLU):
            out_layers.append(finalize_qat(layer, prev_scale))
            prev_scale = float(layer.act_scale)
        else:
            out_layers.append(layer)
    return QuantizedSequential(input_scale, out_layers, prev_scale)


def finalize_qat(m: QATConvBnReLU, input_scale: float
                 ) -> QuantizedSparseConv:
    """One QAT module -> its deployable ``QuantizedSparseConv``: the conv
    with BN folded (running statistics), quantized per channel at
    ``w_scale``, from ``input_scale`` to ``act_scale``, with the ReLU
    fused when the module has one."""
    conv = m.conv if m.bn is None else fuse_conv_bn(m.conv, m.bn)
    return QuantizedSparseConv(
        conv, m.w_scale.detach().cpu().numpy(), float(input_scale),
        float(m.act_scale), act_type="relu" if m.relu else "none")
