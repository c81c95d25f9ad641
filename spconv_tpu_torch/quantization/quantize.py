"""Int8 post-training quantization (counterpart of
``spconv_tpu/quantization/quantize.py``): observers, per-channel weight
quantization, the int8 conv with its fused scale / bias / ReLU / residual /
requant epilogue, and calibration and conversion of a
``SparseSequential``.

Weights are int8 per output channel, activations int8 per tensor, biases
f32.  ``QuantizedSparseConv`` runs B7 (``ops.dg_conv.dg_fwd_q``) on one of
two routes, chosen as the JAX package chooses on its TPU:

* the kernel route, on key-sorted input on a grid of int32 keys: the DG
  match tables, subm through the stage's table under ``indice_key``,
  strided through the affine table of the ``DGRegData`` record under
  ``__dgreg__<indice_key>``, inverse through that record's divide table;
* the native route everywhere else (input that is not key-sorted, a grid
  of int64 keys, an inverse conv whose regular conv left an ``IndiceData``
  rather than a DG record, and every transposed conv): the rulebook of
  ``ops.rulebook`` (reused from ``indice_key``), B7 on its ``pair_fwd``
  (``path="native"``).

Both requantize as the kernel route does, ``round(acc * (s_in * s_w /
s_out) + b / s_out)``, so the port has one int8 function.  The JAX
package's native route computes ``round((acc * s_in * s_w + b) /
s_out)``, which can land one step away at a tie (listed in ROADMAP.md).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import SparseConvTensor
from ..modules.conv import SparseConvolution
from ..modules.modules import SparseModule, SparseSequential
from ..ops.dg_conv import (SearchGeom, build_dg_pos_affine,
                           build_dg_pos_divide, dg_fwd_q, dg_fwd_q_search,
                           weight_krsc_to_kv)

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
]


class MinMaxObserver:
    """Per-tensor symmetric int8 observer over the active rows.  Reads the
    features on the host: a calibration pass syncs once per layer."""

    def __init__(self):
        self.amax = 0.0

    def observe(self, x: Union[SparseConvTensor, torch.Tensor]) -> None:
        if isinstance(x, SparseConvTensor):
            vals = x.features[x.valid_mask]
        else:
            vals = x
        vals = vals.detach().float().cpu().numpy()
        if vals.size:
            self.amax = max(self.amax, float(np.abs(vals).max()))

    @property
    def scale(self) -> float:
        return max(self.amax, 1e-8) / 127.0


class PerChannelMinMaxObserver:
    """Per-output-channel weight observer (KRSC axis 0); its scale is an
    f32 numpy array."""

    def __init__(self):
        self.amax = None

    def observe(self, w: torch.Tensor) -> None:
        w = w.detach().float().cpu().numpy()
        a = np.abs(w.reshape(w.shape[0], -1)).max(1)
        self.amax = a if self.amax is None else np.maximum(self.amax, a)

    @property
    def scale(self) -> np.ndarray:
        return np.maximum(self.amax, 1e-8) / 127.0


def _f32_scalar(value: float, device) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``device`` (a fill, no copy).  Divide
    by it, never by a Python float: on CUDA, PyTorch divides by a Python
    scalar as a multiply by its f32 reciprocal, which is not the JAX
    package's correctly rounded division."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def quantize_tensor(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, rounding half to
    even, with ``scale`` rounded to f32 as the JAX package's is."""
    q = torch.round(x.float() / _f32_scalar(scale, x.device))
    return q.clamp_(-127, 127).to(torch.int8)


def quantize_weight_per_channel(w: torch.Tensor, scale) -> torch.Tensor:
    """KRSC ``w`` quantized with one f32 scale per output channel."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
    q = torch.round(w.float() / s.reshape((-1,) + (1,) * (w.ndim - 1)))
    return q.clamp_(-127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """``f32(q) * scale``: a per-tensor float or per-channel scales."""
    s = (_f32_scalar(scale, q.device) if isinstance(scale, (int, float))
         else torch.as_tensor(scale, dtype=torch.float32, device=q.device))
    return q.float() * s


def _masked(q: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], q, torch.zeros_like(q))


class QuantizedSparseConv(SparseModule):
    """Int8 inference conv (the JAX package's ``QuantizedSparseConv``).

    Buffers (the JAX leaves, so a JAX state dict loads into it):
    ``weight_i8`` KRSC int8, ``weight_scale`` ``[K]`` f32, ``bias`` ``[K]``
    f32 or None; Python floats ``input_scale`` and ``output_scale``.  It
    computes ``act(acc * s_in * s_w + bias [+ add * add_scale]) / s_out``
    requantized to int8, as the kernel route folds it: :meth:`refold`
    derives the kernel's operands once (``scale_q``, ``bias_q`` and the
    ``[kv, K, C]`` weight ``weight_kc``, the layout B7 reads;
    non-persistent buffers).  ``weight_kv`` is its ``[kv, C, K]`` view.
    ``base``
    is a copy of the fp conv without its tensors, keeping its geometry and
    ``indice_key``."""

    def __init__(self, conv: SparseConvolution, weight_scale,
                 input_scale: float, output_scale: float,
                 act_type: str = "none"):
        super().__init__()
        if conv.act_type != "none":
            act_type = conv.act_type
        if act_type not in ("none", "relu"):
            raise ValueError(f"the int8 conv fuses 'none' or 'relu', got "
                             f"{act_type!r}")
        weight = conv.weight.detach()
        base = copy.deepcopy(conv)
        base.weight = None
        base.bias = None
        base.algo = "dg"  # the int8 route is the DG kernels', for any algo
        self.base = base
        self.register_buffer(
            "weight_i8", quantize_weight_per_channel(weight, weight_scale))
        self.register_buffer("weight_scale", torch.as_tensor(
            np.asarray(weight_scale, np.float32), device=weight.device))
        self.register_buffer(
            "bias", None if conv.bias is None
            else conv.bias.detach().float().clone())
        self.input_scale = float(input_scale)
        self.output_scale = float(output_scale)
        self.act_type = act_type
        self.refold()

    def refold(self) -> None:
        """Derives the kernel's operands from the quantized state, in f32
        and in the JAX order, on the host: ``scale_q = input_scale *
        weight_scale / output_scale``, ``bias_q = bias / output_scale``
        and ``weight_kc``.  Call it after changing
        ``weight_i8``, ``weight_scale``, ``bias`` or a scale
        (``load_jax_state_dict`` does)."""
        dev = self.weight_scale.device
        out_s = np.float32(self.output_scale)
        scale = (np.float32(self.input_scale)
                 * self.weight_scale.cpu().numpy() / out_s)
        self.register_buffer("scale_q", torch.from_numpy(scale).to(dev),
                             persistent=False)
        self.register_buffer(
            "bias_q", None if self.bias is None else torch.from_numpy(
                self.bias.cpu().numpy() / out_s).to(dev), persistent=False)
        self.register_buffer(
            "weight_kc", weight_krsc_to_kv(self.weight_i8).transpose(
                1, 2).contiguous(), persistent=False)

    @property
    def weight_kv(self) -> torch.Tensor:
        """The ``[kv, C, K]`` weight of the conv functions: a view of
        ``weight_kc``, which ``dg_fwd_q`` hands the kernel as it is."""
        return self.weight_kc.transpose(1, 2)

    def extra_repr(self) -> str:
        return (f"act_type={self.act_type!r}, input_scale="
                f"{self.input_scale:.6g}, output_scale="
                f"{self.output_scale:.6g}")

    def forward(self, x: SparseConvTensor,
                add_input: Optional[SparseConvTensor] = None,
                add_scale: float = 1.0) -> SparseConvTensor:
        cfg = self.base
        if x.features.dtype != torch.int8:
            raise TypeError(f"the int8 conv takes int8 features, got "
                            f"{x.features.dtype}")
        if add_input is not None and not cfg.subm:
            raise ValueError("the int8 residual add is subm-only (its rows "
                             "align with the output's)")
        kw = dict(act=self.act_type, add_scale=float(add_scale)
                  / self.output_scale,
                  add=None if add_input is None else add_input.features)
        w, scale, bias = self.weight_kv, self.scale_q, self.bias_q
        if cfg.transposed or not cfg._dg_supported(x):
            return self._native(x, kw)
        if cfg.subm:
            new = None
            if cfg.indice_key is None:
                geom = SearchGeom.of(cfg.kernel_size, cfg.dilation,
                                     x.spatial_shape, x.batch_size)
                q = dg_fwd_q_search(x.features, w, cfg._search_keys(x),
                                    scale, bias, geom, **kw)
            else:
                pos, _, new = cfg._stage_pos(x, need_rev=False)
                q = dg_fwd_q(x.features, w, pos, scale, bias, **kw)
            out = SparseConvTensor(
                _masked(q, x.valid_mask), x.indices, x.spatial_shape,
                x.batch_size, num_voxels=x.num_voxels,
                indice_dict=dict(x.indice_dict), keys_sorted=True)
            if new is not None:
                out.indice_dict[new[0]] = new[1]
            return out
        if cfg.inverse:
            rec, enc_in = cfg._inverse_record(x)
            if rec.pos_div is None:
                rec.pos_div = build_dg_pos_divide(
                    rec.in_keys, rec.out_keys, **_table_geom(rec, x))
            q = dg_fwd_q(x.features, w, rec.pos_div, scale, bias,
                         path="inverse", **kw)
            return SparseConvTensor(
                _masked(q, enc_in[:, 0] >= 0), enc_in, rec.in_shape,
                x.batch_size, indice_dict=dict(x.indice_dict),
                keys_sorted=True)
        rec = cfg._regular_record(x)
        if rec.pos is None:
            rec.pos = build_dg_pos_affine(rec.in_keys, rec.out_keys,
                                          **_table_geom(rec, x))
        q = dg_fwd_q(x.features, w, rec.pos, scale, bias, path="strided",
                     **kw)
        out = SparseConvTensor(
            _masked(q, rec.out_indices[:, 0] >= 0), rec.out_indices,
            rec.out_shape, x.batch_size, num_voxels=rec.num_out,
            indice_dict=dict(x.indice_dict), keys_sorted=True,
            num_out_total=rec.num_out_total)
        cfg._cache_record(x, out, rec)
        return out

    def _native(self, x: SparseConvTensor, kw: dict) -> SparseConvTensor:
        """The native route (the JAX package's ``quantize.py:337-404``):
        the conv's rulebook, reused or built as the fp conv's native path
        does (a regular or transposed one without ``output_padding``, as
        the JAX route builds it), B7 on its ``pair_fwd`` (an inverse
        conv's: the regular conv's ``pair_bwd``), and a new rulebook
        registered under a free ``indice_key``."""
        cfg = self.base
        if cfg.inverse:
            data, new = cfg._native_inverse_record(x), False
            pair_fwd, out_indices = data.pair_bwd, data.indices
            out_shape, num_out = data.spatial_shape, data.num_in
            out_sorted, total = data.in_sorted, None
        elif cfg.subm:
            data, new = cfg._native_subm_record(x)
            pair_fwd, out_indices = data.pair_fwd, x.indices
            out_shape, num_out = x.spatial_shape, x.num_voxels
            out_sorted, total = x.keys_sorted, None
        else:
            data, new = cfg._native_regular_record(
                x, out_padding=(0,) * cfg.ndim)
            pair_fwd, out_indices = data.pair_fwd, data.out_indices
            out_shape, num_out = data.out_spatial_shape, data.num_out
            out_sorted, total = True, data.num_out_total
        q = dg_fwd_q(x.features, self.weight_kv, pair_fwd, self.scale_q,
                     self.bias_q, path="native", **kw)
        out = SparseConvTensor(
            _masked(q, out_indices[:, 0] >= 0), out_indices, out_shape,
            x.batch_size, num_voxels=num_out,
            indice_dict=dict(x.indice_dict), keys_sorted=out_sorted,
            num_out_total=total)
        if (new and cfg.indice_key is not None
                and cfg.indice_key not in out.indice_dict):
            out.indice_dict[cfg.indice_key] = data
        return out


def _table_geom(rec, x: SparseConvTensor) -> dict:
    return dict(ksize=rec.ksize, stride=rec.stride, padding=rec.padding,
                dilation=rec.dilation, in_shape=rec.in_shape,
                out_shape=rec.out_shape, batch_size=x.batch_size)


class SparseConvAddReLU(QuantizedSparseConv):
    """Residual-fused int8 conv: ``relu(conv + add_input * add_scale)``,
    the add inside the epilogue.  ``add_scale`` (the residual's dequant
    scale) is set by whoever wires the residual."""

    def __init__(self, conv: SparseConvolution, weight_scale,
                 input_scale: float, output_scale: float):
        super().__init__(conv, weight_scale, input_scale, output_scale,
                         act_type="relu")
        self.add_scale = 1.0


def calibrate(seq: SparseSequential, inputs: Sequence[SparseConvTensor]):
    """Runs the calibration inputs through ``seq`` with BN folded
    (:func:`fuse.fuse_bn_act_in_sequential`), under ``torch.no_grad()``,
    recording the activation range at every layer boundary.  Returns
    ``(fused_seq, observers)``, one observer per boundary (the input
    first).  Layers keep their mode: an unfused BN should be in eval
    mode, as served."""
    from .fuse import fuse_bn_act_in_sequential

    fused = fuse_bn_act_in_sequential(seq)
    layers = list(fused.children())
    observers = [MinMaxObserver() for _ in range(len(layers) + 1)]
    with torch.no_grad():
        for x in inputs:
            observers[0].observe(x)
            cur = x
            for i, layer in enumerate(layers):
                cur = layer(cur)
                observers[i + 1].observe(cur)
    return fused, observers


def convert_to_int8(fused: SparseSequential,
                    observers: List[MinMaxObserver]) -> SparseSequential:
    """``fused`` with every fp conv replaced by a
    :class:`QuantizedSparseConv` at the calibrated scales."""
    out = []
    for i, layer in enumerate(fused.children()):
        if isinstance(layer, SparseConvolution):
            wobs = PerChannelMinMaxObserver()
            wobs.observe(layer.weight)
            layer = QuantizedSparseConv(layer, wobs.scale,
                                        observers[i].scale,
                                        observers[i + 1].scale)
        out.append(layer)
    return SparseSequential(*out)
