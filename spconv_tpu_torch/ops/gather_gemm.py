"""Sparse conv compute on a rulebook (counterpart of
``spconv_tpu/ops/gather_gemm.py``): the native path's three functions on
the pair tables of ``ops.rulebook``, and ``indice_conv`` with its backward.

* ``gather_mm``: ``out[o] = sum_k features[pair_fwd[k, o]] @ W[k]``;
* ``dgrad_gather_mm``: ``din[i] = sum_k dout[pair_bwd[k, i]] @ W[k]^T``;
* ``wgrad_gather_mm``: ``dW[k] = sum_o features[pair_fwd[k, o]]^T dout[o]``.

A pair table ``[kv, N_dst]`` int32 with -1 where no pair exists is the
contract of the port's gather-GEMM kernels, so these run them: B2
(``ops.dg_conv.dg_fwd``, ``csrc/dg_fwd.cu``) forward, its dgrad mode on
``pair_bwd``, and the wgrad kernel (``csrc/dg_wgrad.cu``), each with
``path="native"``, so their launches count apart
(``dg_fwd_native``, ``dg_dgrad_native``, ``dg_wgrad_native``).  The JAX
package's chunked ``take`` + ``einsum`` (a Mosaic workaround that
materialises the gathered rows) has no counterpart: B2 gathers inside the
GEMM.  On CPU tensors the wrappers take their plain versions.

Every sum accumulates in f32 and rounds once, as the JAX default
``fp32_accum=True`` does; ``fp32_accum=False`` (accumulation in the
feature dtype) is not ported and raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import dg_conv as D

__all__ = ["indice_conv", "gather_mm", "dgrad_gather_mm", "wgrad_gather_mm",
           "IndiceConvFn"]


def _check_accum(accum_dtype) -> None:
    if accum_dtype != torch.float32:
        raise NotImplementedError(
            f"accum_dtype={accum_dtype}: the port accumulates in float32 "
            "only (fp32_accum=False is not ported)")


def gather_mm(features: torch.Tensor, weight_kv: torch.Tensor,
              pair_fwd: torch.Tensor, subm_center: Optional[int],
              accum_dtype=torch.float32,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out[o] = sum_k features[pair_fwd[k, o]] @ weight_kv[k]`` ->
    ``[N_out, K]``.  ``features`` ``[N_in, C]``, ``weight_kv`` ``[kv, C,
    K]`` of the same dtype, ``pair_fwd`` ``[kv, N_out]`` int32 in ``[-1,
    N_in)``.  ``subm_center`` is not read: a subm rulebook's centre offset
    is the identity table, which B2 gathers like any other."""
    del subm_center
    _check_accum(accum_dtype)
    out = D.dg_fwd(features, weight_kv.contiguous(), pair_fwd,
                   path="native")
    return out if out_dtype is None else out.to(out_dtype)


def dgrad_gather_mm(dout: torch.Tensor, weight_kv: torch.Tensor,
                    pair_bwd: torch.Tensor, subm_center: Optional[int],
                    accum_dtype=torch.float32,
                    out_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """``din[i] = sum_k dout[pair_bwd[k, i]] @ weight_kv[k]^T`` -> ``[N_in,
    C]`` (B2's dgrad mode, which reads ``W[k]^T`` from the weight as it
    is).  ``subm_center`` is not read."""
    del subm_center
    _check_accum(accum_dtype)
    out = D.dg_dgrad(dout, weight_kv.contiguous(), pair_bwd, path="native")
    return out if out_dtype is None else out.to(out_dtype)


def wgrad_gather_mm(features: torch.Tensor, dout: torch.Tensor,
                    pair_fwd: torch.Tensor, subm_center: Optional[int],
                    accum_dtype=torch.float32,
                    out_dtype: Optional[torch.dtype] = None,
                    pair_bwd: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``dW[k] = sum_o features[pair_fwd[k, o]]^T dout[o]`` -> ``[kv, C,
    K]``.  With ``pair_bwd`` given, which must then be ``pair_fwd``'s mirror
    (``pair_bwd[k, i] = o`` exactly where ``pair_fwd[k, o] = i``, as every
    conv rulebook's is), the same sum walks the input rows:
    ``dg_wgrad(features, dout, pair_bwd)``.  Without it, the kernel walks
    the output rows, ``dg_wgrad(dout, features, pair_fwd)`` transposed,
    which holds for any table (a pool rulebook's too).  ``subm_center`` is
    not read."""
    del subm_center
    _check_accum(accum_dtype)
    if pair_bwd is not None:
        dw = D.dg_wgrad(features, dout, pair_bwd, path="native")
    else:
        dw = D.dg_wgrad(dout, features, pair_fwd,
                        path="native").transpose(1, 2).contiguous()
    return dw if out_dtype is None else dw.to(out_dtype)


class IndiceConvFn(torch.autograd.Function):
    """:func:`gather_mm` on ``pair_fwd`` with the JAX package's VJP
    (``_indice_conv_bwd``): ``dout`` cast to the features' dtype, ``din``
    from :func:`dgrad_gather_mm` on ``pair_bwd`` (skipped when the features
    need no gradient) and ``dW`` from :func:`wgrad_gather_mm`, over
    ``pair_bwd`` when the tables are mirrors (``mirrored``), else over
    ``pair_fwd``, the JAX package's walk."""

    @staticmethod
    def forward(ctx, x, weight_kv, pair_fwd, pair_bwd, mirrored):
        ctx.save_for_backward(x, weight_kv, pair_fwd, pair_bwd)
        ctx.mirrored = mirrored
        return gather_mm(x, weight_kv, pair_fwd, None)

    @staticmethod
    def backward(ctx, dout):
        x, weight_kv, pair_fwd, pair_bwd = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        din = dw = None
        if ctx.needs_input_grad[0]:
            din = dgrad_gather_mm(dout, weight_kv, pair_bwd, None)
        if ctx.needs_input_grad[1]:
            dw = wgrad_gather_mm(x, dout, pair_fwd, None,
                                 pair_bwd=pair_bwd if ctx.mirrored else None)
        return din, dw, None, None, None


def indice_conv(features: torch.Tensor, weight: torch.Tensor,
                pair_fwd: torch.Tensor, pair_bwd: torch.Tensor, *,
                is_subm: bool, fp32_accum: bool = True,
                algo: Optional[str] = None,
                mirrored: bool = True) -> torch.Tensor:
    """Sparse conv of ``features`` ``[N_in, C]`` through a rulebook's
    tables with a KRSC ``weight`` ``[K, *ksize, C]`` -> ``[N_out, K]``.
    When grad mode is on and ``features`` or ``weight`` needs a gradient,
    the call is recorded through :class:`IndiceConvFn`.  ``mirrored``
    (the port's own): False for a table pair that is not each other's
    mirror (``IndiceData.rank_slots``, and an inverse conv on such a
    record), whose ``dW`` must walk ``pair_fwd``.  ``is_subm`` and
    ``algo`` are not read (every algo is the native path here)."""
    del is_subm, algo
    if not fp32_accum:
        raise NotImplementedError("fp32_accum=False is not ported: the "
                                  "port accumulates in float32")
    kv = int(np.prod(weight.shape[1:-1]))
    D._check(pair_fwd.shape[0] == kv and pair_bwd.shape[0] == kv,
             f"pair tables have {pair_fwd.shape[0]} and {pair_bwd.shape[0]} "
             f"offsets, the weight {kv}")
    D._check(pair_bwd.shape[1] == features.shape[0],
             f"pair_bwd has {pair_bwd.shape[1]} rows, features "
             f"{features.shape[0]}")
    weight_kv = D.weight_krsc_to_kv(weight)
    if D._wants_grad(features, weight):
        return IndiceConvFn.apply(features, weight_kv, pair_fwd, pair_bwd,
                                  mirrored)
    return gather_mm(features, weight_kv, pair_fwd, None)
