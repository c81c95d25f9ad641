"""Sparse pooling compute (counterpart of ``spconv_tpu/ops/pool.py``).

Only ``pool2_seg`` is ported: the kernel-2 / stride-2 / pad-0 max pool that
the benchmark net runs.  It is plain tensor code in the JAX package too (no
Pallas kernel), so it stays torch ops here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import coords as C
from .rulebook import unique_sorted_keys

__all__ = ["pool2_seg"]


def pool2_seg(
    features: torch.Tensor,
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_bound: int,
    mode: str = "max",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Output discovery and max reduction for the 2x/stride-2 pool.

    One stable sort of the parent keys puts every output's children next to
    each other; a scatter-max over the (non-decreasing) segment ids reduces
    them.  Semantics kept from the JAX package:

    * inputs on an odd edge fall outside the last full window and are
      dropped (VALID pooling);
    * at most ``out_bound`` outputs are kept, those with the smallest parent
      keys, and ``num_out_total`` counts the outputs before that cut;
    * the max stays in the feature dtype; output rows that have no input
      are masked by presence (a genuine -inf or NaN feature survives);
    * outputs come in ascending key order, so the result is key-sorted.

    Returns ``(features [out_bound, C], indices [out_bound, ndim+1],
    num_out, num_out_total)``, the counts as 0-d int32 tensors.
    """
    if mode != "max":
        raise NotImplementedError(
            f"pool2_seg mode {mode!r}: only max pooling is ported "
            "(ROADMAP A7)")
    c = features.shape[1]
    ndim = indices.shape[1] - 1
    out_shape = C.get_conv_output_size(
        spatial_shape, (2,) * ndim, (2,) * ndim, (0,) * ndim, (1,) * ndim)
    oc = torch.div(indices[:, 1:], 2, rounding_mode="floor")
    # per-axis compares against Python ints: a device tensor made from a
    # list would cost a blocking host-to-device copy per call
    valid = indices[:, 0] >= 0
    for a, s in enumerate(out_shape):
        valid &= oc[:, a] < s
    out_c = torch.cat([indices[:, :1], oc], dim=-1)
    keys, sentinel = C.linearize(out_c, out_shape, batch_size, valid)

    sk, order = torch.sort(keys, stable=True)
    out_keys, uniq_pos, num_out_total = unique_sorted_keys(sk, sentinel,
                                                           out_bound)
    seg = torch.where((sk != sentinel) & (uniq_pos < out_bound), uniq_pos,
                      torch.full_like(uniq_pos, out_bound))

    g = features[order]
    acc = torch.full((out_bound + 1, c), float("-inf"), dtype=features.dtype,
                     device=features.device)
    acc.scatter_reduce_(0, seg[:, None].expand(-1, c), g, "amax",
                        include_self=True)
    present = (torch.arange(out_bound, device=features.device)
               < num_out_total)[:, None]
    out_feat = torch.where(present, acc[:out_bound],
                           torch.zeros((), dtype=features.dtype,
                                       device=features.device))

    out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
    num_out = torch.clamp(num_out_total, max=out_bound)
    return out_feat, out_indices, num_out, num_out_total
