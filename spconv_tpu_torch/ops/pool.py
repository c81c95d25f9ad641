"""Sparse pooling compute (counterpart of ``spconv_tpu/ops/pool.py``).

``pool2_seg``, the kernel-2 / stride-2 / pad-0 max or mean pool of the
segment route; ``indice_maxpool`` and ``indice_avgpool``, the native
path's pools over a rulebook's ``pair_fwd``; and ``global_pool``.  All are
plain tensor code in the JAX package too (no Pallas kernel), so they stay
torch ops here and differentiate through autograd.  The sorted-key route
of the 2x pool, which runs kernel B6, is ``ops/sorted_pool.py``.
``pool2_seg`` opens a ``spconv.rulebook`` span around its output discovery
and a ``spconv.pool`` span around its reduction (``tracing``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..tracing import span
from . import coords as C
from .rulebook import pool2_parent_keys, unique_sorted_keys

__all__ = ["pool2_seg", "indice_maxpool", "indice_avgpool", "global_pool"]

_MODES = ("max", "mean")

# elements of one [chunk, N, C] gather of the native pools, at most (the
# JAX package's _POOL_CHUNK_BUDGET, whose chunking decides where the max's
# gradient splits at ties)
_POOL_CHUNK_BUDGET = 64 * 1024 * 1024


def _pool_chunks(kv: int, n: int, c: int):
    per = max(1, min(kv, _POOL_CHUNK_BUDGET // max(1, n * c)))
    return [list(range(i, min(i + per, kv))) for i in range(0, kv, per)]


def _gathered(features: torch.Tensor, pair_fwd: torch.Tensor, pad: float):
    """``[kv, N_out]`` row indices into ``features`` in f32 with a row of
    ``pad`` appended, which the absent pairs (-1) point at."""
    c = features.shape[1]
    fpad = torch.cat([features.float(),
                      torch.full((1, c), pad, dtype=torch.float32,
                                 device=features.device)])
    pf = torch.where(pair_fwd >= 0, pair_fwd,
                     torch.full_like(pair_fwd, features.shape[0])).long()
    return fpad, pf


def indice_maxpool(features: torch.Tensor,
                   pair_fwd: torch.Tensor) -> torch.Tensor:
    """``out[o]`` = the max over the present pairs ``k`` of
    ``features[pair_fwd[k, o]]``, in f32, rounded once to the feature
    dtype; a max that is not finite (no pair, or only -inf) is 0.  The
    offsets are gathered in the JAX package's chunks: ``torch.amax``
    within a chunk and ``torch.maximum`` across chunks split the gradient
    at ties as ``jnp.max`` and ``jnp.maximum`` do (evenly among equal
    values, and in half)."""
    kv, n_out = pair_fwd.shape
    c = features.shape[1]
    fpad, pf = _gathered(features, pair_fwd, float("-inf"))
    acc = torch.full((n_out, c), float("-inf"), dtype=torch.float32,
                     device=features.device)
    for ch in _pool_chunks(kv, n_out, c):
        acc = torch.maximum(acc, torch.amax(fpad[pf[ch[0]:ch[-1] + 1]],
                                            dim=0))
    acc = torch.where(torch.isfinite(acc), acc, torch.zeros_like(acc))
    return acc.to(features.dtype)


def indice_avgpool(features: torch.Tensor,
                   pair_fwd: torch.Tensor) -> torch.Tensor:
    """``out[o]`` = the mean over the present pairs of
    ``features[pair_fwd[k, o]]``, summed in f32 and divided by their count
    (at least 1), rounded once to the feature dtype."""
    kv, n_out = pair_fwd.shape
    c = features.shape[1]
    fpad, pf = _gathered(features, pair_fwd, 0.0)
    acc = torch.zeros((n_out, c), dtype=torch.float32,
                      device=features.device)
    for ch in _pool_chunks(kv, n_out, c):
        acc = acc + fpad[pf[ch[0]:ch[-1] + 1]].sum(dim=0)
    cnt = (pair_fwd >= 0).float().sum(dim=0)[:, None]
    return (acc / cnt.clamp(min=1.0)).to(features.dtype)


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"pool mode must be one of {_MODES}, got {mode!r}")


def pool2_seg(
    features: torch.Tensor,
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_bound: int,
    mode: str = "max",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Output discovery and reduction for the 2x/stride-2 pool.

    One stable sort of the parent keys puts every output's children next to
    each other; a scatter over the (non-decreasing) segment ids reduces
    them.  Semantics kept from the JAX package:

    * inputs on an odd edge fall outside the last full window and are
      dropped (VALID pooling);
    * at most ``out_bound`` outputs are kept, those with the smallest parent
      keys, and ``num_out_total`` counts the outputs before that cut;
    * ``"max"`` stays in the feature dtype; output rows that have no input
      are masked by presence (a genuine -inf or NaN feature survives);
    * ``"mean"`` sums in f32, divides by the number of children (at least
      1) and rounds once to the feature dtype;
    * outputs come in ascending key order, so the result is key-sorted.

    Returns ``(features [out_bound, C], indices [out_bound, ndim+1],
    num_out, num_out_total)``, the counts as 0-d int32 tensors.
    """
    _check_mode(mode)
    c = features.shape[1]
    with span("spconv.rulebook"):
        keys, sentinel, out_shape = pool2_parent_keys(indices, spatial_shape,
                                                      batch_size)
        sk, order = torch.sort(keys, stable=True)
        out_keys, uniq_pos, num_out_total = unique_sorted_keys(sk, sentinel,
                                                               out_bound)
        not_sent = sk != sentinel
        seg = torch.where(not_sent & (uniq_pos < out_bound), uniq_pos,
                          torch.full_like(uniq_pos, out_bound))
        out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
        num_out = torch.clamp(num_out_total, max=out_bound)

    with span("spconv.pool"):
        g = features[order]
        if mode == "max":
            acc = torch.full((out_bound + 1, c), float("-inf"),
                             dtype=features.dtype, device=features.device)
            acc = acc.scatter_reduce(0, seg[:, None].expand(-1, c), g,
                                     "amax", include_self=True)
            present = (torch.arange(out_bound, device=features.device)
                       < num_out_total)[:, None]
            out_feat = torch.where(present, acc[:out_bound],
                                   torch.zeros((), dtype=features.dtype,
                                               device=features.device))
        else:
            acc = torch.zeros((out_bound + 1, c), dtype=torch.float32,
                              device=features.device).index_add(
                                  0, seg, g.float())
            cnt = torch.zeros((out_bound + 1,), dtype=torch.float32,
                              device=features.device).index_add(
                                  0, seg, not_sent.float())
            out_feat = (acc[:out_bound] / cnt[:out_bound, None].clamp(
                min=1.0)).to(features.dtype)
    return out_feat, out_indices, num_out, num_out_total


def global_pool(features: torch.Tensor, indices: torch.Tensor,
                batch_size: int, mode: str = "max") -> torch.Tensor:
    """Max or mean over each batch element's active rows -> dense ``[B,
    C]`` in the feature dtype, reduced in f32.  A batch element with no
    active row (or a max that is not finite) gives 0; the mean divides by
    the active count (at least 1)."""
    _check_mode(mode)
    c = features.shape[1]
    valid = indices[:, 0] >= 0
    seg = torch.where(valid, indices[:, 0].long(),
                      torch.full_like(indices[:, 0], batch_size).long())
    f = features.float()
    if mode == "max":
        src = torch.where(valid[:, None], f, float("-inf"))
        acc = torch.full((batch_size + 1, c), float("-inf"),
                         dtype=torch.float32, device=features.device)
        acc = acc.scatter_reduce(0, seg[:, None].expand(-1, c), src, "amax",
                                 include_self=True)[:batch_size]
        out = torch.where(torch.isfinite(acc), acc, 0.0)
    else:
        zeros = torch.zeros((batch_size + 1, c), dtype=torch.float32,
                            device=features.device)
        s = zeros.index_add(0, seg, torch.where(valid[:, None], f, 0.0))
        cnt = torch.zeros((batch_size + 1,), dtype=torch.float32,
                          device=features.device).index_add(0, seg,
                                                            valid.float())
        out = s[:batch_size] / cnt[:batch_size, None].clamp(min=1.0)
    return out.to(features.dtype)
