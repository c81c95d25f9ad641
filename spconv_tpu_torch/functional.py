"""Functional API (counterpart of ``spconv_tpu/functional.py``):
``sparse_add`` for tensors whose active sites differ."""

from __future__ import annotations

from typing import Optional

import torch

from .core import SparseConvTensor
from .ops import coords as C

__all__ = ["sparse_add", "sparse_add_hash_based"]


def sparse_add(*tens: SparseConvTensor,
               out_bound: Optional[int] = None) -> SparseConvTensor:
    """Sum of sparse tensors whose active sites may differ.  The result's
    sites are the union, in ascending key order with the invalid rows at the
    tail (``keys_sorted``), cut at ``out_bound`` rows (default: the
    operands' rows together, rounded up to a multiple of 128); each site's
    features are the sum of its rows, added in the feature dtype.

    One stable sort of every operand's keys marks each site's first row;
    rows scatter-add into their site's position.  ``num_voxels`` is a 0-d
    device tensor, so nothing is read back to the host.  The cached
    rulebooks are dropped (the rows move), as the JAX package drops them;
    use ``AddTable`` for tensors of one site set to keep them."""
    if not tens:
        raise ValueError("sparse_add needs at least one tensor")
    first = tens[0]
    for t in tens[1:]:
        if (t.spatial_shape != first.spatial_shape
                or t.batch_size != first.batch_size
                or t.features.shape[1] != first.features.shape[1]):
            raise ValueError("sparse_add operands need one spatial shape, "
                             "batch size and channel count")
    total = sum(t.features.shape[0] for t in tens)
    if out_bound is None:
        out_bound = -(-total // 128) * 128

    keys = []
    for t in tens:
        k, sentinel = C.linearize(t.indices, first.spatial_shape,
                                  first.batch_size)
        keys.append(k)
    all_keys = torch.cat(keys)
    all_feats = torch.cat([t.features for t in tens])
    all_inds = torch.cat([t.indices for t in tens])

    sk, order = C.sort_with_ids(all_keys)
    not_sent = sk != sentinel
    is_first = torch.cat([not_sent[:1], (sk[1:] != sk[:-1]) & not_sent[1:]])
    uniq_pos = torch.cumsum(is_first, 0, dtype=torch.int32) - 1
    num_out = is_first.sum(dtype=torch.int32).clamp(max=out_bound)

    pos_of = torch.empty_like(uniq_pos)
    pos_of[order] = uniq_pos
    valid = (all_keys != sentinel) & (pos_of < out_bound)
    # rows past the bound and invalid rows write one spare row, cut below;
    # the rows of one site carry the same coordinates
    scatter_pos = torch.where(valid, pos_of, torch.full_like(pos_of,
                                                             out_bound)).long()
    feats = torch.where(valid[:, None], all_feats,
                        torch.zeros_like(all_feats))
    out_feats = all_feats.new_zeros((out_bound + 1, all_feats.shape[1]))
    out_feats.index_add_(0, scatter_pos, feats)
    out_inds = torch.full((out_bound + 1, all_inds.shape[1]), -1,
                          dtype=torch.int32, device=all_inds.device)
    out_inds[scatter_pos] = all_inds.int()
    return SparseConvTensor(out_feats[:out_bound], out_inds[:out_bound],
                            first.spatial_shape, first.batch_size,
                            num_voxels=num_out, keys_sorted=True)


# the reference has a torch.sparse and a hash based variant; this sort-based
# one serves both
sparse_add_hash_based = sparse_add
