"""Spatial utilities (counterpart of ``spconv_tpu/modules/spatial.py``).

``RemoveDuplicate`` keeps one row per site.  The buffer keeps its size: the
first row of each run of equal keys (in input order) is kept, the others
are invalidated (indices -1, features 0) and moved to the tail, so the
result is key-sorted with the invalid rows last."""

from __future__ import annotations

from typing import Optional

import torch

from ..core import SparseConvTensor
from ..ops import coords as C
from .modules import SparseModule

__all__ = ["RemoveDuplicate"]


class RemoveDuplicate(SparseModule):
    """Drops rows whose coordinates repeat an earlier row's.  The result is
    ``keys_sorted`` with a device ``num_voxels``; its cached rulebooks are
    dropped (the rows move)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name

    def forward(self, x: SparseConvTensor) -> SparseConvTensor:
        keys, sent = C.linearize(x.indices, x.spatial_shape, x.batch_size)
        sk, order = C.sort_with_ids(keys)
        not_sent = sk != sent
        is_first = torch.cat([not_sent[:1],
                              (sk[1:] != sk[:-1]) & not_sent[1:]])
        feats = x.features[order]
        inds = x.indices[order]
        feats = torch.where(is_first[:, None], feats, torch.zeros_like(feats))
        inds = torch.where(is_first[:, None], inds, torch.full_like(inds, -1))
        # the invalidated duplicates to the tail: a second stable sort, on
        # which only the (identical) invalid rows tie
        resort = torch.where(is_first, sk, torch.full_like(sk, sent))
        order2 = torch.sort(resort, stable=True).indices
        return SparseConvTensor(
            feats[order2], inds[order2], x.spatial_shape, x.batch_size,
            num_voxels=is_first.sum(dtype=torch.int32), keys_sorted=True)
