"""Output-site discovery and rulebooks (counterpart of
``spconv_tpu/ops/rulebook.py``).

* ``build_conv_outputs`` and ``build_deconv_outputs``: the output sites of
  a regular (strided) and of a transposed conv, which the dynamic-gather
  path needs; ``build_pool2_outputs``: those of the 2x/stride-2 pool,
  which the sorted-key pool needs.
* The rulebooks of the native path, each an ``IndiceData`` of two pair
  tables, ``pair_fwd`` ``[kv, N_out]`` (the input row feeding output ``o``
  through offset ``k``) and ``pair_bwd`` ``[kv, N_in]`` (the output row fed
  by input ``i``), -1 where there is no pair: ``build_subm_rulebook``,
  ``build_conv_rulebook`` (regular and transposed), ``build_pool2_rulebook``
  and the entry ``get_indice_pairs``.  Their integers equal the JAX
  functions' bit for bit.  The JAX package joins keys by one sort of table
  and queries and pointer doubling (a TPU workaround); here one stable sort
  of the table and ``torch.searchsorted`` find the same row.  Input rows
  need not be key-sorted.

Everything here is static-shape tensor code with no host read: the counts
come back as 0-d device tensors, so a forward never syncs on them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import IndiceData
from . import coords as C

__all__ = ["unique_sorted_keys", "pool2_parent_keys", "build_conv_outputs",
           "build_deconv_outputs", "build_pool2_outputs",
           "build_subm_rulebook", "build_conv_rulebook",
           "build_pool2_rulebook", "get_indice_pairs"]


def unique_sorted_keys(
    sk: torch.Tensor, sentinel: int, out_bound: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate ascending keys ``sk`` into a bounded buffer.

    The first key of each run of equal non-sentinel keys is an output; the
    first ``out_bound`` outputs are kept, so the largest keys are the ones
    dropped.  Returns ``(out_keys [out_bound] sentinel-padded, uniq_pos
    [len(sk)] int64 (each key's output slot, which may reach past
    out_bound), num_out_total 0-d int32 (outputs before the cut))``."""
    not_sent = sk != sentinel
    is_first = torch.cat([not_sent[:1], (sk[1:] != sk[:-1]) & not_sent[1:]])
    uniq_pos = torch.cumsum(is_first, 0) - 1
    num_out_total = is_first.sum(dtype=torch.int32)
    slot = torch.where(is_first & (uniq_pos < out_bound), uniq_pos,
                       torch.full_like(uniq_pos, out_bound))
    out_keys = torch.full((out_bound + 1,), sentinel, dtype=sk.dtype,
                          device=sk.device)
    # every kept output is written by exactly one key; the rest collide on
    # the dropped slot ``out_bound``
    out_keys[slot] = sk
    return out_keys[:out_bound], uniq_pos, num_out_total


def build_conv_outputs(
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    ksize: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    out_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Output sites of a regular conv over the active rows of ``indices``
    ``[N, ndim+1]``.

    Each input reaches at most ``prod(((k - 1) * d) // s + 1)`` outputs (8
    for a k3/s2 conv, not kv = 27); every one of them is enumerated as a
    candidate key on the output grid, the candidates are sorted, and the
    first of each run of equal keys is an output.  At most ``out_bound``
    outputs (default ``N``) are kept, those with the smallest keys, as the
    JAX package keeps them.

    Returns ``(out_indices [out_bound, ndim+1] int32 (-1 rows at the
    tail), out_keys [out_bound] int32 ascending and sentinel-padded,
    num_out, num_out_total)``, the counts as 0-d int32 tensors
    (``num_out = min(num_out_total, out_bound)``)."""
    ksize = tuple(int(k) for k in ksize)
    stride = tuple(int(s) for s in stride)
    padding = tuple(int(p) for p in padding)
    dilation = tuple(int(d) for d in dilation)
    ndim = indices.shape[1] - 1
    out_shape = C.get_conv_output_size(spatial_shape, ksize, stride, padding,
                                       dilation)
    if any(s <= 0 for s in out_shape):
        raise ValueError(f"output spatial shape {out_shape} reached zero; "
                         f"input {tuple(spatial_shape)}")
    if out_bound is None:
        out_bound = indices.shape[0]
    sentinel = C.grid_sentinel(out_shape, batch_size)

    # all candidates at once, [M, N] with M = prod(ncands): candidate j
    # moves back j_a output steps on axis a (the JAX loop's order; the
    # order does not matter, the keys are sorted).  The per-candidate step
    # comes from an arange on the device, not from a host list, so building
    # it copies nothing from the host.
    ncands = [((k - 1) * d) // s + 1
              for k, s, d in zip(ksize, stride, dilation)]
    j = torch.arange(int(np.prod(ncands)), dtype=indices.dtype,
                     device=indices.device)[:, None]
    ok = (indices[:, 0] >= 0)[None, :]
    key = indices[:, 0][None, :]
    inner = int(np.prod(ncands))
    for a in range(ndim):
        inner //= ncands[a]
        j_a = torch.remainder(torch.div(j, inner, rounding_mode="floor"),
                              ncands[a])
        ia = indices[:, a + 1] + padding[a]
        o = torch.div(ia, stride[a], rounding_mode="floor")[None, :] - j_a
        # ia - o * stride = ia mod stride + j_a * stride, never negative
        rem = ia[None, :] - o * stride[a]
        ok = (ok & (o >= 0) & (o < out_shape[a])
              & (rem <= (ksize[a] - 1) * dilation[a]))
        if dilation[a] > 1:
            ok = ok & (torch.remainder(rem, dilation[a]) == 0)
        key = key * out_shape[a] + o
    sk = torch.sort(torch.where(ok, key, sentinel).reshape(-1)).values

    out_keys, _, num_out_total = unique_sorted_keys(sk, sentinel, out_bound)
    out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
    return (out_indices, out_keys, torch.clamp(num_out_total, max=out_bound),
            num_out_total)


def build_deconv_outputs(
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    ksize: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    out_padding: Sequence[int],
    out_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Output sites of a transposed conv over the active rows of
    ``indices`` ``[N, ndim+1]``.

    Every input site ``i`` and kernel offset ``k`` give the candidate ``o =
    i * stride + k * dilation - padding`` (kept where it lies inside the
    output grid, :func:`coords.get_deconv_output_size`); the candidates are
    sorted, and the first of each run of equal keys is an output.  At most
    ``out_bound`` outputs (default ``N * prod(stride)``) are kept, those
    with the smallest keys, as the JAX package keeps them.

    Returns ``(out_indices, out_keys, num_out, num_out_total)`` as
    :func:`build_conv_outputs` does."""
    ksize = tuple(int(k) for k in ksize)
    stride = tuple(int(s) for s in stride)
    padding = tuple(int(p) for p in padding)
    dilation = tuple(int(d) for d in dilation)
    ndim = indices.shape[1] - 1
    out_shape = C.get_deconv_output_size(spatial_shape, ksize, stride,
                                         padding, dilation, out_padding)
    if any(s <= 0 for s in out_shape):
        raise ValueError(f"output spatial shape {out_shape} reached zero; "
                         f"input {tuple(spatial_shape)}")
    if out_bound is None:
        out_bound = indices.shape[0] * int(np.prod(stride))
    sentinel = C.grid_sentinel(out_shape, batch_size)

    # all candidates at once, [kv, N]: offset k's per-axis step comes from
    # an arange on the device (kernel_offsets' row-major order; the order
    # does not matter, the keys are sorted)
    kv = int(np.prod(ksize))
    j = torch.arange(kv, dtype=indices.dtype, device=indices.device)[:, None]
    ok = (indices[:, 0] >= 0)[None, :]
    key = indices[:, 0][None, :]
    inner = kv
    for a in range(ndim):
        inner //= ksize[a]
        k_a = torch.remainder(torch.div(j, inner, rounding_mode="floor"),
                              ksize[a])
        o = indices[:, a + 1][None, :] * stride[a] + k_a * dilation[a] \
            - padding[a]
        ok = ok & (o >= 0) & (o < out_shape[a])
        key = key * out_shape[a] + o
    sk = torch.sort(torch.where(ok, key, sentinel).reshape(-1)).values

    out_keys, _, num_out_total = unique_sorted_keys(sk, sentinel, out_bound)
    out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
    return (out_indices, out_keys, torch.clamp(num_out_total, max=out_bound),
            num_out_total)


def pool2_parent_keys(
    indices: torch.Tensor, spatial_shape: Sequence[int], batch_size: int
) -> Tuple[torch.Tensor, int, List[int]]:
    """Key of each row's parent in the 2x/stride-2 pool: ``(keys [N] int32,
    sentinel, out_shape)``.  A row on an odd edge falls outside the last
    full window (VALID pooling) and takes the sentinel, as an inactive row
    does."""
    ndim = indices.shape[1] - 1
    out_shape = C.get_conv_output_size(
        spatial_shape, (2,) * ndim, (2,) * ndim, (0,) * ndim, (1,) * ndim)
    oc = torch.div(indices[:, 1:], 2, rounding_mode="floor")
    # per-axis compares against Python ints: a device tensor made from a
    # list would cost a blocking host-to-device copy per call
    valid = indices[:, 0] >= 0
    for a, s in enumerate(out_shape):
        valid &= oc[:, a] < s
    keys, sentinel = C.linearize(torch.cat([indices[:, :1], oc], dim=-1),
                                 out_shape, batch_size, valid)
    return keys, sentinel, out_shape


def build_pool2_outputs(
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Output sites of the 2x/stride-2 pool over the active rows of
    ``indices`` ``[N, ndim+1]``: one sort of the parent keys, the first of
    each run of equal keys.  At most ``out_bound`` outputs (default ``N``)
    are kept, those with the smallest keys.

    Returns ``(out_indices [out_bound, ndim+1] int32 (-1 rows at the
    tail), out_keys [out_bound] int32 ascending and sentinel-padded,
    num_out, num_out_total)``, the counts as 0-d int32 tensors."""
    if out_bound is None:
        out_bound = indices.shape[0]
    keys, sentinel, out_shape = pool2_parent_keys(indices, spatial_shape,
                                                  batch_size)
    out_keys, _, num_out_total = unique_sorted_keys(
        torch.sort(keys).values, sentinel, out_bound)
    out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
    return (out_indices, out_keys, torch.clamp(num_out_total, max=out_bound),
            num_out_total)


def _kernel_offset_axes(ksize: Sequence[int], device) -> List[torch.Tensor]:
    """Per axis, the ``[kv]`` int64 kernel offset of every offset in
    :func:`coords.kernel_offsets`' row-major order, made on the device (no
    copy from the host)."""
    kv = int(np.prod(ksize))
    j = torch.arange(kv, dtype=torch.int64, device=device)
    axes, inner = [], kv
    for k in ksize:
        inner //= int(k)
        axes.append(torch.remainder(torch.div(j, inner,
                                              rounding_mode="floor"), k))
    return axes


def _lookup(table_keys: torch.Tensor, probes: torch.Tensor,
            ok: torch.Tensor) -> torch.Tensor:
    """For each probe key (where ``ok``), the row of ``table_keys`` that
    holds it, else -1, as int32.  One stable sort of the table and a binary
    search per probe; of equal table keys the last row wins, the row the
    JAX package's sort join hands on."""
    sk, order = C.sort_with_ids(table_keys.long())
    idx = torch.searchsorted(sk, probes, right=True) - 1
    at = idx.clamp(min=0)
    hit = ok & (idx >= 0) & (sk[at] == probes)
    return torch.where(hit, order[at], torch.full_like(at, -1)).int()


def build_subm_rulebook(
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    ksize: Sequence[int],
    dilation: Sequence[int],
) -> IndiceData:
    """Submanifold rulebook: the output sites are the input's.
    ``pair_fwd[k, o]`` is the row whose coordinate is row ``o``'s moved by
    ``(offset_k - centre) * dilation``, the centre offset row ``o`` itself
    (-1 for inactive rows), and ``pair_bwd`` is ``pair_fwd`` with its
    offset axis reversed.  The kernel size must be odd."""
    ksize = tuple(int(k) for k in ksize)
    dilation = tuple(int(d) for d in dilation)
    if any(k % 2 == 0 for k in ksize):
        raise ValueError("subm requires an odd kernel size")
    n, ndim = indices.shape[0], indices.shape[1] - 1
    shape = tuple(int(s) for s in spatial_shape)
    kv = int(np.prod(ksize))
    valid = indices[:, 0] >= 0
    keys, sentinel = C.linearize(indices, shape, batch_size, valid)

    ok = valid[None, :].expand(kv, n)
    probe = indices[:, 0].long()[None, :]
    for a, (off, k, d, s) in enumerate(zip(
            _kernel_offset_axes(ksize, indices.device), ksize, dilation,
            shape)):
        ca = indices[:, a + 1].long()[None, :] + ((off - k // 2) * d)[:, None]
        ok = ok & (ca >= 0) & (ca < s)
        probe = probe * s + ca
    probe = torch.where(ok, probe, torch.full_like(probe, sentinel))
    pair_fwd = _lookup(keys, probe, ok)
    # the centre offset is the identity map, duplicate coordinates or not
    iota = torch.arange(n, dtype=torch.int32, device=indices.device)
    pair_fwd[kv // 2] = torch.where(valid, iota, torch.full_like(iota, -1))
    return IndiceData(
        pair_fwd, pair_fwd.flip(0), indices, indices,
        valid.sum(dtype=torch.int32), is_subm=True, spatial_shape=shape,
        out_spatial_shape=shape, ksize=ksize, stride=(1,) * ndim,
        padding=tuple((k // 2) * d for k, d in zip(ksize, dilation)),
        dilation=dilation)


def build_conv_rulebook(
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    ksize: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    out_padding: Optional[Sequence[int]] = None,
    transposed: bool = False,
    out_bound: Optional[int] = None,
) -> IndiceData:
    """Regular (``transposed=False``) or transposed conv rulebook.

    Every (offset ``k``, input row ``i``) gives a candidate output site:
    ``(x + padding - k * dilation) / stride`` where that divides exactly,
    or with ``transposed`` ``x * stride - padding + k * dilation``, kept
    where it lies on the output grid.  The candidates' keys are sorted
    stably; the first of each run of equal keys is an output, and a
    candidate's output row is the rank of its key.  At most ``out_bound``
    outputs (default ``N``) are kept, those with the smallest keys; the
    pairs of the others are dropped and ``num_out_total`` counts them."""
    ksize = tuple(int(k) for k in ksize)
    stride = tuple(int(s) for s in stride)
    padding = tuple(int(p) for p in padding)
    dilation = tuple(int(d) for d in dilation)
    n, ndim = indices.shape[0], indices.shape[1] - 1
    kv = int(np.prod(ksize))
    if out_padding is None:
        out_padding = (0,) * ndim
    conv = (spatial_shape, ksize, stride, padding, dilation)
    out_shape = (C.get_deconv_output_size(*conv, out_padding) if transposed
                 else C.get_conv_output_size(*conv))
    if any(s <= 0 for s in out_shape):
        raise ValueError(f"output spatial shape {out_shape} reached zero; "
                         f"input {tuple(spatial_shape)}")
    if out_bound is None:
        out_bound = n
    sentinel = C.grid_sentinel(out_shape, batch_size)

    valid = (indices[:, 0] >= 0)[None, :].expand(kv, n)
    key = indices[:, 0].long()[None, :]
    for a, off in enumerate(_kernel_offset_axes(ksize, indices.device)):
        x = indices[:, a + 1].long()[None, :]
        step = (off * dilation[a])[:, None]
        if transposed:
            q = x * stride[a] - padding[a] + step
        else:
            num = x + padding[a] - step
            q = torch.div(num, stride[a], rounding_mode="floor")
            valid = valid & (torch.remainder(num, stride[a]) == 0)
        valid = valid & (q >= 0) & (q < out_shape[a])
        key = key * out_shape[a] + q
    cand = torch.where(valid, key, torch.full_like(key, sentinel))

    sk, order = C.sort_with_ids(cand.reshape(-1))
    out_keys, uniq_pos, num_out_total = unique_sorted_keys(sk, sentinel,
                                                           out_bound)
    out_pos = torch.empty_like(uniq_pos)
    out_pos[order] = uniq_pos
    out_pos = out_pos.reshape(kv, n)
    pair_valid = valid & (out_pos < out_bound)
    pair_bwd = torch.where(pair_valid, out_pos,
                           torch.full_like(out_pos, -1)).int()
    # pair_fwd[k, out_pos] = i; for a fixed k the map is injective, and
    # every dropped pair writes the spare column out_bound, cut below
    iota = torch.arange(n, dtype=torch.int32, device=indices.device)
    pair_fwd = torch.full((kv, out_bound + 1), -1, dtype=torch.int32,
                          device=indices.device)
    rows = torch.arange(kv, device=indices.device)[:, None].expand(kv, n)
    pair_fwd[rows, torch.where(pair_valid, out_pos,
                               torch.full_like(out_pos, out_bound))] = \
        torch.where(pair_valid, iota[None, :], torch.full_like(pair_bwd, -1))
    out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
    return IndiceData(
        pair_fwd[:, :out_bound].contiguous(), pair_bwd, out_indices, indices,
        torch.clamp(num_out_total, max=out_bound),
        num_out_total=num_out_total, is_subm=False,
        spatial_shape=spatial_shape, out_spatial_shape=out_shape,
        ksize=ksize, stride=stride, padding=padding, dilation=dilation,
        transposed=transposed)


def build_pool2_rulebook(
    indices: torch.Tensor,
    *,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_bound: Optional[int] = None,
) -> IndiceData:
    """Rulebook of the kernel-2 / stride-2 / pad-0 pool from one stable
    sort of the parent keys.  ``pair_fwd[r, o]`` is the ``r``-th child of
    output ``o`` in row order among the children sorted by parent (its
    rank, not its kernel offset: a max or a mean does not care), and
    ``pair_bwd`` holds in row 0 each input's output row and -1 elsewhere,
    as the JAX package builds them; the record says so with
    ``rank_slots``.  Inputs on an odd edge fall outside the last window
    (VALID pooling)."""
    n, ndim = indices.shape[0], indices.shape[1] - 1
    kv = 2 ** ndim
    if out_bound is None:
        out_bound = n
    keys, sentinel, out_shape = pool2_parent_keys(indices, spatial_shape,
                                                  batch_size)
    sk, order = C.sort_with_ids(keys)
    out_keys, uniq_pos, num_out_total = unique_sorted_keys(sk, sentinel,
                                                           out_bound)
    not_sent = sk != sentinel
    is_first = torch.cat([not_sent[:1], (sk[1:] != sk[:-1]) & not_sent[1:]])
    pos = torch.arange(n, device=indices.device)
    rank = pos - torch.cummax(torch.where(is_first, pos,
                                          torch.zeros_like(pos)), 0).values
    pvalid = not_sent & (uniq_pos < out_bound)
    slot = torch.where(pvalid & (rank < kv), rank * out_bound + uniq_pos,
                       torch.full_like(rank, kv * out_bound))
    pair_fwd = torch.full((kv * out_bound + 1,), -1, dtype=torch.int32,
                          device=indices.device)
    pair_fwd[slot] = order.int()
    pair_bwd = torch.full((kv, n), -1, dtype=torch.int32,
                          device=indices.device)
    pair_bwd[0, order] = torch.where(pvalid, uniq_pos,
                                     torch.full_like(uniq_pos, -1)).int()
    out_indices = C.delinearize(out_keys, out_shape, out_keys != sentinel)
    return IndiceData(
        pair_fwd[:-1].reshape(kv, out_bound), pair_bwd, out_indices,
        indices, torch.clamp(num_out_total, max=out_bound),
        num_out_total=num_out_total, is_subm=False,
        spatial_shape=spatial_shape, out_spatial_shape=out_shape,
        ksize=(2,) * ndim, stride=(2,) * ndim, padding=(0,) * ndim,
        dilation=(1,) * ndim, rank_slots=True)


def get_indice_pairs(
    indices: torch.Tensor,
    batch_size: int,
    spatial_shape: Sequence[int],
    ksize: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    out_padding: Optional[Sequence[int]] = None,
    subm: bool = False,
    transpose: bool = False,
    out_bound: Optional[int] = None,
) -> IndiceData:
    """One entry for both rulebooks (the reference's
    ``get_indice_pairs``): :func:`build_subm_rulebook` with ``subm``, else
    :func:`build_conv_rulebook`."""
    if subm:
        return build_subm_rulebook(indices, spatial_shape=spatial_shape,
                                   batch_size=batch_size, ksize=ksize,
                                   dilation=dilation)
    return build_conv_rulebook(
        indices, spatial_shape=spatial_shape, batch_size=batch_size,
        ksize=ksize, stride=stride, padding=padding, dilation=dilation,
        out_padding=out_padding, transposed=transpose, out_bound=out_bound)
