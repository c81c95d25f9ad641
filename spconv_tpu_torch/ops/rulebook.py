"""Output-site discovery (counterpart of ``spconv_tpu/ops/rulebook.py``).

Ported: ``build_conv_outputs`` and ``build_deconv_outputs``, the output
sites of a regular (strided) and of a transposed conv, which the
dynamic-gather path needs, and ``build_pool2_outputs``, those of the
2x/stride-2 pool, which the sorted-key pool needs.  The pair rulebooks of
the native rulebook path (``build_subm_rulebook``, ``build_conv_rulebook``,
``build_pool2_rulebook``) are not ported yet.

Everything here is static-shape tensor code with no host read: the counts
come back as 0-d device tensors, so a forward never syncs on them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import coords as C

__all__ = ["unique_sorted_keys", "pool2_parent_keys", "build_conv_outputs",
           "build_deconv_outputs", "build_pool2_outputs"]


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
