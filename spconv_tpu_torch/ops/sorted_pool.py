"""Sorted-key 2x/stride-2 pool (counterpart of
``spconv_tpu/ops/pallas/sorted_pool.py``): the pool that ``algo="sk"``
runs on key-sorted input, with no rulebook.

* ``pool2_child_keys``: the ``2**ndim`` child keys of each parent key.
* ``sk_pool2`` (kernel ``csrc/sk_pool.cu``, B6): for each parent row, the
  max or mean over the children found in the sorted input keys, with
  ``sk_pool2_plain`` beside it; ``b6_plan`` is its launch (parents a
  block, lanes a parent, 16-byte chunks or channels).
* ``SKPool2Fn``: its autograd Function.  The backward is torch ops, as the
  JAX package's is XLA (``_sk_pool2_ad_bwd``); ``sk_pool2_ad`` takes it
  whenever a gradient is wanted.  On input that is not key-sorted the
  forward is the JAX route's fallback branch (``lax.cond`` there, chosen
  from ``keys_sorted`` here): the native pool over the 2x pool rulebook.

Semantics of the JAX sorted-key route, which differ from the segment route
(``ops/pool.py::pool2_seg``): a max that is not finite (NaN, +-inf, or a
parent with no child) is written as 0, and the max's backward hands the
parent's full gradient to every child equal to the max (ties are not
split).

``sk_pool2`` calls the ``sk_pool`` op (``ops/library.py``), whose CPU
kernel is the plain version and whose CUDA kernel launches B6 or raises;
it never falls back.  Each launch adds one to ``launch_counts["sk_pool"]``
(the port's counts, kept in ``ops/dg_conv.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import coords as C
from .dg_conv import (_check, _check_keys, _decode, _ptr, _raise_on,
                      _stream_ptr, launch_counts, sm_count, window_smem)
from .library import define_op
from .pool import indice_avgpool, indice_maxpool
from .rulebook import pool2_parent_keys

__all__ = ["pool_offsets", "pool2_child_keys", "sk_pool2", "sk_pool2_plain",
           "B6_TILES", "B6_POOL", "B6Plan", "b6_plan", "launch_b6",
           "sk_pool2_bwd", "SKPool2Fn", "sk_pool2_ad"]

_MAX_NDIM = 4
_MODES = ("max", "mean")


def pool_offsets(ndim: int) -> np.ndarray:
    """``[2**ndim, ndim]`` child offsets, the leading axis most significant
    (the JAX package's ``_pool_offsets``): child ``j`` of a parent has the
    smallest key for ``j = 0`` and ascending keys in ``j``."""
    offs = np.stack(np.meshgrid(*([np.arange(2)] * ndim), indexing="ij"),
                    axis=-1).reshape(-1, ndim)
    return offs.astype(np.int32)


def pool2_child_keys(out_keys: torch.Tensor, *, in_shape: Sequence[int],
                     out_shape: Sequence[int], batch_size: int
                     ) -> torch.Tensor:
    """``[2**ndim, M]`` int32 child keys of each parent key of ``out_keys``
    (on the input grid), or -1 where there is none: a sentinel parent, or a
    child ``2 * c + off`` past an odd edge.  The edge is checked on each
    axis before the key is linearized, so an absent child never aliases
    another site's key."""
    in_dims = [int(s) for s in in_shape]
    out_dims = [int(s) for s in out_shape]
    C.grid_sentinel(in_dims, batch_size)
    live = out_keys != C.grid_sentinel(out_dims, batch_size)
    b, coords = _decode(out_keys, out_dims)
    rows = []
    for off in pool_offsets(len(in_dims)):
        ok = live.clone()
        key = b
        for a, s in enumerate(in_dims):
            ca = coords[a] * 2 + int(off[a])
            ok &= ca < s
            key = key * s + ca
        rows.append(torch.where(ok, key, -1))
    return torch.stack(rows).int()


def _check_pool(features, in_keys, out_keys, in_shape, out_shape, mode):
    _check(mode in _MODES, f"pool mode must be one of {_MODES}, got {mode!r}")
    _check(features.ndim == 2
           and features.dtype in (torch.float32, torch.bfloat16),
           f"features must be [N, C] float32 or bfloat16, got "
           f"{tuple(features.shape)} {features.dtype}")
    _check(features.is_contiguous(), "features must be contiguous")
    _check_keys("in_keys", in_keys)
    _check_keys("out_keys", out_keys)
    _check(in_keys.shape[0] == features.shape[0],
           f"in_keys has {in_keys.shape[0]} rows, features "
           f"{features.shape[0]}")
    _check(features.device == in_keys.device == out_keys.device,
           "operands must be on one device")
    _check(len(in_shape) == len(out_shape)
           and 1 <= len(in_shape) <= _MAX_NDIM,
           f"in_shape and out_shape must have ndim in 1..{_MAX_NDIM} "
           "entries")


def sk_pool2(features: torch.Tensor, in_keys: torch.Tensor,
             out_keys: torch.Tensor, *, in_shape: Sequence[int],
             out_shape: Sequence[int], batch_size: int,
             mode: str = "max") -> torch.Tensor:
    """2x/stride-2 pool of each parent row of ``out_keys`` over its
    children -> ``[M, C]`` in ``features.dtype`` (one rounding of an f32
    reduction).

    ``features``: ``[N, C]`` f32 or bf16; ``in_keys``: ``[N]`` int32 keys
    of its rows, ascending, invalid rows at the tail with the input grid's
    sentinel; ``out_keys``: ``[M]`` int32 parent keys on ``out_shape``,
    sentinel-padded (``ops.rulebook.build_pool2_outputs``).  Each child key
    (:func:`pool2_child_keys`) is searched in all of ``in_keys``; a child
    that is not there is absent.  ``"max"``: the NaN-propagating max of
    the present children, 0 where it is not finite (so also for a parent
    with none).  ``"mean"``: their f32 sum in child order over their
    number (at least 1).  Sentinel parents are 0.  Records no autograd
    graph on CUDA: :class:`SKPool2Fn` differentiates."""
    _check_pool(features, in_keys, out_keys, in_shape, out_shape, mode)
    if features.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no sk_pool kernel for {features.device}")
    return _SK_POOL(features, in_keys, out_keys, [int(s) for s in in_shape],
                    [int(s) for s in out_shape], int(batch_size), mode)


def sk_pool2_plain(features: torch.Tensor, in_keys: torch.Tensor,
                   out_keys: torch.Tensor, *, in_shape: Sequence[int],
                   out_shape: Sequence[int], batch_size: int,
                   mode: str = "max") -> torch.Tensor:
    """Plain version of :func:`sk_pool2`: per child offset, a
    ``torch.searchsorted`` of the child keys, an equality check, a row
    gather and the f32 reduction."""
    probes = pool2_child_keys(out_keys, in_shape=in_shape,
                              out_shape=out_shape,
                              batch_size=batch_size).long()
    n, c = features.shape
    m = out_keys.shape[0]
    acc = torch.full((m, c), float("-inf") if mode == "max" else 0.0,
                     dtype=torch.float32, device=features.device)
    cnt = torch.zeros((m, 1), dtype=torch.float32, device=features.device)
    k64 = in_keys.long()
    for p in probes:
        if n == 0:
            break
        idx = torch.searchsorted(k64, p).clamp(max=n - 1)
        found = ((p >= 0) & (k64[idx] == p))[:, None]
        v = features[idx].float()
        if mode == "max":
            # torch.maximum propagates NaN, as jnp.maximum does
            acc = torch.maximum(acc, torch.where(found, v, float("-inf")))
        else:
            acc = acc + torch.where(found, v, 0.0)
            cnt = cnt + found.float()
    if mode == "max":
        out = torch.where(torch.isfinite(acc), acc, 0.0)
    else:
        out = acc / cnt.clamp(min=1.0)
    return out.to(features.dtype)


B6_TILES = (128, 64, 32, 16, 8, 4, 2)  # parents a block, largest first
B6_POOL = 2048  # keys of the children's windows a block holds


class B6Plan(NamedTuple):
    tile: int     # parents a block
    lanes: int    # lanes a parent: one 16-byte chunk (or channel) each
    threads: int  # a block's
    vec: bool     # 16-byte chunks; else one channel a lane
    pool: int     # keys of the children's windows in shared memory
    smem: int     # dynamic shared memory, bytes
    grid: int     # blocks


def b6_plan(m: int, c: int, itemsize: int, ndim: int,
            aligned: bool = True, *, sms: int, tile: int = 0) -> B6Plan:
    """The launch of B6 over ``m`` parents of ``c`` channels of
    ``itemsize`` bytes on a card of ``sms`` SMs: 16-byte chunks where
    ``c`` fills them and the features are ``aligned`` to 16 bytes, a
    power-of-two group of lanes covering a row's chunks (at most 32), and
    the largest tile of ``B6_TILES`` whose grid has a block an SM, or at
    least one full block of 256 threads (the best tile of each BenchNet
    pool in ``tools/b6_tiles.py``'s sweep on the H100, whose readings
    ``PERF.md`` keeps).  The children are B1's affine table with kernel 2
    and stride 2, one pass of ``2**(ndim - 2)`` groups, their windows in a
    pool of ``B6_POOL`` keys.  ``tile``: a tile of ``B6_TILES`` to take
    instead (the sweep's)."""
    chunk = 16 // itemsize
    vec = c % chunk == 0 and aligned
    units = c // chunk if vec else c
    lanes = min(32, 1 << max(0, units - 1).bit_length())
    if not tile:
        tile = next((t for t in B6_TILES if -(-m // t) >= sms),
                    B6_TILES[-1])
        tile = max(tile, min(B6_TILES[0], 256 // lanes))
    threads = min(256, max(32, tile * lanes))
    groups = 2 ** max(ndim - 2, 0)
    smem = window_smem(tile, ndim, groups, B6_POOL, 4 if ndim > 1 else 2)
    return B6Plan(tile, lanes, threads, vec, B6_POOL, smem, -(-m // tile))


def launch_b6(lib, features, in_keys, out_keys, in_dims, out_dims,
              batch_size: int, mode: str, plan: B6Plan, out) -> int:
    """One launch of ``lib``'s ``sk_pool_launch`` (the library's) on
    ``plan``, writing ``out``; returns its CUDA error."""
    ndim = len(in_dims)
    geom = (ctypes.c_int * (1 + 2 * _MAX_NDIM))(
        ndim, *(list(out_dims) + [1] * (_MAX_NDIM - ndim)),
        *(list(in_dims) + [1] * (_MAX_NDIM - ndim)))
    return lib.sk_pool_launch(
        _ptr(features), int(features.dtype == torch.bfloat16), _ptr(in_keys),
        features.shape[0], _ptr(out_keys), out_keys.shape[0],
        features.shape[1], geom, C.grid_sentinel(out_dims, batch_size),
        int(mode == "mean"), plan.tile, plan.pool, plan.lanes, plan.threads,
        int(plan.vec), plan.smem, _ptr(out), _stream_ptr(features.device))


def _sk_pool2_cuda(features, in_keys, out_keys, in_shape, out_shape,
                   batch_size, mode):
    from .._build import load_library

    in_dims = [int(s) for s in in_shape]
    out_dims = [int(s) for s in out_shape]
    C.grid_sentinel(out_dims, batch_size)
    C.grid_sentinel(in_dims, batch_size)
    c = features.shape[1]
    m = out_keys.shape[0]
    out = torch.empty((m, c), dtype=features.dtype, device=features.device)
    if m == 0 or c == 0:
        return out
    plan = b6_plan(m, c, features.element_size(), len(in_dims),
                   aligned=features.data_ptr() % 16 == 0,
                   sms=sm_count(features.device.index))
    _raise_on(launch_b6(load_library(), features, in_keys, out_keys, in_dims,
                        out_dims, batch_size, mode, plan, out), "sk_pool")
    launch_counts["sk_pool"] += 1
    return out


def _sk_pool_cpu(features, in_keys, out_keys, in_shape, out_shape,
                 batch_size, mode):
    return sk_pool2_plain(features, in_keys, out_keys, in_shape=in_shape,
                          out_shape=out_shape, batch_size=batch_size,
                          mode=mode)


def _sk_pool_fake(features, in_keys, out_keys, *args):
    return features.new_empty((out_keys.shape[0], features.shape[1]))


# B6's op: the pool of out_keys' parents over features' rows
_SK_POOL = define_op(
    "sk_pool", "(Tensor features, Tensor in_keys, Tensor out_keys, "
    "int[] in_shape, int[] out_shape, int batch_size, str mode) -> Tensor",
    cuda=_sk_pool2_cuda, cpu=_sk_pool_cpu, fake=_sk_pool_fake)


def _parent_rows(in_keys: torch.Tensor, out_keys: torch.Tensor, in_shape,
                 batch_size) -> torch.Tensor:
    """``[N]`` int64 row of each input row's parent in ``out_keys``, or
    ``M`` where it has none: an invalid row, a row on an odd edge, or one
    whose parent the output bound cut."""
    in_dims = [int(s) for s in in_shape]
    m = out_keys.shape[0]
    valid = in_keys != C.grid_sentinel(in_dims, batch_size)
    keys, sentinel, _ = pool2_parent_keys(
        C.delinearize(in_keys, in_dims, valid), in_dims, batch_size)
    if m == 0:
        return torch.zeros_like(keys, dtype=torch.int64)
    idx = torch.searchsorted(out_keys, keys).clamp(max=m - 1)
    return torch.where((keys != sentinel) & (out_keys[idx] == keys), idx, m)


def sk_pool2_bwd(features: torch.Tensor, out: torch.Tensor,
                 dout: torch.Tensor, in_keys: torch.Tensor,
                 out_keys: torch.Tensor, *, in_shape: Sequence[int],
                 batch_size: int, mode: str = "max") -> torch.Tensor:
    """Input gradient of :func:`sk_pool2` (the JAX ``_sk_pool2_ad_bwd``),
    torch ops -> ``[N, C]`` in ``features.dtype``.  Each input row reads
    its parent's ``dout`` in f32 (:func:`_parent_rows`).  ``"max"``: a
    child whose f32 value equals the forward's ``out`` at its parent gets
    all of it, so tied children each get the full gradient (a child equal
    to a max that was written as 0 for not being finite gets it too).
    ``"mean"``: each child gets it over its parent's number of children
    (at least 1).  Rows with no parent get 0."""
    m, c = out.shape
    pc = _parent_rows(in_keys, out_keys, in_shape, batch_size)
    zero_row = torch.zeros((1, c), dtype=torch.float32, device=dout.device)
    dg = torch.cat([dout.float(), zero_row])[pc]
    if mode == "max":
        og = torch.cat([out.float(), torch.full_like(zero_row,
                                                     float("inf"))])[pc]
        din = torch.where(features.float() == og, dg, 0.0)
    else:
        cnt = torch.zeros((m + 1,), dtype=torch.float32,
                          device=dout.device).index_add_(
                              0, pc, torch.ones_like(pc, dtype=torch.float32))
        cnt = torch.cat([cnt[:m].clamp(min=1.0), cnt.new_ones(1)])
        din = dg / cnt[pc][:, None]
    return din.to(features.dtype)


def _sk_pool2_forward(features, in_keys, out_keys, geom, pair_fwd):
    """:func:`sk_pool2`, or with ``pair_fwd`` (input that is not key-sorted)
    the JAX route's fallback branch: the native pool over the 2x pool
    rulebook's ``pair_fwd``, torch ops."""
    in_shape, out_shape, batch_size, mode = geom
    if pair_fwd is not None:
        pool = indice_maxpool if mode == "max" else indice_avgpool
        return pool(features, pair_fwd)
    return sk_pool2(features, in_keys, out_keys, in_shape=in_shape,
                    out_shape=out_shape, batch_size=batch_size, mode=mode)


class SKPool2Fn(torch.autograd.Function):
    """Differentiable :func:`sk_pool2` over ``features``: the forward
    launches B6 (on CUDA), or with ``pair_fwd`` takes the fallback branch
    (:func:`_sk_pool2_forward`); the backward is :func:`sk_pool2_bwd`
    either way, as the JAX package's custom VJP is.  ``geom`` is
    ``(in_shape, out_shape, batch_size, mode)``."""

    @staticmethod
    def forward(ctx, features, in_keys, out_keys, geom, pair_fwd=None):
        out = _sk_pool2_forward(features, in_keys, out_keys, geom, pair_fwd)
        ctx.geom = geom
        ctx.save_for_backward(features, out, in_keys, out_keys)
        return out

    @staticmethod
    def backward(ctx, dout):
        features, out, in_keys, out_keys = ctx.saved_tensors
        in_shape, _, batch_size, mode = ctx.geom
        din = sk_pool2_bwd(features, out, dout, in_keys, out_keys,
                           in_shape=in_shape, batch_size=batch_size,
                           mode=mode)
        return din, None, None, None, None


def sk_pool2_ad(features: torch.Tensor, in_keys: torch.Tensor,
                out_keys: torch.Tensor, *, in_shape: Sequence[int],
                out_shape: Sequence[int], batch_size: int,
                mode: str = "max",
                pair_fwd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`sk_pool2`, through :class:`SKPool2Fn` when a gradient of
    ``features`` is wanted.  For input that is not key-sorted the caller
    passes the 2x pool rulebook's ``pair_fwd`` (``in_keys`` then in row
    order): the forward is the JAX route's fallback branch, the backward
    the same as on sorted input."""
    geom = (tuple(int(s) for s in in_shape),
            tuple(int(s) for s in out_shape), int(batch_size), mode)
    if torch.is_grad_enabled() and features.requires_grad:
        return SKPool2Fn.apply(features, in_keys, out_keys, geom, pair_fwd)
    return _sk_pool2_forward(features, in_keys, out_keys, geom, pair_fwd)
