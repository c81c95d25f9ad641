"""Dynamic-gather (DG) conv on key-sorted input (counterpart of
``spconv_tpu/ops/pallas/dg_conv.py``): the submanifold, regular (strided),
inverse and transposed convs, forward and backward, through cached match tables
(posmode), and the submanifold conv without a table (search mode).

The kernel wrappers, each with its plain PyTorch version beside it:

* ``build_dg_pos`` (kernel ``csrc/dg_pos.cu``): the match table.  For each
  output row ``i`` and kernel offset ``k``, the row whose key equals
  ``key[i]`` shifted by offset ``k`` (by its negation with
  ``reverse=True``: the backward's table), or -1.  Built once per
  ``indice_key`` stage; laid out offset-major ``[kv, N]`` int32.
* ``build_dg_pos_affine`` (the same kernel file, affine mode): the match
  table ``[kv, N_out]`` of a regular conv, from output sites to the input
  rows at ``coord * stride + off_k * dil - pad``.
* ``build_dg_pos_divide`` (the same file, divide mode): its exact inverse
  ``[kv, N_in]``, from input sites to the output rows at ``(coord - off_k *
  dil + pad) / stride``.  The strided conv's backward, the inverse conv's
  forward and, on swapped spaces, the transposed conv's forward gather
  through it.  All three modes run one windowed search
  (``csrc/dg_search.cuh``'s ``WindowRows``) on a ``TableGeom``, launched
  on ``b1_plan``'s tile, pool and grid (``tools/table_count.py`` models
  its windows on the host).
* ``dg_fwd`` (kernel ``csrc/dg_fwd.cu``): the gather-GEMM
  ``out[i] = sum_k x[pos[k, i]] @ W[k]`` with f32 accumulation, rounded
  once to the input dtype; rows without any match are 0.  The output has
  ``pos.shape[1]`` rows: on an affine table (the strided conv) ``N_out``
  from ``N_in``, on a divide table (the inverse conv) ``N_in`` from
  ``N_out``.
* ``dg_dgrad`` (the same kernel, on the backward's table and ``W[k]^T``,
  which the bf16 kernel reads from the weight as it is):
  ``din[j] = sum_k dout[pos_bwd[k, j]] @ W[k]^T``.  The bf16 kernel's tile
  is a variant the wrapper picks from the shapes (:func:`b2_variant`).
* ``dg_wgrad`` (kernel ``csrc/dg_wgrad.cu``):
  ``dW[k] = sum_j x[j]^T dout[pos_bwd[k, j]]``, split over rows into f32
  partials that a second kernel adds in a fixed order.  Its bf16 kernel
  multiplies only the matched rows, listed per offset, on a tile the
  wrapper picks from the shapes (:func:`wgrad_variant`).
* ``dg_fwd_q`` (kernel ``csrc/dg_fwd_q.cu``): the int8 gather-GEMM of the
  quantized convs, int32 accumulation and the fused scale / bias / residual
  / ReLU / requant epilogue, on any of the three forward tables.  The
  kernel reads the weight as ``W[k]^T`` (``[kv, K, C]``, which the int8
  modules fold once) on a tile the wrapper picks from the shapes
  (:func:`b7_variant`).
* the search mode of a subm conv (the JAX package's ``pos=None``), the same
  kernels with each block searching its own rows' matches in the sorted
  keys (``csrc/dg_search.cuh``) instead of reading a table: ``dg_fwd_search``
  (S1), ``dg_dgrad_search`` (S2, on the reversed probes), ``dg_wgrad_search``
  (S3) and ``dg_fwd_q_search`` (S4).  Each computes exactly B1 followed by
  its table-mode sibling, and its plain version is just that:
  ``dg_pos_plain`` followed by the sibling's plain version.

Each conv is a pair of tables (the forward's ``[kv, N_dst]``, the
backward's ``[kv, N_src]``): (pos, reversed pos) for the subm conv,
(affine, divide) for the strided conv and (divide, affine) for the inverse
and the transposed conv.  ``DGConvFn`` is the autograd Function over the
pair (the VJPs ``_dg_conv_p_bwd`` and ``_dg_reg_conv_bwd`` of the JAX
package);
``dg_subm_conv`` and ``dg_regular_conv`` take it whenever a gradient is
wanted.  ``DGSearchFn`` is the table-free subm conv's (``_dg_conv`` and its
VJP), and ``dg_subm_conv_search`` its entry.

Each kernel family is a ``torch.library`` op (``ops/library.py``):
``dg_pos`` (B1), ``dg_gather_gemm`` (B2, dgrad, S1, S2), ``dg_fwd_q`` (B7,
S4) and ``dg_wgrad`` (wgrad, S3).  A wrapper checks its arguments and
calls its op, whose CPU kernel is the plain version and whose CUDA kernel
launches the hand-written one or raises; it never falls back.  Each launch
adds one to its entry of ``launch_counts``, one entry per kernel and conv
path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import coords as C
from .library import define_op

__all__ = [
    "subm_key_deltas",
    "regular_conv_disp",
    "build_dg_pos",
    "dg_pos_plain",
    "build_dg_pos_affine",
    "dg_pos_affine_plain",
    "build_dg_pos_divide",
    "dg_pos_divide_plain",
    "TableGeom",
    "B1Plan",
    "B1_TILES",
    "B1_POOL",
    "b1_plan",
    "b1_window_plan",
    "B1_DIRECT",
    "sm_count",
    "launch_b1",
    "PATHS",
    "dg_fwd",
    "dg_fwd_plain",
    "B2_TILES",
    "B2Variant",
    "b2_variant",
    "b2_smem_bytes",
    "dg_fwd_q",
    "dg_fwd_q_plain",
    "B7_TILES",
    "B7Variant",
    "b7_variant",
    "b7_smem_bytes",
    "b7_mma_rows",
    "dg_regular_conv",
    "dg_dgrad",
    "dg_dgrad_plain",
    "dg_wgrad",
    "dg_wgrad_plain",
    "WGRAD_TILES",
    "WgradVariant",
    "wgrad_variant",
    "wgrad_smem_bytes",
    "wgrad_splits",
    "wgrad_rows_per_split",
    "wgrad_mma_rows",
    "DGConvFn",
    "dg_subm_conv",
    "SearchGeom",
    "dg_fwd_search",
    "dg_fwd_search_plain",
    "dg_dgrad_search",
    "dg_dgrad_search_plain",
    "dg_wgrad_search",
    "dg_wgrad_search_plain",
    "dg_fwd_q_search",
    "dg_fwd_q_search_plain",
    "DGSearchFn",
    "dg_subm_conv_search",
    "weight_krsc_to_kv",
    "launch_counts",
    "reset_launch_counts",
]

# the convs whose gather-GEMM launches count apart: "dg_fwd" counts the
# subm path, "dg_fwd_strided", "dg_fwd_inverse" and "dg_fwd_transposed" the
# others, and so on (the int8 kernel has no transposed path).  "native"
# counts the native rulebook path's launches (ops/gather_gemm.py), on the
# pair tables of any conv.
PATHS = ("subm", "strided", "inverse", "transposed", "native")
_REG_PATHS = PATHS[1:4]  # those of dg_regular_conv and its tables

# launches of each kernel wrapper of the port since the last
# reset_launch_counts(); "dg_pos" counts forward subm tables, "dg_pos_rev"
# reversed ones, "dg_pos_affine" and "dg_pos_divide" a regular or inverse
# conv's two tables ("*_transposed" a transposed conv's), "*_search" the
# table-free subm kernels, "sk_pool" the sorted-key pool
# (ops/sorted_pool.py), "*_native" the native rulebook path's
launch_counts = dict.fromkeys(
    ("dg_pos", "dg_pos_rev", "dg_pos_affine", "dg_pos_divide",
     "dg_pos_affine_transposed", "dg_pos_divide_transposed",
     "dg_fwd", "dg_fwd_strided", "dg_fwd_inverse", "dg_fwd_transposed",
     "dg_fwd_native",
     "dg_fwd_q", "dg_fwd_q_strided", "dg_fwd_q_inverse", "dg_fwd_q_native",
     "dg_dgrad", "dg_dgrad_strided", "dg_dgrad_inverse",
     "dg_dgrad_transposed", "dg_dgrad_native",
     "dg_wgrad", "dg_wgrad_strided", "dg_wgrad_inverse",
     "dg_wgrad_transposed", "dg_wgrad_native",
     "dg_fwd_search", "dg_dgrad_search", "dg_wgrad_search",
     "dg_fwd_q_search", "sk_pool"), 0)

_MAX_NDIM = 4


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def subm_key_deltas(
    ksize: Sequence[int],
    dilation: Sequence[int],
    spatial_shape: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-offset key shift ``delta_k`` ``[kv]`` and displacement ``d_k``
    ``[kv, ndim]`` on the linearized key space.  ``d_k`` is the kernel
    offset minus the kernel centre, times the dilation, in
    :func:`coords.kernel_offsets` order."""
    offs = C.kernel_offsets(ksize)
    centers = np.array([int(k) // 2 for k in ksize])
    disp = (offs - centers) * np.array([int(d) for d in dilation])
    strides = np.ones(len(spatial_shape), np.int64)
    for i in range(len(spatial_shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * int(spatial_shape[i + 1])
    deltas = (disp.astype(np.int64) * strides).sum(axis=1)
    return deltas.astype(np.int32), disp.astype(np.int32)


def regular_conv_disp(ksize: Sequence[int], dilation: Sequence[int],
                      padding: Sequence[int]) -> np.ndarray:
    """``[kv, ndim]`` displacements of a regular conv: kernel offset times
    dilation minus padding, with no centring (the ``disp`` of the JAX
    package's ``dg_regular_conv``).  Output site ``o`` reads input site
    ``o * stride + disp_k`` at offset ``k``."""
    offs = C.kernel_offsets(ksize).astype(np.int64)
    return (offs * np.array([int(d) for d in dilation])
            - np.array([int(p) for p in padding])).astype(np.int32)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_keys(name, keys):
    _check(keys.ndim == 1 and keys.dtype == torch.int32,
           f"{name} must be [N] int32, got {tuple(keys.shape)} {keys.dtype}")
    _check(keys.is_contiguous(), f"{name} must be contiguous")


def _decode(keys: torch.Tensor, dims: Sequence[int]):
    """Keys -> (batch index, per-axis coordinates), int64."""
    rem = keys.long()
    coords = []
    for s in reversed(dims):
        coords.append(rem % s)
        rem = rem // s
    return rem, coords[::-1]


def _stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# B1: match table
# ---------------------------------------------------------------------------

def build_dg_pos(
    keys: torch.Tensor,
    *,
    ksize: Sequence[int],
    dilation: Sequence[int],
    spatial_shape: Sequence[int],
    batch_size: int,
    reverse: bool = False,
) -> torch.Tensor:
    """Match table ``[kv, N]`` int32 of a subm stage (-1 = no match).

    ``keys``: ``[N]`` int32 linearized keys in ascending order, invalid rows
    at the tail with the grid's sentinel key.  Rows with the sentinel get -1
    at every offset.  ``reverse`` negates every displacement: row ``j``'s
    entry at offset ``k`` is the row ``i`` whose forward table has ``j`` at
    ``k``, the table the backward gathers ``dout`` through."""
    _check_keys("keys", keys)
    ksize = tuple(int(k) for k in ksize)
    dilation = tuple(int(d) for d in dilation)
    dims = tuple(int(s) for s in spatial_shape)
    _check(len(ksize) == len(dims) == len(dilation),
           "ksize, dilation and spatial_shape must have ndim entries")
    C.grid_sentinel(dims, batch_size)
    if keys.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no dg_pos kernel for {keys.device}")
    return _pos_op(keys, keys, TableGeom.subm(ksize, dilation, dims, reverse),
                   int(batch_size), "dg_pos_rev" if reverse else "dg_pos")


def dg_pos_plain(keys: torch.Tensor, *, ksize, dilation, spatial_shape,
                 batch_size, reverse: bool = False) -> torch.Tensor:
    """Plain version of the match table: ``torch.searchsorted`` of every
    shifted key, then an equality check."""
    dims = [int(s) for s in spatial_shape]
    sentinel = C.grid_sentinel(dims, batch_size)
    deltas, disp = subm_key_deltas(ksize, dilation, dims)
    if reverse:
        deltas, disp = -deltas, -disp
    n = keys.shape[0]
    k64 = keys.long()
    live = keys != sentinel
    _, coords = _decode(keys, dims)
    pos = torch.full((len(deltas), n), -1, dtype=torch.int32,
                     device=keys.device)
    if n == 0:
        return pos
    for k in range(len(deltas)):
        ok = live.clone()
        for a, s in enumerate(dims):
            ca = coords[a] + int(disp[k, a])
            ok &= (ca >= 0) & (ca < s)
        probe = k64 + int(deltas[k])
        idx = torch.searchsorted(k64, probe)
        found = ok & (k64[idx.clamp(max=n - 1)] == probe)
        pos[k] = torch.where(found, idx, -1).int()
    return pos


def build_dg_pos_affine(
    in_keys: torch.Tensor,
    out_keys: torch.Tensor,
    *,
    ksize: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    batch_size: int,
    path: str = "strided",
) -> torch.Tensor:
    """Match table ``[kv, N_out]`` int32 of a regular conv (-1 = no match).

    Row ``o``, offset ``k`` holds the input row whose key is ``b(o) *
    vol_in + lin(coord(o) * stride + off_k * dil - pad)``, or -1 where
    that coordinate leaves the input grid, no input row has it, or ``o``
    is a sentinel row.  ``in_keys`` ``[N_in]``: ascending keys on the
    input grid (``in_shape``), sentinel tail; ``out_keys`` ``[N_out]``:
    the same on the output grid (:func:`rulebook.build_conv_outputs`).
    ``path`` names the conv the table is for (:func:`dg_regular_conv`):
    a ``"transposed"`` conv's launch counts apart."""
    geom = _regular_geom(in_keys, out_keys, path, ksize=ksize,
                         stride=stride, padding=padding, dilation=dilation,
                         in_shape=in_shape, out_shape=out_shape,
                         batch_size=batch_size)
    return _regular_pos("dg_pos_affine", in_keys, out_keys, path, **geom)


def _check_reg_path(path: str) -> None:
    _check(path in _REG_PATHS,
           f"path must be one of {_REG_PATHS}, got {path!r}")


def _regular_geom(in_keys, out_keys, path, **geom):
    """Checks ``path`` and the keys of a regular conv's two grids and
    returns its geometry as tuples of ints; raises unless both key spaces
    fit in int32."""
    _check_reg_path(path)
    _check_keys("in_keys", in_keys)
    _check_keys("out_keys", out_keys)
    _check(in_keys.device == out_keys.device,
           "in_keys and out_keys must be on one device")
    if in_keys.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no dg_pos kernel for {in_keys.device}")
    geom = {k: int(v) if k == "batch_size" else tuple(int(x) for x in v)
            for k, v in geom.items()}
    ndim = len(geom["in_shape"])
    _check(all(len(v) == ndim for v in geom.values()
               if isinstance(v, tuple)),
           "ksize, stride, padding, dilation and both shapes must have "
           "ndim entries")
    C.grid_sentinel(geom["in_shape"], geom["batch_size"])
    C.grid_sentinel(geom["out_shape"], geom["batch_size"])
    return geom


def dg_pos_affine_plain(in_keys: torch.Tensor, out_keys: torch.Tensor, *,
                        ksize, stride, padding, dilation, in_shape,
                        out_shape, batch_size) -> torch.Tensor:
    """Plain version of :func:`build_dg_pos_affine`: per offset, each
    output site's input key by the host's displacement table
    (:func:`regular_conv_disp`), ``torch.searchsorted`` and an equality
    check."""
    disp = regular_conv_disp(ksize, dilation, padding)
    sent_out = C.grid_sentinel(out_shape, batch_size)
    n_in, n_out = in_keys.shape[0], out_keys.shape[0]
    pos = torch.full((len(disp), n_out), -1, dtype=torch.int32,
                     device=out_keys.device)
    if n_in == 0 or n_out == 0:
        return pos
    b, coords = _decode(out_keys, out_shape)
    live = out_keys != sent_out
    k64 = in_keys.long()
    for k in range(len(disp)):
        ok = live.clone()
        probe = b
        for a, s in enumerate(in_shape):
            ca = coords[a] * int(stride[a]) + int(disp[k, a])
            ok &= (ca >= 0) & (ca < s)
            probe = probe * s + ca
        idx = torch.searchsorted(k64, probe).clamp(max=n_in - 1)
        found = ok & (k64[idx] == probe)
        pos[k] = torch.where(found, idx, -1).int()
    return pos


def build_dg_pos_divide(
    in_keys: torch.Tensor,
    out_keys: torch.Tensor,
    *,
    ksize: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    batch_size: int,
    path: str = "strided",
) -> torch.Tensor:
    """Divide table ``[kv, N_in]`` int32 of a regular conv (-1 = no match):
    the exact inverse of :func:`build_dg_pos_affine` on the same keys.

    Row ``i``, offset ``k`` holds the output row whose key is ``b(i) *
    vol_out + lin(c)``, where per axis ``t = coord(i) - (off_k * dil -
    pad)``, ``t >= 0``, ``t % stride == 0`` and ``c = t / stride`` lies
    inside ``out_shape``; -1 otherwise, where no output row has that key
    (a cut output set), or where ``i`` is a sentinel row.  So it holds
    ``o`` iff the affine table holds ``i`` at ``(k, o)``.  Arguments as
    :func:`build_dg_pos_affine`'s (a transposed conv's forward table)."""
    geom = _regular_geom(in_keys, out_keys, path, ksize=ksize,
                         stride=stride, padding=padding, dilation=dilation,
                         in_shape=in_shape, out_shape=out_shape,
                         batch_size=batch_size)
    return _regular_pos("dg_pos_divide", in_keys, out_keys, path, **geom)


def dg_pos_divide_plain(in_keys: torch.Tensor, out_keys: torch.Tensor, *,
                        ksize, stride, padding, dilation, in_shape,
                        out_shape, batch_size) -> torch.Tensor:
    """Plain version of :func:`build_dg_pos_divide`, searching as the
    divide probes define it: per offset, each input site's output key,
    ``torch.searchsorted`` and an equality check."""
    disp = regular_conv_disp(ksize, dilation, padding)
    sent_in = C.grid_sentinel(in_shape, batch_size)
    n_in, n_out = in_keys.shape[0], out_keys.shape[0]
    pos = torch.full((len(disp), n_in), -1, dtype=torch.int32,
                     device=in_keys.device)
    if n_in == 0 or n_out == 0:
        return pos
    b, coords = _decode(in_keys, in_shape)
    live = in_keys != sent_in
    k64 = out_keys.long()
    for k in range(len(disp)):
        ok = live.clone()
        probe = b
        for a, s in enumerate(out_shape):
            t = coords[a] - int(disp[k, a])
            ok &= (t >= 0) & (t % int(stride[a]) == 0)
            ca = t // int(stride[a])
            ok &= ca < s
            probe = probe * s + ca
        idx = torch.searchsorted(k64, probe).clamp(max=n_out - 1)
        found = ok & (k64[idx] == probe)
        pos[k] = torch.where(found, idx, -1).int()
    return pos


def _regular_pos(name, in_keys, out_keys, path, *, ksize, stride, padding,
                 dilation, in_shape, out_shape, batch_size):
    """B1 in affine (``name == "dg_pos_affine"``: a table over the output
    rows) or divide mode (over the input rows), counted under ``name``, or
    ``name + "_transposed"`` for a transposed conv."""
    affine = name == "dg_pos_affine"
    tg = TableGeom.regular(not affine, ksize=ksize, stride=stride,
                           padding=padding, dilation=dilation,
                           in_shape=in_shape, out_shape=out_shape)
    # the rows the table is over, and the keys it searches
    rows, table = (out_keys, in_keys) if affine else (in_keys, out_keys)
    return _pos_op(rows, table, tg, batch_size,
                   f"{name}_transposed" if path == "transposed" else name)


# ---------------------------------------------------------------------------
# B1 on the card: the windowed search (csrc/dg_pos.cu, dg_search.cuh's
# WindowRows) and its host plan
# ---------------------------------------------------------------------------

B1_TILES = (128, 64, 32)  # rows a block, largest first
B1_POOL = 4096            # keys of windows a pass holds in shared memory
# (row, offset) probes at most for the direct path: one thread a probe
# searching the whole table beats a window's fixed chain a block there
# (BenchNet's stages 4-6 and CenterPoint's conv_out table on the H100)
B1_DIRECT = 1 << 17
_B1_THREADS = 256
_B1_CLASSES = 64          # residue classes a divide tile sorts by, at most
_SMEM_PASS = 48 << 10     # a B1 pass's shared memory, without the opt-in
SMEM_MAX = 232_448        # a block's shared memory on the H100, opted in


class TableGeom(NamedTuple):
    """The geometry of a B1 table (``csrc/dg_search.cuh``'s ``WinGeom``):
    per axis, a row's coordinate ``x`` (on ``row_dims``) moves at kernel
    index ``ka`` to ``x * stride + ka * dil - pad`` (affine), or to ``(x -
    ka * dil + pad) / stride`` where that divides (``divide``), inside
    ``tab_dims``.  ``self_rows``: the searched keys are the rows' own (a
    subm stage)."""
    row_dims: Tuple[int, ...]
    tab_dims: Tuple[int, ...]
    stride: Tuple[int, ...]
    ksize: Tuple[int, ...]
    dilation: Tuple[int, ...]
    padding: Tuple[int, ...]
    divide: bool
    self_rows: bool

    @classmethod
    def subm(cls, ksize, dilation, dims, reverse=False) -> "TableGeom":
        """A subm stage's table: the affine map with stride 1 and the
        kernel centre as padding; reversed, the divide map."""
        ksize, dilation = tuple(ksize), tuple(dilation)
        pad = tuple((k // 2) * d for k, d in zip(ksize, dilation))
        return cls(tuple(dims), tuple(dims), (1,) * len(dims), ksize,
                   dilation, pad, bool(reverse), True)

    @classmethod
    def regular(cls, divide, *, ksize, stride, padding, dilation, in_shape,
                out_shape) -> "TableGeom":
        """A regular conv's affine table (output rows, input keys) or its
        divide table (input rows, output keys)."""
        rows, tab = (in_shape, out_shape) if divide else (out_shape,
                                                         in_shape)
        return cls(tuple(rows), tuple(tab), tuple(stride), tuple(ksize),
                   tuple(dilation), tuple(padding), bool(divide), False)

    def ints(self):
        """The geometry as ``dg::win_geom`` reads it."""
        pad = [1] * (_MAX_NDIM - len(self.ksize))
        return (ctypes.c_int * (1 + 6 * _MAX_NDIM))(
            len(self.ksize), *self.row_dims, *pad, *self.tab_dims, *pad,
            *self.stride, *pad, *self.ksize, *pad, *self.dilation, *pad,
            *self.padding, *([0] * len(pad)))


class B1Plan(NamedTuple):
    tile: int    # rows a block; 0: the direct path (grid: blocks of 256
                 # probes), which reads no other field
    groups: int  # offset groups (fixed indices on all but the last two
                 # kernel axes) a pass holds
    passes: int
    pool: int    # keys of windows a pass holds in shared memory
    sort: bool   # divide mode with stride > 1: rows walked by residue
                 # class, results staged in shared memory
    smem: int    # dynamic shared memory, bytes
    grid: int    # blocks


def window_smem(tile, ndim, groups, pool, per_group, staged=True):
    """Bytes of ``dg::WindowRows``' shared memory: the tile's keys,
    batches, walk order, coordinates and spans, the class counts, four
    bounds a group, each row's leading key a group, the windows' pool
    and, ``staged``, the pass's results."""
    return 4 * (tile * (5 + ndim) + _B1_CLASSES + 1 + 4 * groups
                + groups * tile + pool
                + (groups * per_group * tile if staged else 0))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, by which the B1 and B6 plans size
    their grids."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def b1_plan(n_rows: int, ksize: Sequence[int], stride=None,
            divide: bool = False, *, sms: int) -> B1Plan:
    """The launch of a B1 table over ``n_rows`` rows with kernel ``ksize``
    on a card of ``sms`` SMs: the direct path (one thread a probe) where
    the table has at most ``B1_DIRECT`` probes, else
    :func:`b1_window_plan`'s."""
    kv = int(np.prod([int(k) for k in ksize]))
    if n_rows * kv <= B1_DIRECT:
        return B1Plan(0, 0, 0, 0, False, 0, -(-n_rows * kv // _B1_THREADS))
    return b1_window_plan(n_rows, ksize, stride, divide, sms=sms)


def b1_window_plan(n_rows: int, ksize: Sequence[int], stride=None,
                   divide: bool = False, *, sms: int) -> B1Plan:
    """The windowed launch of a B1 table over ``n_rows`` rows with kernel
    ``ksize`` on a card of ``sms`` SMs: the largest tile of ``B1_TILES``
    whose grid has two blocks an SM (32 rows where none has) and a pool of
    ``B1_POOL`` keys for the windows.
    ``divide`` with a stride whose product is 2-64 sorts each tile's rows
    by residue class and stages the results, as many offset groups a pass
    as fit in 48 KB (one, opted in up to the card's 227 KB, where none
    fits; a smaller tile before that); else a pass holds every group."""
    ksize = tuple(int(k) for k in ksize)
    ndim = len(ksize)
    per_group = ksize[-1] * (ksize[-2] if ndim >= 2 else 1)
    groups = int(np.prod(ksize)) // per_group
    classes = int(np.prod(stride)) if stride is not None else 1
    sort = bool(divide) and 1 < classes <= _B1_CLASSES
    tiles = [t for t in B1_TILES if t == B1_TILES[-1]
             or -(-n_rows // t) >= 2 * sms]
    fit = groups
    for tile in tiles:
        if not sort:
            break
        fit = max(g for g in range(groups + 1)
                  if g == 0 or window_smem(tile, ndim, g, B1_POOL,
                                           per_group) <= _SMEM_PASS)
        if fit:
            break
    else:
        fit = 1
    smem = window_smem(tile, ndim, fit, B1_POOL, per_group, sort)
    _check(smem <= SMEM_MAX, f"B1 kernel {ksize}: a line of {per_group} "
                             "offsets does not fit in shared memory")
    return B1Plan(tile, fit, -(-groups // fit), B1_POOL, sort, smem,
                  -(-n_rows // tile))


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch_b1(lib, rows, table, tg: TableGeom, sentinel: int, plan: B1Plan,
              pos: torch.Tensor) -> int:
    """One launch of ``lib``'s ``dg_pos_launch`` (the library's, or a
    rebuilt one's) on ``plan``, writing ``pos``; returns its CUDA error."""
    return lib.dg_pos_launch(
        _ptr(rows), rows.shape[0], _ptr(table), table.shape[0], tg.ints(),
        sentinel, int(tg.divide), int(tg.self_rows), int(plan.sort),
        plan.tile, plan.groups, plan.pool, plan.smem, _ptr(pos),
        _stream_ptr(rows.device))


def _table_cuda(name, rows, table, tg: TableGeom, sentinel):
    """B1's table ``[kv, N_rows]`` of ``rows`` searched in ``table``."""
    from .._build import load_library

    if len(tg.ksize) > _MAX_NDIM:
        raise NotImplementedError(f"dg_pos kernel takes ndim <= {_MAX_NDIM}")
    kv = int(np.prod(tg.ksize))
    n = rows.shape[0]
    _check(kv * n < 2**31, f"{name}: kv*N = {kv * n} exceeds the kernel's "
                           "int32 table index")
    pos = torch.empty((kv, n), dtype=torch.int32, device=rows.device)
    if n == 0:
        return pos
    plan = b1_plan(n, tg.ksize, tg.stride, tg.divide,
                   sms=sm_count(rows.device.index))
    _raise_on(launch_b1(load_library(), rows, table, tg, sentinel, plan, pos),
              name)
    return pos


# B1's op: the table of ``rows`` searched in ``table`` on a TableGeom (its
# fields as int lists), the grid's batch size and the launch count's name


def _pos_plain(rows, table, tg: TableGeom, batch_size: int) -> torch.Tensor:
    """B1's plain version on ``tg``: :func:`dg_pos_plain` (a subm stage),
    :func:`dg_pos_divide_plain` or :func:`dg_pos_affine_plain`."""
    if tg.self_rows:
        return dg_pos_plain(rows, ksize=tg.ksize, dilation=tg.dilation,
                            spatial_shape=tg.row_dims, batch_size=batch_size,
                            reverse=tg.divide)
    geom = dict(ksize=tg.ksize, stride=tg.stride, padding=tg.padding,
                dilation=tg.dilation, batch_size=batch_size)
    if tg.divide:
        return dg_pos_divide_plain(rows, table, in_shape=tg.row_dims,
                                   out_shape=tg.tab_dims, **geom)
    return dg_pos_affine_plain(table, rows, in_shape=tg.tab_dims,
                               out_shape=tg.row_dims, **geom)


def _pos_geom(row_dims, tab_dims, stride, ksize, dilation, padding, divide,
              self_rows) -> TableGeom:
    return TableGeom(tuple(row_dims), tuple(tab_dims), tuple(stride),
                     tuple(ksize), tuple(dilation), tuple(padding),
                     bool(divide), bool(self_rows))


def _dg_pos_cuda(rows, table, *args):
    *geom, batch_size, counter = args
    tg = _pos_geom(*geom)
    pos = _table_cuda(counter, rows, table, tg,
                      C.grid_sentinel(tg.row_dims, batch_size))
    launch_counts[counter] += 1
    return pos


def _dg_pos_cpu(rows, table, *args):
    *geom, batch_size, _ = args
    return _pos_plain(rows, table, _pos_geom(*geom), batch_size)


def _dg_pos_fake(rows, table, row_dims, tab_dims, stride, ksize, *args):
    return rows.new_empty((int(np.prod(ksize)), rows.shape[0]),
                          dtype=torch.int32)


_DG_POS = define_op(
    "dg_pos", "(Tensor rows, Tensor table, int[] row_dims, int[] tab_dims, "
    "int[] stride, int[] ksize, int[] dilation, int[] padding, bool divide, "
    "bool self_rows, int batch_size, str counter) -> Tensor",
    cuda=_dg_pos_cuda, cpu=_dg_pos_cpu, fake=_dg_pos_fake)


def _pos_op(rows, table, tg: TableGeom, batch_size: int, counter: str):
    """Every B1 table goes through here: the ``dg_pos`` op, counted under
    ``counter`` on the card."""
    return _DG_POS(rows, table, list(tg.row_dims), list(tg.tab_dims),
                   list(tg.stride), list(tg.ksize), list(tg.dilation),
                   list(tg.padding), tg.divide, tg.self_rows, batch_size,
                   counter)


# ---------------------------------------------------------------------------
# B2: gather-GEMM forward, and B3's dgrad through the same kernel
# ---------------------------------------------------------------------------

def weight_krsc_to_kv(weight: torch.Tensor) -> torch.Tensor:
    """KRSC ``[K, *ksize, C]`` -> ``[kv, C, K]`` contiguous."""
    k_out, c = weight.shape[0], weight.shape[-1]
    kv = int(np.prod(weight.shape[1:-1]))
    return weight.reshape(k_out, kv, c).permute(1, 2, 0).contiguous()


def _check_operands(name, x, other, pos):
    """Checks shared by the gather-GEMM wrappers: ``x`` and ``other`` f32
    or bf16 of one dtype, ``pos`` int32, all contiguous on one device, the
    CPU or CUDA."""
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"{name} takes float32 or bfloat16, got {x.dtype}")
    _check(other.dtype == x.dtype,
           f"{name}: dtype {other.dtype} != features dtype {x.dtype}")
    _check(pos.dtype == torch.int32, f"{name}: pos must be int32")
    _check(x.device == other.device == pos.device,
           f"{name}: operands must be on one device")
    _check(x.is_contiguous() and other.is_contiguous()
           and pos.is_contiguous(), f"{name} needs contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} kernel for {x.device}")


def _check_gather_gemm(name, x, weight_kv, pos, c_axis, n_out=None):
    """``x`` ``[N, *]`` whose width is ``weight_kv``'s axis ``c_axis``,
    ``weight_kv`` ``[kv, C, K]``, ``pos`` ``[kv, n_out]`` (``n_out``
    defaults to ``N``)."""
    _check(x.ndim == 2 and weight_kv.ndim == 3 and pos.ndim == 2,
           f"{name}: x must be [N, C], weight_kv [kv, C, K], pos [kv, N]")
    _check(weight_kv.shape[c_axis] == x.shape[1],
           f"{name}: weight is {tuple(weight_kv.shape)}, features have "
           f"width {x.shape[1]}")
    n_out = x.shape[0] if n_out is None else n_out
    _check(tuple(pos.shape) == (weight_kv.shape[0], n_out),
           f"pos is {tuple(pos.shape)}, expected "
           f"{(weight_kv.shape[0], n_out)}")
    _check_operands(name, x, weight_kv, pos)


def _count_name(base: str, path: str) -> str:
    """The ``launch_counts`` entry of kernel ``base`` on conv ``path``, one
    of :data:`PATHS`."""
    _check(path in PATHS, f"path must be one of {PATHS}, got {path!r}")
    return base if path == "subm" else f"{base}_{path}"


def dg_fwd(x: torch.Tensor, weight_kv: torch.Tensor, pos: torch.Tensor,
           path: str = "subm", tile: Optional[int] = None) -> torch.Tensor:
    """``out[i] = sum_k x[pos[k, i]] @ weight_kv[k]`` -> ``[pos.shape[1],
    K]`` in ``x.dtype`` (f32 accumulation, one rounding; rows without a
    match are 0).  ``x``: ``[N_src, C]`` f32 or bf16; ``weight_kv``:
    ``[kv, C, K]`` of the same dtype; ``pos``: ``[kv, N_dst]`` int32 whose
    entries lie in ``[-1, N_src)`` (the kernel trusts them: checking would
    cost a device sync per call).  ``path`` names the conv and so the
    launch count: ``"subm"`` (the table of :func:`build_dg_pos`, N_dst =
    N_src), ``"strided"`` (an affine table), ``"inverse"`` (a divide
    table), ``"transposed"`` (a divide table on swapped spaces) or
    ``"native"`` (a rulebook's ``pair_fwd``, ``ops/gather_gemm.py``; its
    rows in no key order).  ``tile``: B2's bf16 tile variant to launch
    (an index into :data:`B2_TILES`; None: :func:`b2_variant`'s pick),
    which the tuner passes on the native path; a bf16 call only.  Records
    no autograd graph on CUDA: :class:`DGConvFn` differentiates."""
    name = _count_name("dg_fwd", path)
    _check_gather_gemm(name, x, weight_kv, pos, 1,
                       n_out=None if path == "subm" else pos.shape[-1])
    _check(tile is None or (x.dtype == torch.bfloat16
                            and 0 <= tile < len(B2_TILES)),
           f"{name}: tile {tile} is not one of B2's {len(B2_TILES)} bf16 "
           f"tiles for {x.dtype} features")
    return _gather_gemm_op(x, weight_kv, pos, name, tile=tile)


def dg_fwd_plain(x: torch.Tensor, weight_kv: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Plain version: per offset, gather the matched rows and accumulate
    ``x[match].float() @ W[k].float()`` in f32 into ``[pos.shape[1], K]``.
    Memory stays at ``N x C`` per offset, never ``kv x N x C``."""
    out = torch.zeros((pos.shape[1], weight_kv.shape[2]),
                      dtype=torch.float32, device=x.device)
    for k in range(weight_kv.shape[0]):
        sel = torch.nonzero(pos[k] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = x[pos[k, sel].long()].float()
        out.index_add_(0, sel, rows @ weight_kv[k].float())
    return out.to(x.dtype)


def dg_dgrad(dout: torch.Tensor, weight_kv: torch.Tensor,
             pos_bwd: torch.Tensor, path: str = "subm") -> torch.Tensor:
    """Input gradient ``din[j] = sum_k dout[pos_bwd[k, j]] @ W[k]^T`` ->
    ``[pos_bwd.shape[1], C]`` in ``dout.dtype`` (f32 accumulation, one
    rounding).  ``dout``: ``[N_dst, K]``; ``weight_kv``: ``[kv, C, K]``;
    ``pos_bwd``: the backward's table ``[kv, N_src]`` of conv ``path``
    (:func:`dg_fwd`): the reversed table (``build_dg_pos(...,
    reverse=True)``, N_src = N_dst) for ``"subm"``, the divide table for
    ``"strided"``, the affine table for ``"inverse"`` and
    ``"transposed"``, a rulebook's ``pair_bwd`` for ``"native"``.  It is
    B2's function with ``W[k]^T``, so it launches
    B2's kernel; rows without a match (every invalid row) are 0."""
    name = _count_name("dg_dgrad", path)
    _check_gather_gemm(name, dout, weight_kv, pos_bwd, 2,
                       n_out=None if path == "subm" else pos_bwd.shape[-1])
    return _gather_gemm_op(dout, weight_kv, pos_bwd, name, trans=True)


def dg_dgrad_plain(dout: torch.Tensor, weight_kv: torch.Tensor,
                   pos_rev: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dg_dgrad`: :func:`dg_fwd_plain` with
    ``W[k]^T``."""
    return dg_fwd_plain(dout, weight_kv.transpose(1, 2), pos_rev)


# B2's bf16 tiles, by variant number: (rows BM, columns BN) of a block's
# output tile and the input channels BK of a pipeline step (csrc/dg_fwd.cu,
# b2::Tile0..4).  BN covers K up to 256, so a block gathers each matched
# row once for all of K.
B2_TILES = ((128, 16, 64), (128, 32, 64), (64, 64, 64), (64, 128, 32),
            (64, 256, 32))
_B2_WAVE = 132          # blocks of one wave: one per SM of the H100
_B2_MIN_SPLIT_BN = 64   # column tiles for a small N stop at this width


class B2Variant(NamedTuple):
    """The bf16 gather-GEMM kernel that one call launches."""
    tile: int     # index into B2_TILES
    bm: int
    bn: int
    grid: Tuple[int, int]  # (row tiles, column tiles)
    vec: bool     # 16-byte gathers of the features' rows, else element loads


def _full_width_tile(tiles, n: int, k_out: int):
    """``(tile, grid)`` of a gather-GEMM of ``n`` output rows and ``k_out``
    columns on ``tiles`` ((BM, BN, BK) by variant, BN ascending): the
    narrowest tile whose BN covers ``k_out`` (the widest, with column tiles
    past it), made narrower, down to 64 columns, while the call has fewer
    blocks than one wave."""
    tile = next((i for i, (_, bn, _) in enumerate(tiles) if bn >= k_out),
                len(tiles) - 1)

    def grid(t):
        bm, bn, _ = tiles[t]
        return -(-n // bm), -(-k_out // bn)

    while tiles[tile][1] > _B2_MIN_SPLIT_BN and np.prod(grid(tile)) < _B2_WAVE:
        tile -= 1
    return tile, grid(tile)


def b2_variant(n: int, c: int, k_out: int, aligned: bool = True
               ) -> B2Variant:
    """The tile of a bf16 gather-GEMM of ``n`` output rows, ``c`` input and
    ``k_out`` output channels: the narrowest tile whose BN covers ``k_out``
    (the widest, 256, with column tiles past it), made narrower, down to
    64 columns, while the call has fewer blocks than one wave.  ``vec``:
    the 16-byte gather, for ``c % 8 == 0`` and features ``aligned`` to 16
    bytes; else the scalar-gather variant."""
    tile, grid = _full_width_tile(B2_TILES, n, k_out)
    bm, bn, _ = B2_TILES[tile]
    return B2Variant(tile, bm, bn, grid, c % 8 == 0 and aligned)


def b2_smem_bytes(tile: int, trans: bool) -> int:
    """Dynamic shared memory of B2's bf16 tile ``tile`` (``trans``: the
    weight read as ``W[k]^T``), as ``b2::Tile::smem_bytes`` computes it: a
    ring of 4 stages, each a gathered ``[BM, BK]`` chunk and the weight's
    ``[BK, BN]`` chunk (``[BN, BK]`` transposed), rows padded by 8
    elements, then the rows of 32 offsets, their live bits and list."""
    bm, bn, bk = B2_TILES[tile]
    b_bytes = bn * (bk + 8) * 2 if trans else bk * (bn + 8) * 2
    return 4 * (bm * (bk + 8) * 2 + b_bytes) + (32 * bm + 2 * 32 + 1) * 4


def _gather_gemm_cuda(x, weight_kv, rows, counter, search=(), trans=False,
                      tile=None):
    """Launches B2's kernel and counts the launch under ``counter``.  Its
    rows come from ``rows``: the table ``[kv, N_dst]``, or with ``search``
    (the search mode's extra arguments, :func:`_search_args`) the keys
    ``[N]``.  The output has ``N_dst`` (``N``) rows; ``x`` is read only
    through the rows' matches.  ``trans``: multiply by ``W[k]^T``; the bf16
    kernel reads the ``[kv, C, K]`` weight as it is, the f32 one takes a
    transposed copy.  ``tile``: the bf16 tile variant (None:
    :func:`b2_variant`'s)."""
    from .._build import load_library

    if trans and x.dtype == torch.float32:
        weight_kv, trans = weight_kv.transpose(1, 2).contiguous(), False
    c = x.shape[1]
    kv = weight_kv.shape[0]
    k_out = weight_kv.shape[1 if trans else 2]
    n = rows.shape[-1]
    out = torch.empty((n, k_out), dtype=x.dtype, device=x.device)
    if n == 0 or k_out == 0:
        return out
    if c == 0:
        return out.zero_()
    mode = "search_" if search else ""
    lib = load_library()
    args = [ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(weight_kv.data_ptr()),
            ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, c, k_out, kv, *search]
    if x.dtype == torch.float32:
        err = getattr(lib, f"dg_fwd_{mode}f32_launch")(
            *args, _stream_ptr(x.device))
    else:
        v = b2_variant(n, c, k_out, aligned=x.data_ptr() % 16 == 0)
        err = getattr(lib, f"dg_fwd_{mode}bf16_launch")(
            *args, v.tile if tile is None else tile, int(v.vec), int(trans),
            _stream_ptr(x.device))
    _raise_on(err, counter)
    launch_counts[counter] += 1
    return out


# The search mode's geometry (a SearchGeom, or None for a table) as the
# ops take it: int lists (empty for a table) and the batch size

_NO_SEARCH = ([], [], [], 0)


def _search_lists(geom):
    return _NO_SEARCH if geom is None else (
        list(geom.ksize), list(geom.dilation), list(geom.spatial_shape),
        geom.batch_size)


def _search_geom(ksize, dilation, spatial_shape, batch_size):
    return SearchGeom(tuple(ksize), tuple(dilation), tuple(spatial_shape),
                      batch_size) if ksize else None


def _search_kv(rows, ksize):
    """Offsets of an op's table ``rows`` ``[kv, N]``, or of ``ksize``'s
    kernel in search mode."""
    return int(np.prod(ksize)) if ksize else rows.shape[0]


# B2's op: forward (trans False) and dgrad (trans True) on a table, or
# with a search geometry S1 and S2 on the keys


def _dg_gather_gemm_cuda(x, weight_kv, rows, ksize, dilation, spatial_shape,
                         batch_size, trans, tile, counter):
    geom = _search_geom(ksize, dilation, spatial_shape, batch_size)
    search = () if geom is None else (*_search_args(geom, counter),
                                      int(trans))
    return _gather_gemm_cuda(x, weight_kv, rows, counter, search, trans, tile)


def _dg_gather_gemm_cpu(x, weight_kv, rows, ksize, dilation, spatial_shape,
                        batch_size, trans, tile, counter):
    geom = _search_geom(ksize, dilation, spatial_shape, batch_size)
    pos = rows if geom is None else _table(rows, geom, reverse=trans)
    return (dg_dgrad_plain if trans else dg_fwd_plain)(x, weight_kv, pos)


def _dg_gather_gemm_fake(x, weight_kv, rows, ksize, dilation, spatial_shape,
                         batch_size, trans, tile, counter):
    return x.new_empty((rows.shape[-1], weight_kv.shape[1 if trans else 2]))


_DG_GATHER_GEMM = define_op(
    "dg_gather_gemm", "(Tensor x, Tensor weight_kv, Tensor rows, int[] ksize, "
    "int[] dilation, int[] spatial_shape, int batch_size, bool trans, "
    "int? tile, str counter) -> Tensor",
    cuda=_dg_gather_gemm_cuda, cpu=_dg_gather_gemm_cpu,
    fake=_dg_gather_gemm_fake)


def _gather_gemm_op(x, weight_kv, rows, counter, geom=None, trans=False,
                    tile=None):
    """Every B2 call goes through here: the ``dg_gather_gemm`` op on the
    table ``rows`` (or, with ``geom``, the keys), counted under
    ``counter`` on the card."""
    return _DG_GATHER_GEMM(x, weight_kv, rows, *_search_lists(geom), trans,
                           tile, counter)


# ---------------------------------------------------------------------------
# B7: int8 gather-GEMM with the fused requant epilogue
# ---------------------------------------------------------------------------

_ACTS_Q = ("none", "relu")


def dg_fwd_q(x: torch.Tensor, weight_kv: torch.Tensor, pos: torch.Tensor,
             scale: torch.Tensor, bias: Optional[torch.Tensor], *,
             act: str = "none", add: Optional[torch.Tensor] = None,
             add_scale: float = 1.0, path: str = "subm") -> torch.Tensor:
    """int8 conv through a match table (the JAX package's ``dg_subm_conv_q``
    and ``dg_regular_conv_q`` kernels) -> ``[pos.shape[1], K]`` int8.

    ``acc[i] = sum_k x[pos[k, i]] @ weight_kv[k]`` in int32, then per channel
    ``y = f32(acc) * scale + bias + f32(add) * add_scale``, ``act`` ("none"
    or "relu"), rounded half to even and clipped to [-127, 127], each float
    step rounded on its own as the TPU kernel does.  ``x``: ``[N_src, C]``
    int8; ``weight_kv``: ``[kv, C, K]`` int8, contiguous or the transposed
    view of a contiguous ``[kv, K, C]`` (the layout the kernel reads; a
    CUDA call copies any other into it, the int8 modules hold it so);
    ``pos``: ``[kv, N_dst]``
    int32 in ``[-1, N_src)`` (trusted, as :func:`dg_fwd`'s); ``scale`` and
    ``bias`` (or None): ``[K]`` f32, already divided by the output scale;
    ``add``: ``[N_dst, K]`` int8 residual, subm and native paths only;
    ``add_scale``: a Python float, rounded to f32 once.  Rows without a
    match get the epilogue of a zero sum.  ``path`` names the table and so
    the launch count, as :func:`dg_fwd`'s; the int8 transposed conv runs
    the ``"native"`` path on its rulebook, so ``"transposed"`` is
    refused."""
    _check(path != "transposed", "dg_fwd_q has no transposed path: the "
                                 "int8 transposed conv runs path='native' "
                                 "on its rulebook")
    name = _count_name("dg_fwd_q", path)
    _check(pos.ndim == 2, f"{name}: pos must be [kv, N]")
    n = pos.shape[1]
    _check_q(name, x, weight_kv, n, scale, bias, act, add, pos)
    _check(pos.shape[0] == weight_kv.shape[0]
           and (path != "subm" or n == x.shape[0]),
           f"{name}: pos is {tuple(pos.shape)} for {weight_kv.shape[0]} "
           f"offsets and {x.shape[0]} rows")
    _check(pos.dtype == torch.int32, f"{name}: pos must be int32")
    _check(add is None or path in ("subm", "native"),
           f"{name}: the residual add is subm-only (paths 'subm' and "
           "'native', whose rows align with the output's)")
    return _fwd_q_op(x, weight_kv, pos, scale, bias, act, add, add_scale,
                     name)


def _check_q(name, x, weight_kv, n, scale, bias, act, add, rows):
    """Checks shared by the int8 wrappers: ``x`` ``[N_src, C]`` and
    ``weight_kv`` ``[kv, C, K]`` int8, ``scale`` and ``bias`` ``[K]`` f32,
    ``act`` one of ``_ACTS_Q``, ``add`` ``[n, K]`` int8; every operand and
    ``rows`` (the table or the keys) on one device, the CPU or CUDA, and
    contiguous, ``weight_kv`` or its ``[kv, K, C]`` transpose."""
    _check(x.dtype == weight_kv.dtype == torch.int8,
           f"{name} takes int8 features and weights, got {x.dtype} and "
           f"{weight_kv.dtype}")
    _check(x.ndim == 2 and weight_kv.ndim == 3,
           f"{name}: x must be [N, C], weight_kv [kv, C, K]")
    _check(weight_kv.shape[1] == x.shape[1],
           f"{name}: weight is {tuple(weight_kv.shape)}, features have width "
           f"{x.shape[1]}")
    k_out = weight_kv.shape[2]
    _check(act in _ACTS_Q, f"{name}: act must be one of {_ACTS_Q}, got "
                           f"{act!r}")
    vecs = [v for v in (scale, bias) if v is not None]
    _check(all(v.dtype == torch.float32 and tuple(v.shape) == (k_out,)
               for v in vecs), f"{name}: scale and bias must be [{k_out}] "
                               "float32")
    if add is not None:
        _check(add.dtype == torch.int8 and tuple(add.shape) == (n, k_out),
               f"{name}: add must be [{n}, {k_out}] int8, got "
               f"{tuple(add.shape)} {add.dtype}")
        vecs.append(add)
    tensors = [x, rows] + vecs
    _check(all(t.device == x.device for t in tensors + [weight_kv]),
           f"{name}: operands must be on one device")
    _check(all(t.is_contiguous() for t in tensors)
           and (weight_kv.is_contiguous()
                or weight_kv.transpose(1, 2).is_contiguous()),
           f"{name} needs contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} kernel for {x.device}")


def dg_fwd_q_plain(x: torch.Tensor, weight_kv: torch.Tensor,
                   pos: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor], *, act: str = "none",
                   add: Optional[torch.Tensor] = None,
                   add_scale: float = 1.0) -> torch.Tensor:
    """Plain version of :func:`dg_fwd_q`: per offset, the matched rows'
    products summed in float64 (exact: every partial sum of int8 products
    stays far below 2^53, and torch has no integer matmul on CUDA), then the
    epilogue as separate f32 ops in the kernel's order."""
    acc = torch.zeros((pos.shape[1], weight_kv.shape[2]),
                      dtype=torch.float64, device=x.device)
    for k in range(weight_kv.shape[0]):
        sel = torch.nonzero(pos[k] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = x[pos[k, sel].long()].double()
        acc.index_add_(0, sel, rows @ weight_kv[k].double())
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    if add is not None:
        y = y + add.float() * float(np.float32(add_scale))
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return torch.round(y).clamp_(-127.0, 127.0).to(torch.int8)


# B7's tiles, by variant number: (rows BM, columns BN) of a block's output
# tile and the input channels BK of a pipeline step (csrc/dg_fwd_q.cu,
# b7::Tile0..3).  BN covers K up to 128, so a block gathers each matched
# row once for all of K; a step moves the bytes of B2's (B2_TILES).
B7_TILES = ((128, 16, 128), (128, 32, 128), (64, 64, 128), (64, 128, 64))


class B7Variant(NamedTuple):
    """The int8 gather-GEMM kernel that one call launches."""
    tile: int     # index into B7_TILES
    bm: int
    bn: int
    grid: Tuple[int, int]  # (row tiles, column tiles)
    vec: bool     # 16-byte gathers of the features' rows, else byte loads
    packed: bool  # C <= BK / 2: several offsets a step


def b7_variant(n: int, c: int, k_out: int, aligned: bool = True
               ) -> B7Variant:
    """The tile of an int8 gather-GEMM of ``n`` output rows, ``c`` input
    and ``k_out`` output channels: the narrowest tile whose BN covers
    ``k_out`` (the widest, 128, with column tiles past it), made narrower,
    down to 64 columns, while the call has fewer blocks than one wave (as
    :func:`b2_variant`).  ``vec``: the 16-byte gather, for ``c % 16 == 0``
    and features ``aligned`` to 16 bytes; else the scalar-gather variant.
    ``packed``: ``c`` at most half the tile's step BK, so that a step holds
    several offsets."""
    tile, grid = _full_width_tile(B7_TILES, n, k_out)
    bm, bn, bk = B7_TILES[tile]
    return B7Variant(tile, bm, bn, grid, c % 16 == 0 and aligned,
                     c <= bk // 2)


def b7_smem_bytes(tile: int) -> int:
    """Dynamic shared memory of B7's tile ``tile``, as
    ``b7::Tile::smem_bytes`` computes it: a ring of 4 stages, each a
    gathered ``[BM, BK]`` int8 chunk and ``W[k]^T``'s ``[BN, BK]``, rows
    padded by 16 bytes, then the rows of 32 offsets, their live bits and
    list."""
    bm, bn, bk = B7_TILES[tile]
    return 4 * (bm + bn) * (bk + 16) + (32 * bm + 2 * 32 + 1) * 4


def b7_mma_rows(pos: torch.Tensor, c: int, k_out: int) -> Tuple[int, int]:
    """``(issued, needed)`` MMA rows of one column tile of B7 on the table
    ``pos`` ``[kv, N]`` (or the rows S4 finds).  Issued: 16 for each (k32
    slice, 16-row tile) whose MMAs a warp runs.  A block stages its offsets
    32 at a time; an offset that matches nowhere in its rows takes no
    slice; a 16-row tile multiplies a slice where one of its rows matches
    one of the slice's offsets.  With ``c > 16`` an offset takes
    ``ceil(c / 32)`` slices; with ``c <= 16`` (packed) a slice holds two of
    the block's live offsets, in ascending order.  Needed: the rows a kernel
    that multiplied each matched (row, offset) pair alone, with no padding,
    would issue: the matched pairs times ``ceil(c / 32)``, or half of them
    packed."""
    kv, n = pos.shape
    bm = B7_TILES[b7_variant(n, c, k_out).tile][0]
    nb = -(-n // bm)
    m = torch.nn.functional.pad(pos >= 0, (0, nb * bm - n))
    tiles = m.reshape(kv, nb, bm // 16, 16).any(-1)  # [kv, blocks, tiles]
    rows = 0
    for k0 in range(0, kv, 32):
        g = tiles[k0:k0 + 32]
        if c > 16:
            rows += 16 * -(-c // 32) * int(g.sum())
            continue
        # each block's live offsets first, ascending, then pairs of them
        order = torch.argsort((~g.any(-1)).to(torch.int8), dim=0,
                              stable=True)
        g = torch.gather(g, 0, order[..., None].expand_as(g))
        if g.shape[0] % 2:
            g = torch.cat([g, torch.zeros_like(g[:1])])
        rows += 16 * int((g[0::2] | g[1::2]).sum())
    pairs = int((pos >= 0).sum())
    return rows, (-(-pairs // 2) if c <= 16 else pairs * -(-c // 32))


def _dg_fwd_q_cuda(x, weight_kv, rows, scale, bias, act, add, add_scale,
                   counter, search=()):
    """Launches B7's kernel on ``rows``, the table or (with ``search``)
    the keys, as :func:`_gather_gemm_cuda`, reading the weight as
    ``weight_kv.transpose(1, 2)`` (``[kv, K, C]``), copied only where that
    view is not contiguous."""
    from .._build import load_library

    c = x.shape[1]
    kv, _, k_out = weight_kv.shape
    n = rows.shape[-1]
    out = torch.empty((n, k_out), dtype=torch.int8, device=x.device)
    if n == 0 or k_out == 0:
        return out
    wt = weight_kv.transpose(1, 2)
    if not wt.is_contiguous():
        wt = wt.contiguous()

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    v = b7_variant(n, c, k_out, aligned=x.data_ptr() % 16 == 0)
    lib = load_library()
    launch = lib.dg_fwd_q_search_launch if search else lib.dg_fwd_q_launch
    err = launch(
        ptr(x), ptr(wt), ptr(rows), ptr(scale), ptr(bias), ptr(add),
        float(add_scale), int(act == "relu"), ptr(out), n, c, k_out, kv,
        *search, v.tile, int(v.vec), _stream_ptr(x.device))
    _raise_on(err, counter)
    launch_counts[counter] += 1
    return out


# B7's op: on a table, or with a search geometry S4 on the keys


def _dg_fwd_q_cuda_op(x, weight_kv, rows, scale, bias, add, add_scale, act,
                      ksize, dilation, spatial_shape, batch_size, counter):
    geom = _search_geom(ksize, dilation, spatial_shape, batch_size)
    return _dg_fwd_q_cuda(x, weight_kv, rows, scale, bias, act, add,
                          add_scale, counter,
                          () if geom is None else _search_args(geom, counter))


def _dg_fwd_q_cpu(x, weight_kv, rows, scale, bias, add, add_scale, act,
                  ksize, dilation, spatial_shape, batch_size, counter):
    geom = _search_geom(ksize, dilation, spatial_shape, batch_size)
    pos = rows if geom is None else _table(rows, geom)
    return dg_fwd_q_plain(x, weight_kv, pos, scale, bias, act=act, add=add,
                          add_scale=add_scale)


def _dg_fwd_q_fake(x, weight_kv, rows, *args):
    return x.new_empty((rows.shape[-1], weight_kv.shape[2]))


_DG_FWD_Q = define_op(
    "dg_fwd_q", "(Tensor x, Tensor weight_kv, Tensor rows, Tensor scale, "
    "Tensor? bias, Tensor? add, float add_scale, str act, int[] ksize, "
    "int[] dilation, int[] spatial_shape, int batch_size, str counter) -> "
    "Tensor", cuda=_dg_fwd_q_cuda_op, cpu=_dg_fwd_q_cpu, fake=_dg_fwd_q_fake)


def _fwd_q_op(x, weight_kv, rows, scale, bias, act, add, add_scale, counter,
              geom=None):
    """Every B7 call goes through here: the ``dg_fwd_q`` op on the table
    ``rows`` (or, with ``geom``, the keys), counted under ``counter`` on
    the card."""
    return _DG_FWD_Q(x, weight_kv, rows, scale, bias, add, float(add_scale),
                     act, *_search_lists(geom), counter)


# ---------------------------------------------------------------------------
# B3: weight gradient
# ---------------------------------------------------------------------------

# wgrad's bf16 tiles, by variant number: the input channels BM and output
# channels BN of a block's dW tile, its warps (WARPS_M, WARPS_N) and the
# listed rows BJ of a pipeline step (csrc/dg_wgrad.cu, wg::Tile0..5).  BM
# follows C (16 for C <= 16) and BN follows K, so x and dout are each
# gathered once per offset up to C, K = 128.
WGRAD_TILES = ((16, 64, 1, 4, 64), (32, 64, 2, 2, 64), (64, 64, 2, 2, 32),
               (64, 128, 2, 4, 32), (128, 64, 4, 2, 32), (128, 128, 4, 4, 32))
# a narrower tile for a call with fewer blocks than one wave
_WGRAD_NARROWER = {5: 3, 4: 2, 3: 2}
_WGRAD_SMS = 132            # the H100's SMs
_WGRAD_SM_SMEM = 228 << 10  # bytes of shared memory an SM holds
_WGRAD_WAVES = 4            # splits aim at four waves of resident blocks
_WGRAD_MIN_ROWS = 512       # rows per split, at least: one listed chunk
_WGRAD_SCRATCH = 64 << 20   # bytes of f32 partials, at most


class WgradVariant(NamedTuple):
    """The bf16 wgrad kernel that one call launches."""
    tile: int      # index into WGRAD_TILES
    bm: int
    bn: int
    grid: Tuple[int, int, int]  # (dW tiles, offsets, row splits)
    vec: bool      # 16-byte gathers of x's rows, else element loads
    dvec: bool     # the same for dout's rows


def _wgrad_grid(tile, n, c, k_out, kv, splits=None):
    bm, bn, wm, wn, _ = WGRAD_TILES[tile]
    tiles = -(-c // bm) * -(-k_out // bn)
    if splits is None:
        # resident blocks: by registers (128 a thread: 512 threads an SM)
        # and by shared memory (1 KB of each block reserved)
        slots = _WGRAD_SMS * min(
            512 // (32 * wm * wn),
            _WGRAD_SM_SMEM // (wgrad_smem_bytes(tile) + 1024))
        splits = -(-_WGRAD_WAVES * slots // (tiles * kv))
        splits = max(1, min(splits, -(-n // _WGRAD_MIN_ROWS),
                            _WGRAD_SCRATCH // max(1, 4 * kv * c * k_out)))
    return tiles, kv, splits


def wgrad_variant(n: int, c: int, k_out: int, kv: int = 27,
                  aligned: bool = True, dout_aligned: bool = True
                  ) -> WgradVariant:
    """The tile and row splits of a bf16 weight gradient over ``n`` rows of
    ``x`` (``c`` channels), ``k_out`` output channels and ``kv`` offsets:
    BM the narrowest of 16, 32, 64, 128 that covers ``c`` (128 with channel
    tiles past it), BN 64 for ``k_out <= 64``, else 128 (with column tiles
    past it); a 128-channel tile goes down to 64 while the call has fewer
    blocks than one wave.  Splits aim at four waves of resident blocks, with
    at least 512 rows a split and at most 64 MB of f32 partials ``[S, kv,
    C, K]``.  ``vec`` / ``dvec``: the 16-byte gathers of x / dout, for
    ``c % 8 == 0`` / ``k_out % 8 == 0`` and the features ``aligned`` to 16
    bytes; else the scalar-gather variant for that operand."""
    if c <= 32:
        tile = 0 if c <= 16 else 1
    else:
        tile = (2, 3)[k_out > 64] if c <= 64 else (4, 5)[k_out > 64]
    while tile in _WGRAD_NARROWER and np.prod(_wgrad_grid(
            tile, n, c, k_out, kv, -(-n // _WGRAD_MIN_ROWS))) < _WGRAD_SMS:
        tile = _WGRAD_NARROWER[tile]
    bm, bn = WGRAD_TILES[tile][:2]
    return WgradVariant(tile, bm, bn, _wgrad_grid(tile, n, c, k_out, kv),
                        c % 8 == 0 and aligned,
                        k_out % 8 == 0 and dout_aligned)


def wgrad_smem_bytes(tile: int) -> int:
    """Dynamic shared memory of wgrad's bf16 tile ``tile``, as
    ``wg::Tile::smem_bytes`` computes it: a ring of 4 stages, each the
    ``[BJ, BM]`` chunk of x and the ``[BJ, BN]`` chunk of dout, rows padded
    by 8 elements, then the list of 1,024 ``(j, p)`` pairs and 16 warp
    counts."""
    bm, bn, _, _, bj = WGRAD_TILES[tile]
    return 4 * bj * (bm + 8 + bn + 8) * 2 + 1024 * 8 + 16 * 4


def wgrad_splits(n: int, kv: int, c: int, k_out: int) -> int:
    """Row splits S of the wgrad kernels (:func:`wgrad_variant`'s)."""
    return wgrad_variant(n, c, k_out, kv).grid[2]


def wgrad_rows_per_split(n: int, splits: int) -> int:
    """Rows of each split, as the kernels cut them: ``n / S`` rounded up to
    32; the last split takes the rest, and may be empty."""
    rows = -(-n // splits)
    return -(-rows // 32) * 32


def wgrad_mma_rows(pos_bwd: torch.Tensor, c: int, k_out: int
                   ) -> Tuple[int, int]:
    """``(MMA rows, matched pairs)`` of one dW tile of the bf16 wgrad
    kernel on the backward's table ``pos_bwd``: each (offset, split) block
    multiplies its matched rows, listed without gaps, in whole 16-row
    slices."""
    kv, n = pos_bwd.shape
    s = wgrad_splits(n, kv, c, k_out)
    r = wgrad_rows_per_split(n, s)
    m = torch.nn.functional.pad((pos_bwd >= 0).int(), (0, s * r - n))
    per = m.reshape(kv, s, r).sum(-1)
    return int(((per + 15) // 16 * 16).sum()), int(per.sum())


def dg_wgrad(x: torch.Tensor, dout: torch.Tensor, pos_bwd: torch.Tensor,
             path: str = "subm") -> torch.Tensor:
    """Weight gradient ``dW[k] = sum_j x[j]^T dout[pos_bwd[k, j]]`` ->
    ``[kv, C, K]`` in ``x.dtype``, summed in f32 and rounded once.  ``x``:
    ``[N_src, C]``; ``dout``: ``[N_dst, K]`` of the same dtype (N_dst =
    N_src for ``"subm"``), read only through ``pos_bwd``, the backward's
    ``[kv, N_src]`` table of conv ``path`` (see :func:`dg_dgrad`).  The
    kernel sums row splits into f32
    partials and adds them in a fixed order, so two runs give bit-equal
    results."""
    name = _count_name("dg_wgrad", path)
    _check(x.ndim == 2 and dout.ndim == 2 and pos_bwd.ndim == 2,
           f"{name}: x must be [N, C], dout [N_dst, K], pos_bwd [kv, N]")
    _check(x.shape[0] == pos_bwd.shape[1]
           and (path != "subm" or dout.shape[0] == x.shape[0]),
           f"{name}: x has {x.shape[0]} rows, dout {dout.shape[0]}, "
           f"pos_bwd {pos_bwd.shape[1]}")
    _check_operands(name, x, dout, pos_bwd)
    return _wgrad_op(x, dout, pos_bwd, name)


def dg_wgrad_plain(x: torch.Tensor, dout: torch.Tensor,
                   pos_bwd: torch.Tensor) -> torch.Tensor:
    """Plain version: per offset, ``x[sel].float()^T @
    dout[pos_bwd[k, sel]].float()`` over the rows ``sel`` that match."""
    kv = pos_bwd.shape[0]
    dw = torch.zeros((kv, x.shape[1], dout.shape[1]), dtype=torch.float32,
                     device=x.device)
    for k in range(kv):
        sel = torch.nonzero(pos_bwd[k] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        dw[k] = x[sel].float().t() @ dout[pos_bwd[k, sel].long()].float()
    return dw.to(x.dtype)


def _dg_wgrad_cuda(x, dout, rows, kv, counter, search=()):
    """Launches the wgrad kernel for ``kv`` offsets on ``rows``, the
    backward's table or (with ``search``) the keys, as
    :func:`_gather_gemm_cuda`."""
    from .._build import load_library

    n, c = x.shape
    k_out = dout.shape[1]
    out = torch.empty((kv, c, k_out), dtype=x.dtype, device=x.device)
    if kv == 0 or c == 0 or k_out == 0:
        return out
    if n == 0:
        return out.zero_()
    mode = "search_" if search else ""
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        v = wgrad_variant(n, c, k_out, kv, aligned=x.data_ptr() % 16 == 0,
                          dout_aligned=dout.data_ptr() % 16 == 0)
        splits = v.grid[2]
    else:
        splits = wgrad_splits(n, kv, c, k_out)
    # the bf16 kernel writes dW itself when there is one split
    part = torch.empty((splits, kv, c, k_out) if splits > 1 or not bf16
                       else (0,), dtype=torch.float32, device=x.device)
    launch = getattr(load_library(),
                     f"dg_wgrad_{mode}{'bf16' if bf16 else 'f32'}_launch")
    args = [ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(dout.data_ptr()),
            ctypes.c_void_p(rows.data_ptr()),
            ctypes.c_void_p(part.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, c, k_out, kv, splits,
            *search]
    if bf16:
        args += [v.tile, int(v.vec), int(v.dvec)]
    err = launch(*args, _stream_ptr(x.device))
    _raise_on(err, counter)
    launch_counts[counter] += 1
    return out


# wgrad's op: on the backward's table, or with a search geometry S3 on the
# keys (the reversed probes)


def _dg_wgrad_cuda_op(x, dout, rows, ksize, dilation, spatial_shape,
                      batch_size, counter):
    geom = _search_geom(ksize, dilation, spatial_shape, batch_size)
    return _dg_wgrad_cuda(x, dout, rows, _search_kv(rows, ksize), counter,
                          () if geom is None else _search_args(geom, counter))


def _dg_wgrad_cpu(x, dout, rows, ksize, dilation, spatial_shape, batch_size,
                  counter):
    geom = _search_geom(ksize, dilation, spatial_shape, batch_size)
    pos = rows if geom is None else _table(rows, geom, reverse=True)
    return dg_wgrad_plain(x, dout, pos)


def _dg_wgrad_fake(x, dout, rows, ksize, *args):
    return x.new_empty((_search_kv(rows, ksize), x.shape[1], dout.shape[1]))


_DG_WGRAD = define_op(
    "dg_wgrad", "(Tensor x, Tensor dout, Tensor rows, int[] ksize, "
    "int[] dilation, int[] spatial_shape, int batch_size, str counter) -> "
    "Tensor", cuda=_dg_wgrad_cuda_op, cpu=_dg_wgrad_cpu, fake=_dg_wgrad_fake)


def _wgrad_op(x, dout, rows, counter, geom=None):
    """Every wgrad call goes through here: the ``dg_wgrad`` op on the
    backward's table ``rows`` (or, with ``geom``, the keys), counted under
    ``counter`` on the card."""
    return _DG_WGRAD(x, dout, rows, *_search_lists(geom), counter)


# ---------------------------------------------------------------------------
# S1-S4: the subm conv's kernels in search mode, no match table
# ---------------------------------------------------------------------------

class SearchGeom(NamedTuple):
    """The geometry a search-mode subm kernel decodes its probes with: the
    kernel size and dilation, the grid and the batch size (the arguments of
    :func:`build_dg_pos`)."""
    ksize: Tuple[int, ...]
    dilation: Tuple[int, ...]
    spatial_shape: Tuple[int, ...]
    batch_size: int

    @classmethod
    def of(cls, ksize, dilation, spatial_shape, batch_size) -> "SearchGeom":
        """Normalized to tuples of ints; raises unless the three have one
        entry per axis."""
        g = cls(tuple(int(k) for k in ksize), tuple(int(d) for d in dilation),
                tuple(int(s) for s in spatial_shape), int(batch_size))
        _check(len(g.ksize) == len(g.dilation) == len(g.spatial_shape),
               "ksize, dilation and spatial_shape must have ndim entries")
        return g


def _check_search(name, geom: SearchGeom, keys, kv, n):
    """``keys`` ``[n]`` int32 and ``kv`` offsets of ``geom``'s kernel."""
    _check(isinstance(geom, SearchGeom), f"{name}: geom must be a SearchGeom")
    _check_keys("keys", keys)
    _check(keys.shape[0] == n, f"{name}: keys has {keys.shape[0]} rows, the "
                               f"features {n}")
    _check(kv == int(np.prod(geom.ksize)),
           f"{name}: weight has {kv} offsets, the kernel {geom.ksize} "
           f"{int(np.prod(geom.ksize))}")


def _search_args(geom: SearchGeom, name: str):
    """The search mode's extra launch arguments ``(host geometry,
    sentinel)``: ``geom`` laid out as ``dg_pos_launch``'s."""
    ndim = len(geom.spatial_shape)
    if ndim > _MAX_NDIM:
        raise NotImplementedError(f"{name} kernel takes ndim <= {_MAX_NDIM}")
    pad = [1] * (_MAX_NDIM - ndim)
    host = (ctypes.c_int * (1 + 3 * _MAX_NDIM))(
        ndim, *(list(geom.spatial_shape) + pad), *(list(geom.ksize) + pad),
        *(list(geom.dilation) + pad))
    return host, C.grid_sentinel(geom.spatial_shape, geom.batch_size)


def _table(keys, geom: SearchGeom, reverse=False):
    """B1's plain version on ``geom``: the table the search finds."""
    return dg_pos_plain(keys, reverse=reverse, **geom._asdict())


def dg_fwd_search(x: torch.Tensor, weight_kv: torch.Tensor,
                  keys: torch.Tensor, geom: SearchGeom) -> torch.Tensor:
    """S1: ``out[i] = sum_k x[m_k(i)] @ weight_kv[k]`` -> ``[N, K]`` in
    ``x.dtype``, where ``m_k(i)`` is the row whose key is ``keys[i]`` moved
    by kernel offset ``k`` of ``geom`` (bounds-checked on every axis), or
    none: :func:`dg_fwd` on ``build_dg_pos(keys, **geom)``, bit for bit,
    with no table.  ``x``: ``[N, C]`` f32 or bf16; ``weight_kv``: ``[kv, C,
    K]``; ``keys``: ``[N]`` int32 ascending with the sentinel tail.  Records
    no autograd graph on CUDA: :class:`DGSearchFn` differentiates."""
    name = "dg_fwd_search"
    _check(x.ndim == 2 and weight_kv.ndim == 3
           and weight_kv.shape[1] == x.shape[1],
           f"{name}: x must be [N, C], weight_kv [kv, C, K]")
    _check_search(name, geom, keys, weight_kv.shape[0], x.shape[0])
    _check_operands(name, x, weight_kv, keys)
    return _gather_gemm_op(x, weight_kv, keys, name, geom)


def dg_fwd_search_plain(x, weight_kv, keys, geom: SearchGeom):
    """Plain version of :func:`dg_fwd_search`: :func:`dg_pos_plain`, then
    :func:`dg_fwd_plain`."""
    return dg_fwd_plain(x, weight_kv, _table(keys, geom))


def dg_dgrad_search(dout: torch.Tensor, weight_kv: torch.Tensor,
                    keys: torch.Tensor, geom: SearchGeom) -> torch.Tensor:
    """S2: the input gradient ``din[j] = sum_k dout[m_k^rev(j)] @ W[k]^T``
    -> ``[N, C]``, where ``m_k^rev`` moves by the negated offset:
    :func:`dg_dgrad` on ``build_dg_pos(keys, reverse=True, **geom)``, bit
    for bit, with no table (S1's kernel on ``W[k]^T``)."""
    name = "dg_dgrad_search"
    _check(dout.ndim == 2 and weight_kv.ndim == 3
           and weight_kv.shape[2] == dout.shape[1],
           f"{name}: dout must be [N, K], weight_kv [kv, C, K]")
    _check_search(name, geom, keys, weight_kv.shape[0], dout.shape[0])
    _check_operands(name, dout, weight_kv, keys)
    return _gather_gemm_op(dout, weight_kv, keys, name, geom, trans=True)


def dg_dgrad_search_plain(dout, weight_kv, keys, geom: SearchGeom):
    """Plain version of :func:`dg_dgrad_search`: the reversed
    :func:`dg_pos_plain`, then :func:`dg_dgrad_plain`."""
    return dg_dgrad_plain(dout, weight_kv, _table(keys, geom, reverse=True))


def dg_wgrad_search(x: torch.Tensor, dout: torch.Tensor, keys: torch.Tensor,
                    geom: SearchGeom) -> torch.Tensor:
    """S3: the weight gradient ``dW[k] = sum_j x[j]^T dout[m_k^rev(j)]`` ->
    ``[kv, C, K]`` in ``x.dtype``: :func:`dg_wgrad` on ``build_dg_pos(keys,
    reverse=True, **geom)``, bit for bit (the same row splits and
    fixed-order sum), with no table."""
    name = "dg_wgrad_search"
    _check(x.ndim == 2 and dout.ndim == 2 and dout.shape[0] == x.shape[0],
           f"{name}: x must be [N, C] and dout [N, K]")
    kv = int(np.prod(geom.ksize))
    _check_search(name, geom, keys, kv, x.shape[0])
    _check_operands(name, x, dout, keys)
    return _wgrad_op(x, dout, keys, name, geom)


def dg_wgrad_search_plain(x, dout, keys, geom: SearchGeom):
    """Plain version of :func:`dg_wgrad_search`: the reversed
    :func:`dg_pos_plain`, then :func:`dg_wgrad_plain`."""
    return dg_wgrad_plain(x, dout, _table(keys, geom, reverse=True))


def dg_fwd_q_search(x: torch.Tensor, weight_kv: torch.Tensor,
                    keys: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor], geom: SearchGeom, *,
                    act: str = "none", add: Optional[torch.Tensor] = None,
                    add_scale: float = 1.0) -> torch.Tensor:
    """S4: the int8 subm conv with no table -> ``[N, K]`` int8:
    :func:`dg_fwd_q` on ``build_dg_pos(keys, **geom)``, bit for bit
    (operands as its, ``keys`` as :func:`dg_fwd_search`'s)."""
    name = "dg_fwd_q_search"
    _check_q(name, x, weight_kv, x.shape[0], scale, bias, act, add, keys)
    _check_search(name, geom, keys, weight_kv.shape[0], x.shape[0])
    return _fwd_q_op(x, weight_kv, keys, scale, bias, act, add, add_scale,
                     name, geom)


def dg_fwd_q_search_plain(x, weight_kv, keys, scale, bias,
                          geom: SearchGeom, *, act="none", add=None,
                          add_scale=1.0):
    """Plain version of :func:`dg_fwd_q_search`: :func:`dg_pos_plain`, then
    :func:`dg_fwd_q_plain`."""
    return dg_fwd_q_plain(x, weight_kv, _table(keys, geom), scale, bias,
                          act=act, add=add, add_scale=add_scale)


# ---------------------------------------------------------------------------
# the convs, with their backward
# ---------------------------------------------------------------------------

class DGConvFn(torch.autograd.Function):
    """:func:`dg_fwd` on conv ``path``'s forward table ``pos`` ``[kv,
    N_dst]``, with the backward of the JAX package's ``_dg_conv_p`` (subm)
    and ``_dg_reg_conv`` (strided, inverse): ``dout`` is cast to the
    features' dtype, ``din`` comes from :func:`dg_dgrad` and ``dW`` from
    :func:`dg_wgrad`, both through the backward's table ``pos_bwd`` ``[kv,
    N_src]``.  ``din`` is skipped when the features need no gradient (the
    JAX package computes it and drops it)."""

    @staticmethod
    def forward(ctx, x, weight_kv, pos, pos_bwd, path):
        ctx.save_for_backward(x, weight_kv, pos_bwd)
        ctx.path = path
        return dg_fwd(x, weight_kv, pos, path=path)

    @staticmethod
    def backward(ctx, dout):
        x, weight_kv, pos_bwd = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        din = dw = None
        if ctx.needs_input_grad[0]:
            din = dg_dgrad(dout, weight_kv, pos_bwd, path=ctx.path)
        if ctx.needs_input_grad[1]:
            # in x's dtype, which dg_fwd checked is the weight's
            dw = dg_wgrad(x, dout, pos_bwd, path=ctx.path)
        return din, dw, None, None, None


def _wants_grad(features: torch.Tensor, weight: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (features.requires_grad
                                        or weight.requires_grad)


def dg_subm_conv(features: torch.Tensor, weight: torch.Tensor,
                 pos: torch.Tensor,
                 pos_rev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Subm conv of key-sorted features through a cached match table.
    ``weight`` is KRSC ``[K, *ksize, C]``; returns ``[N, K]``.  When grad
    mode is on and ``features`` or ``weight`` needs a gradient, the call is
    recorded through :class:`DGConvFn`, which needs the reversed table
    ``pos_rev``."""
    kv = int(np.prod(weight.shape[1:-1]))
    _check(pos.shape[0] == kv,
           f"pos has {pos.shape[0]} offsets, weight has {kv}")
    weight_kv = weight_krsc_to_kv(weight)
    if _wants_grad(features, weight):
        _check(pos_rev is not None,
               "a gradient through the DG conv needs the reversed match "
               "table (build_dg_pos(..., reverse=True)) as pos_rev")
        _check(pos_rev.shape == pos.shape,
               f"pos_rev is {tuple(pos_rev.shape)}, pos {tuple(pos.shape)}")
        return DGConvFn.apply(features, weight_kv, pos, pos_rev, "subm")
    return dg_fwd(features, weight_kv, pos)


def dg_regular_conv(
    features: torch.Tensor,
    in_keys: torch.Tensor,
    out_keys: torch.Tensor,
    weight: torch.Tensor,
    *,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    batch_size: int,
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    path: str = "strided",
    pos: Optional[torch.Tensor] = None,
    pos_bwd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Regular (``path="strided"``) or ``"inverse"`` conv of key-sorted
    features (the JAX package's ``dg_regular_conv``).  ``in_keys``
    ``[N_in]`` and ``out_keys`` ``[N_out]`` are the ascending keys of the
    regular conv's input and output sites on ``in_shape`` and
    ``out_shape``; ``weight`` is KRSC ``[K, *ksize, C]``.  The regular conv
    maps ``features`` ``[N_in, C]`` onto
    the output sites through the affine table; the inverse conv maps
    ``features`` ``[N_out, C]`` back onto the input sites through the
    divide table, with ``W[k]`` as it is.  A transposed conv is the inverse
    conv with the spaces swapped (the JAX package's ``conv.py:816-826``):
    ``in_keys`` / ``in_shape`` are its expanded output sites and grid,
    ``out_keys`` / ``out_shape`` its input's; its ``path="transposed"``
    runs the inverse mode and counts its launches apart.

    ``pos`` is the forward's table (affine, or divide on the inverse mode)
    and ``pos_bwd`` the other one, which only a gradient needs; each is
    built when it is needed and not given (a cached one).  When grad mode is on
    and ``features`` or ``weight`` needs a gradient, the call is recorded
    through :class:`DGConvFn`.  Returns ``(out, pos, pos_bwd)``: ``out``
    ``[N_out, K]`` (``[N_in, K]`` on the inverse mode), and ``pos_bwd`` None
    when it was neither needed nor given."""
    ksize = tuple(int(k) for k in weight.shape[1:-1])
    kv = int(np.prod(ksize))
    geom = dict(ksize=ksize, stride=stride, padding=padding,
                dilation=dilation, in_shape=in_shape, out_shape=out_shape,
                batch_size=batch_size)
    _check_reg_path(path)
    inverse = path != "strided"
    n_in, n_out = in_keys.shape[0], out_keys.shape[0]
    # the rows the features live on, and the rows the output gets
    n_src, n_dst = (n_out, n_in) if inverse else (n_in, n_out)
    build_fwd, build_bwd = ((build_dg_pos_divide, build_dg_pos_affine)
                            if inverse else
                            (build_dg_pos_affine, build_dg_pos_divide))
    # the kernel trusts the table's rows to index features
    _check(features.shape[0] == n_src,
           f"{'out' if inverse else 'in'}_keys has {n_src} rows, features "
           f"{features.shape[0]}")
    if pos is None:
        pos = build_fwd(in_keys, out_keys, path=path, **geom)
    _check(tuple(pos.shape) == (kv, n_dst),
           f"pos is {tuple(pos.shape)}, expected {(kv, n_dst)}")
    weight_kv = weight_krsc_to_kv(weight)
    if not _wants_grad(features, weight):
        return dg_fwd(features, weight_kv, pos, path=path), pos, pos_bwd
    if pos_bwd is None:
        pos_bwd = build_bwd(in_keys, out_keys, path=path, **geom)
    _check(tuple(pos_bwd.shape) == (kv, n_src),
           f"pos_bwd is {tuple(pos_bwd.shape)}, expected {(kv, n_src)}")
    return (DGConvFn.apply(features, weight_kv, pos, pos_bwd, path), pos,
            pos_bwd)


class DGSearchFn(torch.autograd.Function):
    """The table-free subm conv (the JAX package's ``_dg_conv`` and its VJP
    ``_dg_conv_bwd``): :func:`dg_fwd_search` forward; ``dout`` cast to the
    features' dtype, ``din`` from :func:`dg_dgrad_search` and ``dW`` from
    :func:`dg_wgrad_search`, both on the reversed probes.  ``din`` is
    skipped when the features need no gradient."""

    @staticmethod
    def forward(ctx, x, weight_kv, keys, geom):
        ctx.save_for_backward(x, weight_kv, keys)
        ctx.geom = geom
        return dg_fwd_search(x, weight_kv, keys, geom)

    @staticmethod
    def backward(ctx, dout):
        x, weight_kv, keys = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        din = dw = None
        if ctx.needs_input_grad[0]:
            din = dg_dgrad_search(dout, weight_kv, keys, ctx.geom)
        if ctx.needs_input_grad[1]:
            dw = dg_wgrad_search(x, dout, keys, ctx.geom)
        return din, dw, None, None


def dg_subm_conv_search(features: torch.Tensor, keys: torch.Tensor,
                        weight: torch.Tensor, *,
                        spatial_shape: Sequence[int], batch_size: int,
                        dilation: Sequence[int]) -> torch.Tensor:
    """Subm conv of key-sorted features with no match table (the JAX
    package's ``dg_subm_conv(pos=None)``): ``keys`` ``[N]`` are the rows'
    linearized keys, ascending with the sentinel tail; ``weight`` is KRSC
    ``[K, *ksize, C]``; returns ``[N, K]``.  When grad mode is on and
    ``features`` or ``weight`` needs a gradient, the call is recorded
    through :class:`DGSearchFn`."""
    geom = SearchGeom.of(weight.shape[1:-1], dilation, spatial_shape,
                         batch_size)
    weight_kv = weight_krsc_to_kv(weight)
    if _wants_grad(features, weight):
        return DGSearchFn.apply(features, weight_kv, keys, geom)
    return dg_fwd_search(features, weight_kv, keys, geom)
