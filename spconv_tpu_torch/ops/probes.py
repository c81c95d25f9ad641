"""The probe kernels (B9, kernels in ``csrc/probes.cu``): counterparts of
the fixed-shape Pallas kernels of the JAX package's ``tools/probe_*.py``,
which the scripts of ``spconv_tpu_torch.tools`` run.

The Pallas probes compute seven functions; each is a wrapper here with its
plain PyTorch version beside it:

* :func:`copy_rows` (copy family): ``out[r] = x[start * scale + off + r]``
  for ``r < rows``, with ``start`` read on the device (the role of the
  Pallas kernels' scalar prefetch), int8 widened to int32, launched on
  :func:`copy_plan`'s blocks;
* :func:`transpose` (copy family): ``a^T`` of an f32 matrix, launched on
  :func:`transpose_plan`'s blocks;
* :func:`lane_gather` and :func:`row_broadcast` (gather family): ``out[r,
  l] = x[r, idx[r, l]]``, and ``out[r, l] = scale * x[row, l]``, launched
  on :func:`gather_plan`'s warps;
* :func:`keyed_sum` (search family): the one-hot join ``out[t] = sum_w
  [probes[t] == keys[w]] * table[w]``, int8 -> int32 or f32, launched on
  :func:`join_plan`'s blocks;
* :func:`lane_rank` (search family): ``out[r, :] = #{keys < probes[r,
  0]}``, launched on :func:`rank_plan`'s warps;
* :func:`gemm` (gemm family): ``a @ b`` on the tensor cores, s8 -> s32, or
  f32 inputs rounded to bf16 with f32 sums, launched on
  :func:`gemm_plan`'s tile and K split.

A wrapper takes the plain version only for tensors on the CPU.  On a CUDA
tensor it launches its kernel or raises; it never falls back.  Each launch
adds one to its entry of ``launch_counts``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .dg_conv import sm_count

__all__ = [
    "copy_rows",
    "copy_rows_plain",
    "COPY_THREADS",
    "CopyPlan",
    "copy_plan",
    "copy_launch_plan",
    "launch_copy",
    "transpose",
    "transpose_plain",
    "TRANSPOSE_TILES",
    "TransposePlan",
    "transpose_plan",
    "transpose_launch_plan",
    "launch_transpose",
    "lane_gather",
    "lane_gather_plain",
    "row_broadcast",
    "row_broadcast_plain",
    "GATHER_WARPS",
    "BROADCAST_ROWS",
    "GatherPlan",
    "gather_plan",
    "launch_gather",
    "launch_broadcast",
    "keyed_sum",
    "keyed_sum_plain",
    "JOIN_THREADS",
    "JOIN_SEARCHES",
    "JOIN_COUNT_KEYS",
    "JoinPlan",
    "join_plan",
    "join_launch_plan",
    "launch_join",
    "lane_rank",
    "lane_rank_plain",
    "RANK_WARPS",
    "RANK_SEARCHES",
    "RANK_COUNT_KEYS",
    "RankPlan",
    "rank_plan",
    "rank_launch_plan",
    "rank_row_split",
    "launch_rank",
    "gemm",
    "gemm_plain",
    "GEMM_TILES",
    "GEMM_WARPS",
    "GemmPlan",
    "gemm_plan",
    "launch_gemm",
    "launch_counts",
    "reset_launch_counts",
]

# launches of each probe kernel since the last reset_launch_counts()
launch_counts = dict.fromkeys(
    ("probe_copy", "probe_transpose", "probe_lane_gather",
     "probe_row_broadcast", "probe_join", "probe_rank", "probe_gemm_s8",
     "probe_gemm_bf16"), 0)

# copy_rows' element kinds, as probe_copy_launch takes them
_COPY_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.int32: 2,
              torch.float32: 2}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _operands(name, *tensors):
    """Every tensor contiguous on one device, the CPU or CUDA; returns
    whether that is CUDA."""
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors),
           f"{name}: operands must be on one device")
    _check(all(t.is_contiguous() for t in tensors),
           f"{name} needs contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} kernel for {dev}")
    return dev.type == "cuda"


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(entry: str, counter: str, *args, device: torch.device) -> None:
    from .._build import load_library

    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    err = getattr(load_library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: cudaError {err}")
    launch_counts[counter] += 1


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


# ---------------------------------------------------------------------------
# copy family
# ---------------------------------------------------------------------------

# a copy block's threads: at the probes' 8-32 KB on the H100, blocks of
# 128-256 threads are as fast as any, and smaller blocks (more of them) up
# to 0.08 us slower (tools/copy_tiles.py's sweep)
COPY_THREADS = 256
# the output elements of a 16-byte vector, by copy_rows' element kind
_COPY_VEC = (4, 8, 4)


class CopyPlan(NamedTuple):
    vec: bool    # 16-byte output vectors (int8: 4 bytes in, 16 out)
    per: int     # elements a thread writes at once: a vector's, or 1
    tx: int      # threads along a row, each stepping by tx * per
    ty: int      # rows a block
    grid: int    # blocks: ceil(rows / ty)


def copy_plan(rows: int, width: int, kind: int, *, aligned: bool = True,
              threads: int = COPY_THREADS) -> CopyPlan:
    """The launch of :func:`copy_rows` of ``rows`` rows of ``width``
    elements of ``kind`` (``probe_copy_launch``'s: 0 int8 -> int32, 1
    2-byte, 2 4-byte).  A thread writes one 16-byte vector of the output
    where the width holds whole vectors and ``x`` is aligned to the
    vector's input bytes (``aligned``), else one element.  A block of at
    most ``threads`` threads: ``tx`` along a row (at most the row's
    vectors), ``ty`` rows.  At the probes' shapes: int8 8 blocks of 32 x
    8, bf16 4 of 16 x 16, the f32 chunk 2 of 32 x 8.  ``threads``: a block
    size to take instead (``tools/copy_tiles.py``'s sweep)."""
    _check(kind in (0, 1, 2), f"copy_plan: no element kind {kind}")
    vec = aligned and width % _COPY_VEC[kind] == 0
    per = _COPY_VEC[kind] if vec else 1
    tx = min(max(1, width // per), threads)
    ty = max(1, threads // tx)
    return CopyPlan(vec, per, tx, ty, -(-rows // ty))


def copy_launch_plan(x: torch.Tensor, rows: int) -> CopyPlan:
    """The plan :func:`copy_rows` launches on for ``x`` on the card: 16-byte
    vectors where ``x`` is aligned to a vector's input bytes (int8: 4;
    ``out``, fresh from the caching allocator, is aligned)."""
    kind = _COPY_KIND[x.dtype]
    return copy_plan(rows, x.shape[1], kind,
                     aligned=_aligned(x, 4 if kind == 0 else 16))


def _copy_args(x, start, rows, plan, out, scale, off):
    """``probe_copy_launch``'s arguments but the stream."""
    n, width = x.shape
    return [_ptr(x), n, width, _COPY_KIND[x.dtype], _ptr(start), scale, off,
            rows, int(plan.vec), plan.tx, plan.ty, plan.grid, _ptr(out)]


def launch_copy(lib, x: torch.Tensor, start: torch.Tensor, rows: int,
                plan: CopyPlan, out: torch.Tensor, *, scale: int = 1,
                off: int = 0) -> int:
    """One launch of ``lib``'s ``probe_copy_launch`` on ``plan``, writing
    ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`copy_rows`)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lib.probe_copy_launch(
        *_copy_args(x, start, rows, plan, out, scale, off),
        ctypes.c_void_p(stream))


def copy_rows(x: torch.Tensor, start: torch.Tensor, rows: int, *,
              scale: int = 1, off: int = 0) -> torch.Tensor:
    """``out[r] = x[start[0] * scale + off + r]`` for ``r < rows`` ->
    ``[rows, W]``; a source row outside ``x`` gives 0.  ``x``: ``[N, W]``
    int8 (widened to int32, as ``tools/probe_int8.py``'s probe), bf16,
    int32 or f32; ``start``: ``[1]`` int32 on ``x``'s device, read
    there (no host sync); launched on :func:`copy_plan`'s blocks."""
    name = "probe_copy"
    _check(x.ndim == 2 and x.dtype in _COPY_KIND,
           f"{name}: x must be [N, W] of {sorted(map(str, _COPY_KIND))}")
    _check(start.dtype == torch.int32 and start.numel() == 1,
           f"{name}: start must be one int32")
    if not _operands(name, x, start):
        return copy_rows_plain(x, start, rows, scale=scale, off=off)
    width = x.shape[1]
    out = torch.empty((rows, width), device=x.device,
                      dtype=torch.int32 if x.dtype == torch.int8 else x.dtype)
    if rows and width:
        _launch("probe_copy_launch", name,
                *_copy_args(x, start, rows, copy_launch_plan(x, rows), out,
                            scale, off),
                device=x.device)
    return out


def copy_rows_plain(x: torch.Tensor, start: torch.Tensor, rows: int, *,
                    scale: int = 1, off: int = 0) -> torch.Tensor:
    """Plain version of :func:`copy_rows`: one index per row, read where
    it lies in ``x``."""
    n = x.shape[0]
    src = (start.reshape(1).long() * scale + off
           + torch.arange(rows, device=x.device))
    ok = (src >= 0) & (src < n)
    out = x[src.clamp(0, max(n - 1, 0))]
    if x.dtype == torch.int8:
        out = out.int()
    return torch.where(ok[:, None], out, torch.zeros_like(out))


# a transpose block's lanes (p along a's rows, q along its columns), each
# moving a 4 x 4 block, largest first
TRANSPOSE_TILES = ((16, 16), (16, 8), (8, 8), (8, 4), (4, 4))


class TransposePlan(NamedTuple):
    p: int        # lanes along a's rows (the fastest)
    q: int        # lanes along a's columns
    vec: bool     # 16-byte loads and stores (m and n multiples of 4, a
                  # aligned); else one element at a time, masked
    grid: int     # blocks


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def transpose_plan(m: int, n: int, sms: int, *, aligned: bool = True,
                   tile: Optional[tuple] = None) -> TransposePlan:
    """The launch of :func:`transpose` of an f32 ``[m, n]`` on a card of
    ``sms`` SMs: blocks of ``p x q`` threads, each thread moving a 4 x 4
    block of ``a`` in registers; ``(p, q)``: the largest of
    ``TRANSPOSE_TILES`` whose grid has at least ``sms // 3`` blocks, else
    the smallest, each cut to the 4-wide blocks ``a`` has along its side
    (rounded up to a power of two).  ``tile``: a lane pair to take
    instead (``tools/copy_tiles.py``'s sweep)."""
    vec = aligned and m % 4 == 0 and n % 4 == 0
    pm, qm = _pow2_at_least(-(-m // 4)), _pow2_at_least(-(-n // 4))

    def shape(t):
        p, q = min(t[0], pm), min(t[1], qm)
        return p, q, -(-m // (4 * p)), -(-n // (4 * q))

    if tile is None:
        tile = next((t for t in TRANSPOSE_TILES
                     if shape(t)[2] * shape(t)[3] >= sms // 3),
                    TRANSPOSE_TILES[-1])
    p, q, gx, gy = shape(tile)
    _check(gy <= 65535, f"transpose_plan: n = {n} needs more than 65,535 "
           "column blocks")
    return TransposePlan(p, q, vec, gx * gy)


def transpose_launch_plan(a: torch.Tensor) -> TransposePlan:
    """The plan :func:`transpose` launches on for ``a`` on the card: 16-byte
    accesses where ``a`` is 16-byte aligned (``out``, fresh from the
    caching allocator, is)."""
    m, n = a.shape
    return transpose_plan(m, n, sm_count(a.device.index),
                          aligned=_aligned(a, 16))


def _transpose_args(a, plan, out):
    m, n = a.shape
    return [_ptr(a), m, n, plan.p, plan.q, int(plan.vec), _ptr(out)]


def launch_transpose(lib, a: torch.Tensor, plan: TransposePlan,
                     out: torch.Tensor) -> int:
    """One launch of ``lib``'s ``probe_transpose_launch`` on ``plan``,
    writing ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`transpose`)."""
    stream = torch.cuda.current_stream(a.device).cuda_stream
    return lib.probe_transpose_launch(*_transpose_args(a, plan, out),
                                      ctypes.c_void_p(stream))


def transpose(a: torch.Tensor) -> torch.Tensor:
    """``a^T`` -> ``[N, M]`` of an f32 ``[M, N]`` matrix, launched on
    :func:`transpose_plan`'s blocks."""
    name = "probe_transpose"
    _check(a.ndim == 2 and a.dtype == torch.float32,
           f"{name}: a must be [M, N] float32")
    if not _operands(name, a):
        return transpose_plain(a)
    m, n = a.shape
    out = torch.empty((n, m), device=a.device, dtype=a.dtype)
    if a.numel():
        _launch("probe_transpose_launch", name,
                *_transpose_args(a, transpose_launch_plan(a), out),
                device=a.device)
    return out


def transpose_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`transpose`: ``out[j, i] = a[i, j]`` as a
    gather of the flat input."""
    m, n = a.shape
    idx = (torch.arange(n, device=a.device)[:, None]
           + n * torch.arange(m, device=a.device)[None, :])
    return a.reshape(-1)[idx]


# ---------------------------------------------------------------------------
# gather family
# ---------------------------------------------------------------------------

# a gather block's warps (output rows), largest first
GATHER_WARPS = (8, 4, 2, 1)
# output rows a row-broadcast warp writes: its lanes load the row once
BROADCAST_ROWS = 8
# dynamic shared memory a block takes without the opt-in, bytes
_SMEM_BYTES = 48 * 1024


class GatherPlan(NamedTuple):
    rb: int      # warps a block
    rw: int      # output rows a warp: 1 for the lane gather
    smem: int    # dynamic shared memory, bytes: rb staged rows (the
                 # gather), or 0 (the broadcast)
    grid: int    # blocks: ceil(rows / (rb * rw))


def gather_plan(rows: int, width: int, sms: int, *, broadcast: bool = False,
                rb: Optional[int] = None,
                rw: Optional[int] = None) -> GatherPlan:
    """The launch of :func:`lane_gather` (or, ``broadcast``, of
    :func:`row_broadcast`) of ``rows`` output rows of ``width`` 4-byte
    elements (a multiple of 4) on a card of ``sms`` SMs: a warp per output
    row (the broadcast: ``rw`` rows a warp, ``BROADCAST_ROWS`` by
    default), a lane moving 16 bytes at a time; ``rb`` warps a block, the
    largest of ``GATHER_WARPS`` whose grid has at least ``sms // 3``
    blocks and whose staged rows fit 48 KB, else the smallest.  The gather
    stages each row in its warp's slice of shared memory; the broadcast
    stages nothing.  At the probes' shapes on the H100: the [128, 128]
    gather 64 blocks of 2 warps, the 8-row broadcast one warp; in
    ``tools/join_gather_tiles.py``'s sweep there every warp and row split
    is within 0.05 us of another.  ``rb`` and ``rw``: a plan to take
    instead (the sweep's)."""
    _check(width % 4 == 0, f"gather_plan: width {width} is no multiple of 4")
    if rw is None:
        rw = BROADCAST_ROWS if broadcast else 1
    _check(rw >= 1 and (broadcast or rw == 1),
           f"gather_plan: {rw} rows a warp")
    row_bytes = 0 if broadcast else 4 * width
    _check(row_bytes <= _SMEM_BYTES, f"gather_plan: a row of {width} "
           "elements does not fit 48 KB of shared memory")
    warps = -(-rows // rw)
    if rb is None:
        fits = [w for w in GATHER_WARPS if w * row_bytes <= _SMEM_BYTES]
        rb = next((w for w in fits if -(-warps // w) >= sms // 3), fits[-1])
    _check(1 <= rb <= 32 and rb * row_bytes <= _SMEM_BYTES,
           f"gather_plan: {rb} warps a block")
    return GatherPlan(rb, rw, rb * row_bytes, -(-warps // rb))


def _check_gather(name, x):
    _check(x.ndim == 2 and x.dtype in (torch.float32, torch.int32),
           f"{name}: x must be [R, W] float32 or int32")


def _check_vectors(name, *tensors):
    """The gather kernels' operands: widths a multiple of 4, 16-byte
    aligned."""
    _check(tensors[0].shape[1] % 4 == 0
           and all(_aligned(t, 16) for t in tensors),
           f"{name} kernel takes widths that are a multiple of 4, "
           "16-byte aligned")


def _gather_args(x, idx, plan, out):
    """``probe_gather_launch``'s arguments but the stream."""
    return [_ptr(x), x.shape[1], _ptr(idx), out.shape[0], plan.rb,
            plan.smem, plan.grid, _ptr(out)]


def _broadcast_args(x, row, scale, plan, out):
    """``probe_broadcast_launch``'s arguments but the stream."""
    return [_ptr(x), x.shape[1], row, ctypes.c_float(scale), out.shape[0],
            plan.rb, plan.rw, plan.grid, _ptr(out)]


def launch_gather(lib, x: torch.Tensor, idx: torch.Tensor, plan: GatherPlan,
                  out: torch.Tensor) -> int:
    """One launch of ``lib``'s ``probe_gather_launch`` on ``plan``, writing
    ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`lane_gather`)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lib.probe_gather_launch(*_gather_args(x, idx, plan, out),
                                   ctypes.c_void_p(stream))


def launch_broadcast(lib, x: torch.Tensor, row: int, scale: float,
                     plan: GatherPlan, out: torch.Tensor) -> int:
    """One launch of ``lib``'s ``probe_broadcast_launch`` on ``plan``,
    writing ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`row_broadcast`)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lib.probe_broadcast_launch(
        *_broadcast_args(x, row, scale, plan, out), ctypes.c_void_p(stream))


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, l] = x[r, idx[r, l]]`` -> ``[R, W]``; an index outside
    ``[0, W)`` gives 0.  ``x``: ``[R, W]`` f32 or int32; ``idx``: ``[R,
    W]`` int32; launched on :func:`gather_plan`'s warps."""
    name = "lane_gather"
    _check_gather(name, x)
    _check(idx.dtype == torch.int32 and idx.shape == x.shape,
           f"{name}: idx must be int32 of x's shape")
    if not _operands(name, x, idx):
        return lane_gather_plain(x, idx)
    _check_vectors(name, x, idx)
    rows, width = x.shape
    out = torch.empty_like(x)
    if rows and width:
        plan = gather_plan(rows, width, sm_count(x.device.index))
        _launch("probe_gather_launch", f"probe_{name}",
                *_gather_args(x, idx, plan, out), device=x.device)
    return out


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lane_gather`: advanced indexing."""
    width = x.shape[1]
    ok = (idx >= 0) & (idx < width)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    out = x[rows, idx.long().clamp(0, max(width - 1, 0))]
    return torch.where(ok, out, torch.zeros_like(out))


def row_broadcast(x: torch.Tensor, row: int, scale: float,
                  rows: int) -> torch.Tensor:
    """``out[r, l] = x[row, l] * scale`` (in f32) -> ``[rows, W]``: the
    stacked rows, one extracted, broadcast of ``tools/probe_dg.py``'s
    ``ks``.  ``x``: ``[R, W]`` f32; launched on :func:`gather_plan`'s
    warps (``broadcast``)."""
    name = "row_broadcast"
    _check_gather(name, x)
    _check(x.dtype == torch.float32, f"{name} takes float32")
    _check(0 <= row < x.shape[0], f"{name}: row {row} outside x")
    if not _operands(name, x):
        return row_broadcast_plain(x, row, scale, rows)
    _check_vectors(name, x)
    width = x.shape[1]
    out = torch.empty((rows, width), device=x.device, dtype=x.dtype)
    if rows and width:
        plan = gather_plan(rows, width, sm_count(x.device.index),
                           broadcast=True)
        _launch("probe_broadcast_launch", f"probe_{name}",
                *_broadcast_args(x, row, scale, plan, out), device=x.device)
    return out


def row_broadcast_plain(x: torch.Tensor, row: int, scale: float,
                        rows: int) -> torch.Tensor:
    """Plain version of :func:`row_broadcast`."""
    return (x[row] * scale).expand(rows, x.shape[1]).contiguous()


# ---------------------------------------------------------------------------
# search family
# ---------------------------------------------------------------------------

# a join block's threads (a warp a probe), largest first
JOIN_THREADS = (256, 128, 64, 32)
# a join's searches, as csrc/probes.cu's JoinSearch numbers them: the
# warp's ballot search (a step narrows the range 32-fold), the keys counted
# in registers across the warp
JOIN_SEARCHES = ("warp", "count")
# keys a join counts in registers, at most (csrc/probes.cu's
# kJoinCountKeys): 32 a lane; more are searched in global memory
JOIN_COUNT_KEYS = 1024


class JoinPlan(NamedTuple):
    vec: bool     # 16-byte output vectors (c a multiple of 4, the table
                  # aligned to a vector's input bytes); else one element
    threads: int  # a block: threads // 32 probes, a warp each
    search: str   # one of JOIN_SEARCHES
    grid: int     # blocks: ceil(t_n / (threads // 32))


def join_plan(t_n: int, w_n: int, c: int, sms: int, *, aligned: bool = True,
              threads: Optional[int] = None,
              search: Optional[str] = None) -> JoinPlan:
    """The launch of :func:`keyed_sum` of ``t_n`` probes into ``w_n`` keys
    and a table of ``c`` columns on a card of ``sms`` SMs: a warp per
    probe, a lane writing one 16-byte output vector at a time (int8 reads
    4 bytes for it, f32 16) where ``c`` holds whole vectors and the table
    is ``aligned``, else one element; a block of the largest of
    ``JOIN_THREADS`` whose grid has at least ``sms // 3`` blocks, else the
    smallest.  The search: the keys counted in registers up to
    ``JOIN_COUNT_KEYS``, else the warp's ballot search in global memory.
    At the probes' shapes on the H100: int8 (T = 128, 256 keys) 64 blocks
    of 2 probes, f32 (T = 256, 1,024 keys) 64 blocks of 4, the keys
    counted (in ``tools/join_gather_tiles.py``'s sweep, whose readings
    ``PERF.md`` keeps, level with the ballot search or ahead of it by up to
    0.2 us).  ``threads`` and ``search``: a plan to take instead (the
    sweep's)."""
    vec = aligned and c % 4 == 0
    if threads is None:
        threads = next((n for n in JOIN_THREADS
                        if -(-t_n // (n // 32)) >= sms // 3),
                       JOIN_THREADS[-1])
    _check(threads % 32 == 0 and 32 <= threads <= 1024,
           f"join_plan: {threads} threads a block")
    if search is None:
        search = "count" if w_n <= JOIN_COUNT_KEYS else "warp"
    _check(search in JOIN_SEARCHES, f"join_plan: no search {search!r}")
    _check(search != "count" or w_n <= JOIN_COUNT_KEYS,
           f"join_plan: {w_n} keys exceed the {JOIN_COUNT_KEYS} counted")
    return JoinPlan(vec, threads, search, -(-t_n // (threads // 32)))


def join_launch_plan(probes: torch.Tensor, keys: torch.Tensor,
                     table: torch.Tensor) -> JoinPlan:
    """The plan :func:`keyed_sum` launches on for its operands on the card:
    16-byte output vectors where the table is aligned to a vector's input
    bytes (int8: 4; ``out``, fresh from the caching allocator, is
    aligned)."""
    w_n, c = table.shape
    return join_plan(probes.shape[0], w_n, c, sm_count(table.device.index),
                     aligned=_aligned(table, table.element_size() * 4))


def _join_args(probes, keys, table, plan, out):
    """``probe_join_launch``'s arguments but the stream."""
    w_n, c = table.shape
    return [_ptr(probes), probes.shape[0], _ptr(keys), w_n, _ptr(table), c,
            int(table.dtype == torch.int8), int(plan.vec), plan.threads,
            JOIN_SEARCHES.index(plan.search), plan.grid, _ptr(out)]


def launch_join(lib, probes: torch.Tensor, keys: torch.Tensor,
                table: torch.Tensor, plan: JoinPlan, out: torch.Tensor) -> int:
    """One launch of ``lib``'s ``probe_join_launch`` on ``plan``, writing
    ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`keyed_sum`)."""
    stream = torch.cuda.current_stream(table.device).cuda_stream
    return lib.probe_join_launch(*_join_args(probes, keys, table, plan, out),
                                 ctypes.c_void_p(stream))


def keyed_sum(probes: torch.Tensor, keys: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """The one-hot join ``out[t] = sum_w [probes[t] == keys[w]] *
    table[w]`` -> ``[T, C]``, summed over the matched rows in ascending
    ``w``: int32 for an int8 table (exact), f32 for an f32 one.
    ``probes``: ``[T]`` int32; ``keys``: ``[W]`` int32, ascending (the
    kernel searches them); ``table``: ``[W, C]``; launched on
    :func:`join_plan`'s blocks."""
    name = "keyed_sum"
    _check(probes.ndim == 1 and keys.ndim == 1
           and probes.dtype == keys.dtype == torch.int32,
           f"{name}: probes and keys must be 1-d int32")
    _check(table.ndim == 2 and table.shape[0] == keys.shape[0]
           and table.dtype in (torch.int8, torch.float32),
           f"{name}: table must be [W, C] int8 or float32")
    if not _operands(name, probes, keys, table):
        return keyed_sum_plain(probes, keys, table)
    t_n, c = probes.shape[0], table.shape[1]
    out = torch.empty((t_n, c), device=table.device,
                      dtype=torch.int32 if table.dtype == torch.int8
                      else torch.float32)
    if t_n and c:
        _launch("probe_join_launch", "probe_join",
                *_join_args(probes, keys, table,
                            join_launch_plan(probes, keys, table), out),
                device=table.device)
    return out


def keyed_sum_plain(probes: torch.Tensor, keys: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`keyed_sum`, from the one-hot definition (no
    search, so the keys need not be sorted): each probe's matched rows in
    ascending ``w``, added one after another."""
    w_n = keys.shape[0]
    acc_dt = torch.int32 if table.dtype == torch.int8 else torch.float32
    out = torch.zeros((probes.shape[0], table.shape[1]), dtype=acc_dt,
                      device=table.device)
    hit = probes[:, None] == keys[None, :]
    # the matched w of each probe first, in ascending order
    pos = torch.where(hit, torch.arange(w_n, device=keys.device), w_n)
    pos = torch.sort(pos, dim=1).values
    for j in range(int(hit.sum(1).max()) if hit.numel() else 0):
        w = pos[:, j]
        rows = table[w.clamp(max=w_n - 1)].to(acc_dt)
        out = out + torch.where((w < w_n)[:, None], rows,
                                torch.zeros_like(rows))
    return out


# a rank block's warps (rows), largest first
RANK_WARPS = (8, 4, 2, 1)
# a rank's searches, as csrc/probes.cu's RankSearch numbers them: the
# warp's ballot lower bound in global memory, every key read and counted
RANK_SEARCHES = ("warp", "count")
# keys a rank counts whole, at most (csrc/probes.cu's kRankCountKeys);
# more are searched
RANK_COUNT_KEYS = 1024


class RankPlan(NamedTuple):
    search: str    # one of RANK_SEARCHES
    kvec: bool     # the count's 16-byte key loads (keys 16-byte aligned)
    key_tail: int  # keys the count reads one a lane after its 16-byte
                   # loads: W % 4 with kvec, W without; 0 for "warp"
    rb: int        # warps a block, a row each
    grid: int      # blocks: ceil(rows / rb)


def rank_plan(rows: int, w_n: int, lanes: int, sms: int, *,
              aligned: bool = True, rb: Optional[int] = None,
              search: Optional[str] = None) -> RankPlan:
    """The launch of :func:`lane_rank` of ``rows`` rows of ``lanes`` into
    ``w_n`` keys on a card of ``sms`` SMs: a warp per row, ``rb`` warps a
    block, the largest of ``RANK_WARPS`` whose grid has at least ``sms //
    3`` blocks, else the smallest.  The search: every key read once and
    counted up to ``RANK_COUNT_KEYS`` (16 bytes a lane where the keys are
    ``aligned``, the last ``W % 4`` one a lane), else the warp's ballot
    lower bound.  Each row is written 16 bytes a lane whatever ``lanes``
    is (:func:`rank_row_split`).  At the probe's shape on the H100 (16
    rows, 128 keys, 128 lanes): 16 blocks of one warp, the keys counted;
    in ``tools/join_gather_tiles.py``'s sweep there 1-8 warps a block are
    within 0.01 us of each other, 16 warps 0.2 us slower, and the ballot
    search 0.15-0.2 us behind the count (``PERF.md`` keeps the readings).
    ``rb`` and ``search``: a plan to take instead (the sweep's)."""
    _check(lanes >= 1, f"rank_plan: {lanes} lanes")
    if rb is None:
        rb = next((w for w in RANK_WARPS if -(-rows // w) >= sms // 3),
                  RANK_WARPS[-1])
    _check(1 <= rb <= 32, f"rank_plan: {rb} warps a block")
    if search is None:
        search = "count" if w_n <= RANK_COUNT_KEYS else "warp"
    _check(search in RANK_SEARCHES, f"rank_plan: no search {search!r}")
    _check(search != "count" or w_n <= RANK_COUNT_KEYS,
           f"rank_plan: {w_n} keys exceed the {RANK_COUNT_KEYS} counted")
    kvec = search == "count" and aligned
    key_tail = 0 if search == "warp" else (w_n % 4 if kvec else w_n)
    return RankPlan(search, kvec, key_tail, rb, max(1, -(-rows // rb)))


def rank_row_split(row: int, lanes: int) -> Tuple[int, int, int]:
    """``(head, vectors, tail)`` of row ``row``'s stores in ``rank_kernel``
    (``out`` 16-byte aligned, rows of ``lanes`` int32): ``head`` elements
    up to the row's first 16-byte boundary, then ``vectors`` 16-byte
    stores, then ``tail`` elements, each store one a lane."""
    head = min(lanes, -(row * lanes) % 4)
    vectors = (lanes - head) // 4
    return head, vectors, lanes - head - 4 * vectors


def rank_launch_plan(keys: torch.Tensor, probes: torch.Tensor) -> RankPlan:
    """The plan :func:`lane_rank` launches on for its operands on the card
    (the keys' alignment included)."""
    rows, lanes = probes.shape
    return rank_plan(rows, keys.shape[0], lanes, sm_count(keys.device.index),
                     aligned=_aligned(keys, 16))


def _rank_args(keys, probes, plan, out):
    """``probe_rank_launch``'s arguments but the stream."""
    rows, lanes = probes.shape
    return [_ptr(keys), keys.shape[0], _ptr(probes), rows, lanes,
            RANK_SEARCHES.index(plan.search), int(plan.kvec), plan.rb,
            plan.grid, _ptr(out)]


def launch_rank(lib, keys: torch.Tensor, probes: torch.Tensor,
                plan: RankPlan, out: torch.Tensor) -> int:
    """One launch of ``lib``'s ``probe_rank_launch`` on ``plan``, writing
    ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`lane_rank`)."""
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    return lib.probe_rank_launch(*_rank_args(keys, probes, plan, out),
                                 ctypes.c_void_p(stream))


def lane_rank(keys: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """``out[r, :] = #{w : keys[w] < probes[r, 0]}`` -> ``[R, L]`` int32:
    the rank of each row's first lane, broadcast over the row (``tools/
    probe_dg.py``'s ``kr``).  ``keys``: ``[W]`` int32, ascending;
    ``probes``: ``[R, L]`` int32; launched on :func:`rank_plan`'s
    warps."""
    name = "lane_rank"
    _check(keys.ndim == 1 and probes.ndim == 2
           and keys.dtype == probes.dtype == torch.int32,
           f"{name}: keys must be [W] and probes [R, L], int32")
    if not _operands(name, keys, probes):
        return lane_rank_plain(keys, probes)
    rows, lanes = probes.shape
    out = torch.empty_like(probes)
    if rows and lanes:
        _launch("probe_rank_launch", "probe_rank",
                *_rank_args(keys, probes, rank_launch_plan(keys, probes),
                            out), device=keys.device)
    return out


def lane_rank_plain(keys: torch.Tensor, probes: torch.Tensor
                    ) -> torch.Tensor:
    """Plain version of :func:`lane_rank`: a count of the smaller keys."""
    rank = (keys[None, :] < probes[:, :1]).sum(1, keepdim=True)
    return rank.int().expand(probes.shape).contiguous()


# ---------------------------------------------------------------------------
# gemm family
# ---------------------------------------------------------------------------

# (rows, columns) of a block's output tile, largest first; s8 takes only
# those 16 columns wide or more (a 16-byte copy of a row of b)
GEMM_TILES = ((32, 32), (32, 16), (16, 16), (16, 8))
GEMM_WARPS = 8  # a block's at most, each summing a slice of K


class GemmPlan(NamedTuple):
    bm: int      # output rows a block
    bn: int      # output columns a block
    kw: int      # warps a block, warp w summing K in [w * ks, (w + 1) * ks)
    ks: int      # K a warp: a multiple of the MMA's depth
    kc: int      # K a warp stages a round, every load issued at once: 1,
                 # 2 or 4 MMA steps, the least that holds ks
    vec: bool    # 16-byte loads (k and n fill them, a and b aligned)
    smem: int    # dynamic shared memory, bytes
    grid: int    # blocks: ceil(m / bm) row tiles by ceil(n / bn) column
                 # tiles


def gemm_plan(m: int, k: int, n: int, is_int8: bool, sms: int, *,
              aligned: bool = True, tile: Optional[tuple] = None,
              kw: Optional[int] = None) -> GemmPlan:
    """The launch of :func:`gemm` on ``a [m, k] @ b [k, n]`` on a card of
    ``sms`` SMs.  The tile: the largest of ``GEMM_TILES`` whose grid has
    at least ``sms // 3`` blocks, else the smallest.  K: in steps of the
    MMA's depth (16 bf16, 32 s8) over at most ``GEMM_WARPS`` warps, spread
    evenly so that no warp is idle; a warp stages ``kc`` of its slice at
    once.  At the probes' shapes on the H100 that is 64 blocks of 16 x 16,
    7 warps of 4 steps (bf16) and 8 warps of 1 step (s8), each slice in one
    round: the fastest tile and split of each in ``tools/gemm_tiles.py``'s
    sweep, whose readings ``PERF.md`` keeps.  ``tile`` and ``kw``: a tile
    of ``GEMM_TILES`` and a warp count to take instead (the sweep's)."""
    tiles = [t for t in GEMM_TILES if t[1] >= 16 or not is_int8]
    if tile is None:
        tile = next((t for t in tiles
                     if -(-m // t[0]) * -(-n // t[1]) >= sms // 3),
                    tiles[-1])
    if tile not in tiles:
        raise ValueError(f"gemm_plan: no {'s8' if is_int8 else 'bf16'} "
                         f"tile {tile}")
    bm, bn = tile
    _check(-(-n // bn) <= 65535, f"gemm_plan: n = {n} needs more than "
           "65,535 column tiles")
    depth = 32 if is_int8 else 16
    steps = max(1, -(-k // depth))
    kw = min(kw or GEMM_WARPS, GEMM_WARPS, steps)
    per = -(-steps // kw)
    kw = -(-steps // per)
    ks = per * depth
    # the kernels' rounds: 1, 2 or 4 MMA steps (2 at most on the larger
    # tiles, whose stages would hold more); the least that holds ks
    rounds = [depth * s for s in (1, 2, 4)[:3 if bm + bn <= 32 else 2]]
    kc = next((r for r in rounds if r >= ks), rounds[-1])
    if is_int8:
        warp_smem = bm * (kc + 16) + kc * bn + bn * (kc + 16)
        vec = k % 16 == 0 and n % 16 == 0 and aligned
    else:
        ldb = bn + 16 if (bn // 8) % 2 else bn + 8
        warp_smem = 2 * (bm * (kc + 8) + kc * ldb)
        vec = k % 4 == 0 and n % 4 == 0 and aligned
    smem = kw * (warp_smem + bm * (bn + 4) * 4)
    return GemmPlan(bm, bn, kw, ks, kc, vec, smem,
                    -(-m // bm) * -(-n // bn))


def _gemm_args(a, b, plan, out):
    """``probe_gemm_launch``'s arguments but the stream."""
    (m, k), n = a.shape, b.shape[1]
    return (_ptr(a), _ptr(b), m, k, n, int(a.dtype == torch.int8), plan.bm,
            plan.bn, plan.kw, plan.ks, plan.kc, int(plan.vec), plan.smem,
            _ptr(out))


def launch_gemm(lib, a: torch.Tensor, b: torch.Tensor, plan: GemmPlan,
                out: torch.Tensor) -> int:
    """One launch of ``lib``'s ``probe_gemm_launch`` on ``plan``, writing
    ``out``; returns its CUDA error (uncounted: the wrapper is
    :func:`gemm`)."""
    stream = torch.cuda.current_stream(a.device).cuda_stream
    return lib.probe_gemm_launch(*_gemm_args(a, b, plan, out),
                                 ctypes.c_void_p(stream))


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` -> ``[M, N]`` on the tensor cores: int8 ``[M, K]`` and
    ``[K, N]`` -> int32 (exact), or f32 inputs rounded to bf16 (round to
    nearest even), their products summed in f32 -> f32; launched on
    :func:`gemm_plan`'s tile and K split."""
    _check(a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0],
           "gemm: a must be [M, K] and b [K, N]")
    _check(a.dtype == b.dtype and a.dtype in (torch.int8, torch.float32),
           "gemm takes two int8 or two float32 matrices")
    is_int8 = a.dtype == torch.int8
    name = "probe_gemm_s8" if is_int8 else "probe_gemm_bf16"
    if not _operands(name, a, b):
        return gemm_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.int32 if is_int8 else torch.float32)
    if m and n:
        plan = gemm_plan(m, k, n, is_int8, sm_count(a.device.index),
                         aligned=_aligned(a, 16) and _aligned(b, 16))
        _launch("probe_gemm_launch", name, *_gemm_args(a, b, plan, out),
                device=a.device)
    return out


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm`: int8 products summed in float64
    (exact: every partial sum stays far below 2^53, and torch has no
    integer matmul on CUDA), or the bf16-rounded inputs multiplied in
    f32."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).int()
    return a.bfloat16().float() @ b.bfloat16().float()
