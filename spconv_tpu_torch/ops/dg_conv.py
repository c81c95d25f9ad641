"""Dynamic-gather (DG) submanifold conv on key-sorted input (counterpart of
``spconv_tpu/ops/pallas/dg_conv.py`` in posmode), forward and backward.

Four kernel wrappers, each with its plain PyTorch version beside it:

* ``build_dg_pos`` (kernel ``csrc/dg_pos.cu``): the match table.  For each
  output row ``i`` and kernel offset ``k``, the row whose key equals
  ``key[i]`` shifted by offset ``k`` (by its negation with
  ``reverse=True``: the backward's table), or -1.  Built once per
  ``indice_key`` stage; laid out offset-major ``[kv, N]`` int32.
* ``dg_fwd`` (kernel ``csrc/dg_fwd.cu``): the gather-GEMM
  ``out[i] = sum_k x[pos[k, i]] @ W[k]`` with f32 accumulation, rounded
  once to the input dtype; rows without any match are 0.
* ``dg_dgrad`` (the same kernel, on the reversed table and ``W[k]^T``):
  ``din[j] = sum_k dout[pos_rev[k, j]] @ W[k]^T``.
* ``dg_wgrad`` (kernel ``csrc/dg_wgrad.cu``):
  ``dW[k] = sum_j x[j]^T dout[pos_rev[k, j]]``, split over rows into f32
  partials that a second kernel adds in a fixed order.

``DGSubmConvFn`` is the autograd Function over them (the VJP
``_dg_conv_p_bwd`` of the JAX package); ``dg_subm_conv`` takes it whenever
a gradient is wanted.

A wrapper takes the plain version only for tensors on the CPU.  On a CUDA
tensor it launches its kernel or raises; it never falls back.  Each launch
adds one to its entry of ``launch_counts``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import coords as C

__all__ = [
    "subm_key_deltas",
    "build_dg_pos",
    "dg_pos_plain",
    "dg_fwd",
    "dg_fwd_plain",
    "dg_dgrad",
    "dg_dgrad_plain",
    "dg_wgrad",
    "dg_wgrad_plain",
    "wgrad_splits",
    "DGSubmConvFn",
    "dg_subm_conv",
    "weight_krsc_to_kv",
    "launch_counts",
    "reset_launch_counts",
]

# launches of each kernel wrapper since the last reset_launch_counts();
# "dg_pos" counts forward tables, "dg_pos_rev" reversed ones
launch_counts = dict.fromkeys(
    ("dg_pos", "dg_pos_rev", "dg_fwd", "dg_dgrad", "dg_wgrad"), 0)

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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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
    _check(keys.ndim == 1 and keys.dtype == torch.int32,
           f"keys must be [N] int32, got {tuple(keys.shape)} {keys.dtype}")
    _check(keys.is_contiguous(), "keys must be contiguous")
    ksize = tuple(int(k) for k in ksize)
    dilation = tuple(int(d) for d in dilation)
    dims = tuple(int(s) for s in spatial_shape)
    _check(len(ksize) == len(dims) == len(dilation),
           "ksize, dilation and spatial_shape must have ndim entries")
    sentinel = C.grid_sentinel(dims, batch_size)
    if keys.device.type == "cpu":
        return dg_pos_plain(keys, ksize=ksize, dilation=dilation,
                            spatial_shape=dims, batch_size=batch_size,
                            reverse=reverse)
    if keys.device.type != "cuda":
        raise NotImplementedError(f"no dg_pos kernel for {keys.device}")
    return _dg_pos_cuda(keys, ksize, dilation, dims, sentinel, reverse)


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
    coords = []
    rem = k64
    for s in reversed(dims):
        coords.append(rem % s)
        rem = rem // s
    coords = coords[::-1]
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


def _dg_pos_cuda(keys, ksize, dilation, dims, sentinel, reverse):
    from .._build import load_library

    ndim = len(dims)
    if ndim > _MAX_NDIM:
        raise NotImplementedError(f"dg_pos kernel takes ndim <= {_MAX_NDIM}")
    kv = int(np.prod(ksize))
    n = keys.shape[0]
    _check(kv * n < 2**31, f"kv*N = {kv * n} exceeds the kernel's int32 "
                           "thread index")
    geom = (ctypes.c_int * (1 + 3 * _MAX_NDIM))(
        ndim,
        *(list(dims) + [1] * (_MAX_NDIM - ndim)),
        *(list(ksize) + [1] * (_MAX_NDIM - ndim)),
        *(list(dilation) + [1] * (_MAX_NDIM - ndim)),
    )
    pos = torch.empty((kv, n), dtype=torch.int32, device=keys.device)
    if n == 0:
        return pos
    lib = load_library()
    err = lib.dg_pos_launch(
        ctypes.c_void_p(keys.data_ptr()), n, kv, geom, sentinel,
        int(bool(reverse)), ctypes.c_void_p(pos.data_ptr()),
        _stream_ptr(keys.device))
    _raise_on(err, "dg_pos")
    launch_counts["dg_pos_rev" if reverse else "dg_pos"] += 1
    return pos


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


def _check_gather_gemm(name, x, weight_kv, pos, c_axis):
    """``x`` ``[N, *]`` whose width is ``weight_kv``'s axis ``c_axis``,
    ``weight_kv`` ``[kv, C, K]``, ``pos`` ``[kv, N]``."""
    _check(x.ndim == 2 and weight_kv.ndim == 3 and pos.ndim == 2,
           f"{name}: x must be [N, C], weight_kv [kv, C, K], pos [kv, N]")
    _check(weight_kv.shape[c_axis] == x.shape[1],
           f"{name}: weight is {tuple(weight_kv.shape)}, features have "
           f"width {x.shape[1]}")
    _check(tuple(pos.shape) == (weight_kv.shape[0], x.shape[0]),
           f"pos is {tuple(pos.shape)}, expected "
           f"{(weight_kv.shape[0], x.shape[0])}")
    _check_operands(name, x, weight_kv, pos)


def dg_fwd(x: torch.Tensor, weight_kv: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_k x[pos[k, i]] @ weight_kv[k]`` -> ``[N, K]`` in
    ``x.dtype`` (f32 accumulation, one rounding; rows without a match
    are 0).  ``x``: ``[N, C]`` f32 or bf16; ``weight_kv``: ``[kv, C, K]``
    of the same dtype; ``pos``: ``[kv, N]`` int32 from
    :func:`build_dg_pos`, whose entries lie in ``[-1, N)`` (the kernel
    trusts them: checking would cost a device sync per call).  Records no
    autograd graph on CUDA: :func:`dg_subm_conv` differentiates."""
    _check_gather_gemm("dg_fwd", x, weight_kv, pos, 1)
    if x.device.type == "cpu":
        return dg_fwd_plain(x, weight_kv, pos)
    return _gather_gemm_cuda(x, weight_kv, pos, "dg_fwd")


def dg_fwd_plain(x: torch.Tensor, weight_kv: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Plain version: per offset, gather the matched rows and accumulate
    ``x[match].float() @ W[k].float()`` in f32.  Memory stays at ``N x C``
    per offset, never ``kv x N x C``."""
    n = x.shape[0]
    out = torch.zeros((n, weight_kv.shape[2]), dtype=torch.float32,
                      device=x.device)
    for k in range(weight_kv.shape[0]):
        sel = torch.nonzero(pos[k] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = x[pos[k, sel].long()].float()
        out.index_add_(0, sel, rows @ weight_kv[k].float())
    return out.to(x.dtype)


def dg_dgrad(dout: torch.Tensor, weight_kv: torch.Tensor,
             pos_rev: torch.Tensor) -> torch.Tensor:
    """Input gradient ``din[j] = sum_k dout[pos_rev[k, j]] @ W[k]^T`` ->
    ``[N, C]`` in ``dout.dtype`` (f32 accumulation, one rounding).
    ``dout``: ``[N, K]``; ``weight_kv``: ``[kv, C, K]``; ``pos_rev``: the
    reversed table (``build_dg_pos(..., reverse=True)``).  It is B2's
    function with ``W[k]^T``, so it launches B2's kernel; rows without a
    reversed match (every invalid row) are 0."""
    _check_gather_gemm("dg_dgrad", dout, weight_kv, pos_rev, 2)
    if dout.device.type == "cpu":
        return dg_dgrad_plain(dout, weight_kv, pos_rev)
    return _gather_gemm_cuda(
        dout, weight_kv.transpose(1, 2).contiguous(), pos_rev, "dg_dgrad")


def dg_dgrad_plain(dout: torch.Tensor, weight_kv: torch.Tensor,
                   pos_rev: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dg_dgrad`: :func:`dg_fwd_plain` with
    ``W[k]^T``."""
    return dg_fwd_plain(dout, weight_kv.transpose(1, 2), pos_rev)


def _gather_gemm_cuda(x, weight_kv, pos, counter):
    """Launches B2's kernel and counts the launch under ``counter``."""
    from .._build import load_library

    n, c = x.shape
    kv, _, k_out = weight_kv.shape
    out = torch.empty((n, k_out), dtype=x.dtype, device=x.device)
    if n == 0 or k_out == 0:
        return out
    if c == 0:
        return out.zero_()
    lib = load_library()
    launch = (lib.dg_fwd_f32_launch if x.dtype == torch.float32
              else lib.dg_fwd_bf16_launch)
    err = launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(weight_kv.data_ptr()),
        ctypes.c_void_p(pos.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        n, c, k_out, kv, _stream_ptr(x.device))
    _raise_on(err, counter)
    launch_counts[counter] += 1
    return out


# ---------------------------------------------------------------------------
# B3: weight gradient
# ---------------------------------------------------------------------------

_WGRAD_TILE = 64            # the kernel's dW tile is 64 x 64
_WGRAD_TARGET_BLOCKS = 1056  # 8 blocks on each of the H100's 132 SMs
_WGRAD_MIN_ROWS = 256       # rows per split, at least: 8 chunks of 32
_WGRAD_SCRATCH = 64 << 20   # bytes of f32 partials, at most


def wgrad_splits(n: int, kv: int, c: int, k_out: int) -> int:
    """Row splits S of the wgrad kernel: enough blocks to fill the card
    (``(C/64) x (K/64) x kv x S`` near 8 per SM) even at the late, small
    stages, at least 256 rows per split, and at most 64 MB of f32 partials
    ``[S, kv, C, K]``."""
    tiles = kv * -(-c // _WGRAD_TILE) * -(-k_out // _WGRAD_TILE)
    s = -(-_WGRAD_TARGET_BLOCKS // tiles)
    s = min(s, -(-n // _WGRAD_MIN_ROWS),
            _WGRAD_SCRATCH // max(1, 4 * kv * c * k_out))
    return max(1, s)


def dg_wgrad(x: torch.Tensor, dout: torch.Tensor,
             pos_rev: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``dW[k] = sum_j x[j]^T dout[pos_rev[k, j]]`` ->
    ``[kv, C, K]`` in ``x.dtype``, summed in f32 and rounded once.  ``x``:
    ``[N, C]``; ``dout``: ``[N, K]`` of the same dtype; ``pos_rev``: the
    reversed table.  The kernel sums row splits into f32 partials and adds
    them in a fixed order, so two runs give bit-equal results."""
    _check(x.ndim == 2 and dout.ndim == 2 and pos_rev.ndim == 2,
           "dg_wgrad: x must be [N, C], dout [N, K], pos_rev [kv, N]")
    _check(dout.shape[0] == x.shape[0] == pos_rev.shape[1],
           f"dg_wgrad: x has {x.shape[0]} rows, dout {dout.shape[0]}, "
           f"pos_rev {pos_rev.shape[1]}")
    _check_operands("dg_wgrad", x, dout, pos_rev)
    if x.device.type == "cpu":
        return dg_wgrad_plain(x, dout, pos_rev)
    return _dg_wgrad_cuda(x, dout, pos_rev)


def dg_wgrad_plain(x: torch.Tensor, dout: torch.Tensor,
                   pos_rev: torch.Tensor) -> torch.Tensor:
    """Plain version: per offset, ``x[sel].float()^T @
    dout[pos_rev[k, sel]].float()`` over the rows ``sel`` that match."""
    kv = pos_rev.shape[0]
    dw = torch.zeros((kv, x.shape[1], dout.shape[1]), dtype=torch.float32,
                     device=x.device)
    for k in range(kv):
        sel = torch.nonzero(pos_rev[k] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        dw[k] = x[sel].float().t() @ dout[pos_rev[k, sel].long()].float()
    return dw.to(x.dtype)


def _dg_wgrad_cuda(x, dout, pos_rev):
    from .._build import load_library

    n, c = x.shape
    k_out = dout.shape[1]
    kv = pos_rev.shape[0]
    out = torch.empty((kv, c, k_out), dtype=x.dtype, device=x.device)
    if kv == 0 or c == 0 or k_out == 0:
        return out
    if n == 0:
        return out.zero_()
    splits = wgrad_splits(n, kv, c, k_out)
    part = torch.empty((splits, kv, c, k_out), dtype=torch.float32,
                       device=x.device)
    lib = load_library()
    launch = (lib.dg_wgrad_f32_launch if x.dtype == torch.float32
              else lib.dg_wgrad_bf16_launch)
    err = launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(dout.data_ptr()),
        ctypes.c_void_p(pos_rev.data_ptr()), ctypes.c_void_p(part.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, c, k_out, kv, splits,
        _stream_ptr(x.device))
    _raise_on(err, "dg_wgrad")
    launch_counts["dg_wgrad"] += 1
    return out


# ---------------------------------------------------------------------------
# the conv, with its backward
# ---------------------------------------------------------------------------

class DGSubmConvFn(torch.autograd.Function):
    """``dg_fwd`` with the backward of ``_dg_conv_p`` (JAX package's
    ``dg_conv.py``): ``dout`` is cast to the features' dtype, ``din``
    comes from :func:`dg_dgrad` and ``dW`` from :func:`dg_wgrad`, both
    through the reversed table.  ``din`` is skipped when the features need
    no gradient (the JAX package computes it and drops it)."""

    @staticmethod
    def forward(ctx, x, weight_kv, pos, pos_rev):
        ctx.save_for_backward(x, weight_kv, pos_rev)
        return dg_fwd(x, weight_kv, pos)

    @staticmethod
    def backward(ctx, dout):
        x, weight_kv, pos_rev = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        din = dw = None
        if ctx.needs_input_grad[0]:
            din = dg_dgrad(dout, weight_kv, pos_rev)
        if ctx.needs_input_grad[1]:
            # in x's dtype, which dg_fwd checked is the weight's
            dw = dg_wgrad(x, dout, pos_rev)
        return din, dw, None, None


def dg_subm_conv(features: torch.Tensor, weight: torch.Tensor,
                 pos: torch.Tensor,
                 pos_rev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Subm conv of key-sorted features through a cached match table.
    ``weight`` is KRSC ``[K, *ksize, C]``; returns ``[N, K]``.  When grad
    mode is on and ``features`` or ``weight`` needs a gradient, the call is
    recorded through :class:`DGSubmConvFn`, which needs the reversed table
    ``pos_rev``."""
    kv = int(np.prod(weight.shape[1:-1]))
    _check(pos.shape[0] == kv,
           f"pos has {pos.shape[0]} offsets, weight has {kv}")
    weight_kv = weight_krsc_to_kv(weight)
    if torch.is_grad_enabled() and (features.requires_grad
                                    or weight.requires_grad):
        _check(pos_rev is not None,
               "a gradient through the DG conv needs the reversed match "
               "table (build_dg_pos(..., reverse=True)) as pos_rev")
        _check(pos_rev.shape == pos.shape,
               f"pos_rev is {tuple(pos_rev.shape)}, pos {tuple(pos.shape)}")
        return DGSubmConvFn.apply(features, weight_kv, pos, pos_rev)
    return dg_fwd(features, weight_kv, pos)
