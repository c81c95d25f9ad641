"""Dynamic-gather (DG) submanifold conv on key-sorted input (counterpart of
``spconv_tpu/ops/pallas/dg_conv.py`` in posmode).

Two kernels, each with its plain PyTorch version beside it:

* ``build_dg_pos`` (kernel ``csrc/dg_pos.cu``): the match table.  For each
  output row ``i`` and kernel offset ``k``, the row whose key equals
  ``key[i]`` shifted by offset ``k``, or -1.  Built once per ``indice_key``
  stage; laid out offset-major ``[kv, N]`` int32.
* ``dg_fwd`` (kernel ``csrc/dg_fwd.cu``): the gather-GEMM
  ``out[i] = sum_k x[pos[k, i]] @ W[k]`` with f32 accumulation, rounded
  once to the input dtype; rows without any match are 0.

A wrapper takes the plain version only for tensors on the CPU.  On a CUDA
tensor it launches its kernel or raises; it never falls back.  Each launch
adds one to ``dg_pos_launches`` / ``dg_fwd_launches``.

The port has no backward yet (ROADMAP B3): both wrappers refuse inputs that
need a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import coords as C

__all__ = [
    "subm_key_deltas",
    "build_dg_pos",
    "dg_pos_plain",
    "dg_fwd",
    "dg_fwd_plain",
    "dg_subm_conv",
    "weight_krsc_to_kv",
    "reset_launch_counts",
]

# launches of each kernel since the last reset_launch_counts()
dg_pos_launches = 0
dg_fwd_launches = 0

_MAX_NDIM = 4


def reset_launch_counts() -> None:
    global dg_pos_launches, dg_fwd_launches
    dg_pos_launches = 0
    dg_fwd_launches = 0


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


def _refuse_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the DG conv has no backward in the port yet (ROADMAP B3); run "
            "under torch.no_grad() or torch.inference_mode()")


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
) -> torch.Tensor:
    """Match table ``[kv, N]`` int32 of a subm stage (-1 = no match).

    ``keys``: ``[N]`` int32 linearized keys in ascending order, invalid rows
    at the tail with the grid's sentinel key.  Rows with the sentinel get -1
    at every offset."""
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
                            spatial_shape=dims, batch_size=batch_size)
    if keys.device.type != "cuda":
        raise NotImplementedError(f"no dg_pos kernel for {keys.device}")
    return _dg_pos_cuda(keys, ksize, dilation, dims, sentinel)


def dg_pos_plain(keys: torch.Tensor, *, ksize, dilation, spatial_shape,
                 batch_size) -> torch.Tensor:
    """Plain version of the match table: ``torch.searchsorted`` of every
    shifted key, then an equality check."""
    dims = [int(s) for s in spatial_shape]
    sentinel = C.grid_sentinel(dims, batch_size)
    deltas, disp = subm_key_deltas(ksize, dilation, dims)
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


def _dg_pos_cuda(keys, ksize, dilation, dims, sentinel):
    global dg_pos_launches
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
        ctypes.c_void_p(pos.data_ptr()), _stream_ptr(keys.device))
    _raise_on(err, "dg_pos")
    dg_pos_launches += 1
    return pos


# ---------------------------------------------------------------------------
# B2: gather-GEMM forward
# ---------------------------------------------------------------------------

def weight_krsc_to_kv(weight: torch.Tensor) -> torch.Tensor:
    """KRSC ``[K, *ksize, C]`` -> ``[kv, C, K]`` contiguous."""
    k_out, c = weight.shape[0], weight.shape[-1]
    kv = int(np.prod(weight.shape[1:-1]))
    return weight.reshape(k_out, kv, c).permute(1, 2, 0).contiguous()


def dg_fwd(x: torch.Tensor, weight_kv: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_k x[pos[k, i]] @ weight_kv[k]`` -> ``[N, K]`` in
    ``x.dtype`` (f32 accumulation, one rounding; rows without a match
    are 0).  ``x``: ``[N, C]`` f32 or bf16; ``weight_kv``: ``[kv, C, K]``
    of the same dtype; ``pos``: ``[kv, N]`` int32 from
    :func:`build_dg_pos`, whose entries lie in ``[-1, N)`` (the kernel
    trusts them: checking would cost a device sync per call)."""
    _check(x.ndim == 2 and weight_kv.ndim == 3 and pos.ndim == 2,
           "x must be [N, C], weight_kv [kv, C, K], pos [kv, N]")
    n, c = x.shape
    kv, c_w, k_out = weight_kv.shape
    _check(c_w == c, f"weight has C={c_w}, features C={c}")
    _check(tuple(pos.shape) == (kv, n),
           f"pos is {tuple(pos.shape)}, expected {(kv, n)}")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"dg_fwd takes float32 or bfloat16, got {x.dtype}")
    _check(weight_kv.dtype == x.dtype,
           f"weight dtype {weight_kv.dtype} != features dtype {x.dtype}")
    _check(pos.dtype == torch.int32, "pos must be int32")
    _check(x.device == weight_kv.device == pos.device,
           "x, weight_kv and pos must be on one device")
    _check(x.is_contiguous() and weight_kv.is_contiguous()
           and pos.is_contiguous(), "dg_fwd needs contiguous tensors")
    _refuse_grad(x, weight_kv)
    if x.device.type == "cpu":
        return dg_fwd_plain(x, weight_kv, pos)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no dg_fwd kernel for {x.device}")
    return _dg_fwd_cuda(x, weight_kv, pos)


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


def _dg_fwd_cuda(x, weight_kv, pos):
    global dg_fwd_launches
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
    _raise_on(err, "dg_fwd")
    dg_fwd_launches += 1
    return out


def dg_subm_conv(features: torch.Tensor, weight: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Subm conv of key-sorted features through a cached match table.
    ``weight`` is KRSC ``[K, *ksize, C]``; returns ``[N, K]``."""
    kv = int(np.prod(weight.shape[1:-1]))
    _check(pos.shape[0] == kv,
           f"pos has {pos.shape[0]} offsets, weight has {kv}")
    return dg_fwd(features, weight_krsc_to_kv(weight), pos)
