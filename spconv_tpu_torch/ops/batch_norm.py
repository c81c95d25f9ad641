"""BatchNorm1d's training path: the masked batch statistics, the
normalisation and its closed-form backward, as four ops with CUDA kernels
(``csrc/bn.cu``) and plain PyTorch versions beside them.

* ``bn_stats`` (:func:`bn_stats_plain`): over the active rows of ``x [N,
  C]`` (``indices[:, 0] >= 0``; every row where ``indices`` is None), the
  packed f64 ``[cnt, sum x, sum x^2]`` of ``2C + 1`` values, the vector
  that SyncBN all-reduces, and a ``uint8 [N]`` row mask (``[0]`` for all
  rows) that the other three ops read;
* ``bn_norm`` (:func:`bn_norm_plain`): ``y = (x - mean) * rstd * weight +
  bias`` from the packed statistics, 0 on inactive rows, with ``mean`` and
  ``rstd`` for the backward;
* ``bn_bwd_reduce`` (:func:`bn_bwd_reduce_plain`): the f64 ``[sum dy, sum
  dy * xhat]`` over the active rows, and the same in f32 (``dbias``,
  ``dweight``);
* ``bn_bwd_dx`` (:func:`bn_bwd_dx_plain`): ``dx = weight * rstd * (dy -
  sum dy / n - xhat * sum dy xhat / n)``, 0 on inactive rows.

:class:`BatchNormFn` strings them together with the two collectives of
SyncBN (the statistics before ``bn_norm``, the backward's sums before
``bn_bwd_dx``); ``modules.BatchNorm1d`` calls :func:`batch_norm_train` in
training mode and :func:`batch_stats` in ``updated``.  Eval mode stays
plain torch in the module: no exported net runs it (serving folds BN into
the convs), so the C++ op library has no schema for these ops.

The wrappers take the plain version only for CPU tensors; a CUDA tensor
launches its kernel or raises, and each launch adds one to its entry of
:data:`launch_counts`.  The kernels take f32, bf16 or fp16 features and
int32 indices and raise on any other; the plain versions also take f64
(``gradcheck`` runs them so) and other integer indices.  The plain versions compute in
``promote_types(x.dtype, float32)``, as the kernels do in f32 (in f64 for
f64 input, which only the CPU takes), with the sums in f64: the
one-pass variance cancels where a channel is near constant, and f32 sums
would leave order-dependent noise there that the gradient amplifies.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..tracing import span
from .dg_conv import _ptr, _raise_on, _stream_ptr, sm_count
from .library import define_op

__all__ = ["bn_stats_plain", "bn_norm_plain", "bn_bwd_reduce_plain",
           "bn_bwd_dx_plain", "moments", "BNPlan", "bn_plan",
           "BN_THREADS", "BN_BLOCKS_PER_SM", "BatchNormFn",
           "batch_norm_train", "batch_stats", "launch_counts",
           "reset_launch_counts"]

# launches of each BN kernel since the last reset_launch_counts()
launch_counts = dict.fromkeys(
    ("bn_stats", "bn_norm", "bn_bwd_reduce", "bn_bwd_dx"), 0)

BN_THREADS = 256       # a block's threads at most (csrc/bn.cu kThreads)
BN_BLOCKS_PER_SM = 2   # the grid along the rows, in blocks an SM

# the kernels' element types, as the entry points take them
_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_F64 = torch.float64


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _ct(x: torch.Tensor) -> torch.dtype:
    """The dtype the arithmetic runs in: f32, or f64 for f64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def _active(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """``[N, 1]`` bool of the active rows, None for all rows."""
    return None if mask.numel() == 0 else mask.bool()[:, None]


def moments(stats: torch.Tensor, c: int, dtype: torch.dtype
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, biased var, count)`` in ``dtype`` from the packed f64
    statistics: count at least 1, var at least 0, each quotient in f64."""
    cnt = stats[0].clamp(min=1.0)
    mean = stats[1:c + 1] / cnt
    var = (stats[c + 1:] / cnt - mean * mean).clamp(min=0.0)
    return mean.to(dtype), var.to(dtype), cnt.to(dtype)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def bn_stats_plain(x: torch.Tensor, indices: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(stats, mask)``: f64 ``[cnt, sum x, sum x^2]`` over the active
    rows (the squares in the compute dtype, the sums in f64), and the
    ``uint8 [N]`` mask (``[0]`` where ``indices`` is None)."""
    n = x.shape[0]
    if indices is None:
        act = torch.ones(n, dtype=torch.bool, device=x.device)
        mask = torch.zeros(0, dtype=torch.uint8, device=x.device)
    else:
        act = indices[:, 0] >= 0
        mask = act.to(torch.uint8)
    m = act[:, None].to(_ct(x))
    xf = x.to(_ct(x)) * m
    cnt = m.sum(dtype=_F64)
    return (torch.cat([cnt[None], xf.sum(0, dtype=_F64),
                       (xf * xf).sum(0, dtype=_F64)]), mask)


def bn_norm_plain(x: torch.Tensor, mask: torch.Tensor, stats: torch.Tensor,
                  weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                  eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)``: ``y = (x - mean) * rstd (* weight + bias)`` in
    the compute dtype, cast to ``x.dtype``, 0 on inactive rows."""
    mean, var, _ = moments(stats, x.shape[1], _ct(x))
    rstd = torch.rsqrt(var + eps)
    out = (x.to(_ct(x)) - mean) * rstd
    if weight is not None:
        out = out * weight + bias
    out = out.to(x.dtype)
    act = _active(mask)
    if act is not None:
        out = torch.where(act, out, torch.zeros_like(out))
    return out, mean, rstd


def bn_bwd_reduce_plain(dy: torch.Tensor, x: torch.Tensor,
                        mask: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums, sums in mean's dtype)``: f64 ``[sum dy, sum dy * xhat]``
    over the active rows, ``xhat = (x - mean) * rstd``."""
    g = dy.to(mean.dtype)
    act = _active(mask)
    if act is not None:
        g = torch.where(act, g, torch.zeros_like(g))
    xh = (x.to(mean.dtype) - mean) * rstd
    sums = torch.cat([g.sum(0, dtype=_F64),
                      (g.to(_F64) * xh.to(_F64)).sum(0)])
    return sums, sums.to(mean.dtype)


def bn_bwd_dx_plain(dy: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor,
                    weight: Optional[torch.Tensor], sums: torch.Tensor,
                    stats: torch.Tensor) -> torch.Tensor:
    """``dx = (weight * rstd) * ((dy - a) - xhat * b)`` with ``a = sum dy /
    n``, ``b = sum dy xhat / n`` (``n`` the count of ``stats``, at least
    1), cast to ``x.dtype``, 0 on inactive rows."""
    c, ct = x.shape[1], mean.dtype
    cnt = stats[0].clamp(min=1.0)
    a, b = (sums[:c] / cnt).to(ct), (sums[c:] / cnt).to(ct)
    k = rstd if weight is None else weight.to(ct) * rstd
    xh = (x.to(ct) - mean) * rstd
    dx = (k * ((dy.to(ct) - a) - xh * b)).to(x.dtype)
    act = _active(mask)
    if act is not None:
        dx = torch.where(act, dx, torch.zeros_like(dx))
    return dx


# ---------------------------------------------------------------------------
# the CUDA launches
# ---------------------------------------------------------------------------

class BNPlan(NamedTuple):
    vec: int      # elements a thread loads at once: 16 bytes, or narrower
    tpr: int      # threads along a row in a block
    rows: int     # rows a block takes a step
    threads: int  # rows * tpr
    grid: int     # blocks along the rows
    groups: int   # blocks along the channels (rows wider than 256 vectors)


def _alignment(*tensors) -> int:
    """The largest power of two, at most 16, dividing every pointer."""
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


def bn_plan(n: int, c: int, itemsize: int, align: int, *, sms: int
            ) -> BNPlan:
    """The launch of a BN kernel over ``[n, c]`` elements of ``itemsize``
    bytes whose pointers are ``align``-byte aligned, on a card of ``sms``
    SMs: the widest vector of 16, 8, 4 or 2 bytes that divides a row and
    the alignment (else one element), a block of whole rows up to
    ``BN_THREADS`` threads, and ``BN_BLOCKS_PER_SM`` blocks an SM (fewer
    where the rows run out, at least one)."""
    vec = next(e for e in (16 // itemsize, 8 // itemsize, 4 // itemsize,
                           2 // itemsize, 1)
               if e >= 1 and c % e == 0 and align % (e * itemsize) == 0)
    vecs = c // vec
    tpr = min(vecs, BN_THREADS)
    rows = BN_THREADS // tpr
    grid = max(1, min(-(-n // rows), BN_BLOCKS_PER_SM * sms))
    return BNPlan(vec, tpr, rows, rows * tpr, grid, -(-vecs // tpr))


def _plan(x: torch.Tensor, *tensors) -> Tuple:
    """The entry points' ``(n, c, dtype, vec, threads, grid, groups)`` for
    ``x`` and the other ``[N, C]`` operands."""
    if x.dtype not in _DTYPE:
        raise TypeError(f"BN kernels take f32, bf16 or fp16, not {x.dtype}")
    n, c = x.shape
    if c == 0:
        raise ValueError("BN kernels need at least one channel")
    p = bn_plan(n, c, x.element_size(), _alignment(x, *tensors),
                sms=sm_count(x.device.index))
    return (ctypes.c_longlong(n), c, _DTYPE[x.dtype], p.vec, p.threads,
            p.grid, p.groups), p.grid


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def _launch(name: str, entry: str, *args, device: torch.device) -> None:
    from .._build import load_library

    _raise_on(getattr(load_library(), entry)(*args, _stream_ptr(device)),
              name)
    launch_counts[name] += 1


def _bn_stats_cuda(x, indices):
    n, c = x.shape
    stats = torch.empty(2 * c + 1, dtype=_F64, device=x.device)
    mask = torch.empty(n if indices is not None else 0, dtype=torch.uint8,
                       device=x.device)
    if indices is not None and indices.dtype != torch.int32:
        raise TypeError(f"bn_stats needs int32 indices, not {indices.dtype}")
    args, grid = _plan(x)
    part = torch.empty((grid, 2 * c + 1), dtype=_F64, device=x.device)
    _launch("bn_stats", "bn_stats_launch", _ptr(x), _ptr(indices),
            0 if indices is None else indices.stride(0), _ptr(mask), *args,
            _ptr(part), _ptr(stats), device=x.device)
    return stats, mask


def _bn_norm_cuda(x, mask, stats, weight, bias, eps):
    c = x.shape[1]
    y = torch.empty_like(x)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    w, b = _f32(weight), _f32(bias)
    args, _ = _plan(x, y)
    _launch("bn_norm", "bn_norm_launch", _ptr(x), _ptr(mask if mask.numel()
                                                       else None),
            _ptr(stats), _ptr(w), _ptr(b), ctypes.c_float(eps), *args,
            _ptr(y), _ptr(mean), _ptr(rstd), device=x.device)
    return y, mean, rstd


def _bn_bwd_reduce_cuda(dy, x, mask, mean, rstd):
    c = x.shape[1]
    sums = torch.empty(2 * c, dtype=_F64, device=x.device)
    sums32 = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    args, grid = _plan(x, dy)
    part = torch.empty((grid, 2 * c), dtype=_F64, device=x.device)
    _launch("bn_bwd_reduce", "bn_bwd_reduce_launch", _ptr(dy), _ptr(x),
            _ptr(mask if mask.numel() else None), _ptr(mean), _ptr(rstd),
            *args, _ptr(part), _ptr(sums), _ptr(sums32), device=x.device)
    return sums, sums32


def _bn_bwd_dx_cuda(dy, x, mask, mean, rstd, weight, sums, stats):
    dx = torch.empty_like(x)
    args, _ = _plan(x, dy, dx)
    _launch("bn_bwd_dx", "bn_bwd_dx_launch", _ptr(dy), _ptr(x),
            _ptr(mask if mask.numel() else None), _ptr(mean), _ptr(rstd),
            _ptr(_f32(weight)), _ptr(sums), _ptr(stats), *args, _ptr(dx),
            device=x.device)
    return dx


def _cuda(fn):
    """``fn`` on contiguous operands of one CUDA device."""
    def run(*args):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        if any(t.device != ts[0].device for t in ts):
            raise ValueError("BN kernels: operands must be on one device")
        return fn(*(a.contiguous() if isinstance(a, torch.Tensor) else a
                    for a in args))
    return run


def _fake_stats(x, indices):
    n, c = x.shape
    return (x.new_empty(2 * c + 1, dtype=_F64),
            x.new_empty(n if indices is not None else 0, dtype=torch.uint8))


def _fake_norm(x, mask, stats, weight, bias, eps):
    c = x.shape[1]
    return (torch.empty_like(x), x.new_empty(c, dtype=_ct(x)),
            x.new_empty(c, dtype=_ct(x)))


def _fake_bwd_reduce(dy, x, mask, mean, rstd):
    c = x.shape[1]
    return x.new_empty(2 * c, dtype=_F64), x.new_empty(2 * c,
                                                       dtype=mean.dtype)


def _fake_bwd_dx(dy, x, *args):
    return torch.empty_like(x)


_BN_STATS = define_op(
    "bn_stats", "(Tensor x, Tensor? indices) -> (Tensor, Tensor)",
    cuda=_cuda(_bn_stats_cuda), cpu=bn_stats_plain, fake=_fake_stats)
_BN_NORM = define_op(
    "bn_norm", "(Tensor x, Tensor mask, Tensor stats, Tensor? weight, "
    "Tensor? bias, float eps) -> (Tensor, Tensor, Tensor)",
    cuda=_cuda(_bn_norm_cuda), cpu=bn_norm_plain, fake=_fake_norm)
_BN_BWD_REDUCE = define_op(
    "bn_bwd_reduce", "(Tensor dy, Tensor x, Tensor mask, Tensor mean, "
    "Tensor rstd) -> (Tensor, Tensor)",
    cuda=_cuda(_bn_bwd_reduce_cuda), cpu=bn_bwd_reduce_plain,
    fake=_fake_bwd_reduce)
_BN_BWD_DX = define_op(
    "bn_bwd_dx", "(Tensor dy, Tensor x, Tensor mask, Tensor mean, "
    "Tensor rstd, Tensor? weight, Tensor sums, Tensor stats) -> Tensor",
    cuda=_cuda(_bn_bwd_dx_cuda), cpu=bn_bwd_dx_plain, fake=_fake_bwd_dx)


# ---------------------------------------------------------------------------
# the autograd Function and the module's entry points
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, group=group)


class BatchNormFn(torch.autograd.Function):
    """Training BN over the active rows of ``x [N, C]`` (those of
    ``indices``, or all): ``bn_stats``, the statistics all-reduced over
    ``group`` (SyncBN; None for none), ``bn_norm``.  It saves ``x``, the
    mask, ``mean``, ``rstd`` and the statistics.  The backward, in the
    ``spconv.bn`` span: ``bn_bwd_reduce``, the sums all-reduced over
    ``group``, ``bn_bwd_dx``; ``dweight`` and ``dbias`` are this rank's
    sums (the parent's autograd gave them so: a data-parallel step sums
    the parameters' gradients itself)."""

    @staticmethod
    def forward(ctx, x, indices, weight, bias, eps, group):
        stats, mask = _BN_STATS(x, indices)
        _all_reduce(stats, group)
        y, mean, rstd = _BN_NORM(x, mask, stats, weight, bias, eps)
        ctx.save_for_backward(x, mask, mean, rstd, stats, weight)
        ctx.group = group
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, mask, mean, rstd, stats, weight = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[0], weight is not None and (
            ctx.needs_input_grad[2] or ctx.needs_input_grad[3])
        dx = dw = db = None
        if not (need_x or need_w):
            return None, None, None, None, None, None
        with span("spconv.bn"):
            sums, sums32 = _BN_BWD_REDUCE(dy, x, mask, mean, rstd)
            if weight is not None:
                c = x.shape[1]
                db, dw = sums32[:c], sums32[c:]
                dw, db = dw.to(weight.dtype), db.to(weight.dtype)
            if need_x:
                _all_reduce(sums, ctx.group)
                dx = _BN_BWD_DX(dy, x, mask, mean, rstd, weight, sums, stats)
        return dx, None, dw, db, None, None


def batch_norm_train(x: torch.Tensor, indices: Optional[torch.Tensor],
                     weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float,
                     group=None) -> torch.Tensor:
    """Training BN of ``x [N, C]`` over the rows of ``indices`` with
    ``indices[:, 0] >= 0`` (every row for None), statistics summed over
    ``group`` where given; differentiable (:class:`BatchNormFn`)."""
    return BatchNormFn.apply(x, indices, weight, bias, float(eps), group)


def batch_stats(x: torch.Tensor, indices: Optional[torch.Tensor],
                group=None) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """f32 ``(mean, biased var, count)`` of ``x``'s active rows
    (``bn_stats``, summed over ``group`` where given); not
    differentiable."""
    with torch.no_grad():
        stats, _ = _BN_STATS(x, indices)
        _all_reduce(stats, group)
        return moments(stats, x.shape[1], torch.float32)
