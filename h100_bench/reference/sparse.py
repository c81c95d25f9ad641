"""Plain PyTorch sparse convolution, pooling and normalization: the
benchmark's reference.

It holds only the active sites (no padded rows), works out every active
set and every pair from the coordinates itself, by sorting int64 keys and
searching them, and computes in float32 with TF32 off (:func:`highest`),
one kernel offset at a time: gather the inputs of that offset's pairs,
multiply by its weight, ``index_add_`` into the outputs.  A conv's
gradients are written by hand the same way, offset by offset, so that a
batch of a million voxels fits; everything else is differentiated by
autograd.

Conventions (those of spconv and of the port): weights are KRSC ``[K,
*ksize, C]``; offset ``k`` runs row-major over the kernel; a subm conv
adds ``W[k] x[i]`` to site ``o`` where ``coord(i) = coord(o) + k -
ksize // 2``; a regular conv adds it where ``coord(i) = coord(o) * stride
- padding + k``, and its output sites are every site that some input
reaches, in ascending key order; the 2x/stride-2 max pool keeps a site's
children that lie in a whole window (``coord // 2 < in // 2``).

``quant`` stands in a lower precision for the benchmark's control: before
each product, both operands are scaled per tensor and rounded to float8
(e4m3 for features and weights, e5m2 for gradients), as an fp8 conv on
tensor cores would take them; the sums stay float32.

It imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

QUANTS = (None, "fp8")


@contextlib.contextmanager
def highest() -> Iterator[None]:
    """float32 matmuls without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def keys(coords: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Batch-major, row-major int64 keys of ``[n, 4]`` coordinates."""
    key = coords[:, 0].long()
    for a, s in enumerate(shape):
        key = key * int(s) + coords[:, a + 1].long()
    return key


def offsets(ksize: Sequence[int]) -> List[Tuple[int, ...]]:
    """Kernel offsets in row-major order."""
    return [tuple(int(v) for v in o) for o in np.ndindex(*ksize)]


@dataclass
class Rulebook:
    """A conv's pairs, offset by offset: ``pairs[k] = (in_rows, out_rows)``
    (int64), with the input and output site counts."""

    pairs: List[Tuple[torch.Tensor, torch.Tensor]]
    n_in: int
    n_out: int

    @property
    def kv(self) -> int:
        return len(self.pairs)

    def num_pairs(self) -> int:
        return int(sum(int(i.numel()) for i, _ in self.pairs))


def _find(sorted_keys, order, probe, ok):
    """Rows of ``probe`` keys among the table's (``-1`` where absent)."""
    pos = torch.searchsorted(sorted_keys, probe)
    at = pos.clamp(max=max(sorted_keys.numel() - 1, 0))
    hit = ok & (pos < sorted_keys.numel())
    if sorted_keys.numel():
        hit &= sorted_keys[at] == probe
    return torch.where(hit, order[at], torch.full_like(at, -1))


def subm_rulebook(coords: torch.Tensor, shape: Sequence[int],
                  ksize: Sequence[int]) -> Rulebook:
    """Submanifold rulebook of the sites ``coords`` (no duplicates)."""
    n = coords.shape[0]
    skey, order = torch.sort(keys(coords, shape))
    rows = torch.arange(n, device=coords.device)
    pairs = []
    for off in offsets(ksize):
        nb = coords.clone()
        ok = torch.ones(n, dtype=torch.bool, device=coords.device)
        for a, (o, k, s) in enumerate(zip(off, ksize, shape)):
            nb[:, a + 1] += o - k // 2
            ok &= (nb[:, a + 1] >= 0) & (nb[:, a + 1] < s)
        src = _find(skey, order, keys(nb, shape), ok)
        hit = src >= 0
        pairs.append((src[hit], rows[hit]))
    return Rulebook(pairs, n, n)


def conv_output_shape(shape, ksize, stride, padding) -> List[int]:
    return [(s + 2 * p - k) // t + 1
            for s, k, t, p in zip(shape, ksize, stride, padding)]


def conv_rulebook(coords: torch.Tensor, shape: Sequence[int],
                  ksize: Sequence[int], stride: Sequence[int],
                  padding: Sequence[int]
                  ) -> Tuple[torch.Tensor, List[int], Rulebook]:
    """Output sites (ascending keys), output grid and rulebook of a
    regular conv."""
    out_shape = conv_output_shape(shape, ksize, stride, padding)
    n = coords.shape[0]
    rows = torch.arange(n, device=coords.device)
    cands = []
    for off in offsets(ksize):
        q = coords.clone()
        ok = torch.ones(n, dtype=torch.bool, device=coords.device)
        for a in range(len(shape)):
            num = coords[:, a + 1].long() + padding[a] - off[a]
            ok &= (num % stride[a] == 0)
            qa = torch.div(num, stride[a], rounding_mode="floor")
            ok &= (qa >= 0) & (qa < out_shape[a])
            q[:, a + 1] = qa.to(q.dtype)
        cands.append((q, ok))
    all_keys = torch.cat([keys(q, out_shape)[ok] for q, ok in cands])
    out_keys = torch.unique(all_keys)  # sorted
    out = _delinearize(out_keys, out_shape)
    pairs = []
    for q, ok in cands:
        o = torch.searchsorted(out_keys, keys(q, out_shape)[ok])
        pairs.append((rows[ok], o))
    return out, out_shape, Rulebook(pairs, n, int(out_keys.numel()))


def _delinearize(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    cols = []
    rem = k
    for s in reversed([int(s) for s in shape]):
        cols.append(rem % s)
        rem = rem // s
    cols.append(rem)
    return torch.stack(cols[::-1], dim=1)


def pool2_map(coords: torch.Tensor, shape: Sequence[int]):
    """The 2x/stride-2 pool's output sites, output grid, and for each
    input its output row (``-1`` on an odd edge)."""
    out_shape = [int(s) // 2 for s in shape]
    parent = coords.clone()
    ok = torch.ones(coords.shape[0], dtype=torch.bool, device=coords.device)
    for a, s in enumerate(out_shape):
        parent[:, a + 1] = torch.div(coords[:, a + 1], 2,
                                     rounding_mode="floor")
        ok &= parent[:, a + 1] < s
    pk = keys(parent, out_shape)
    out_keys = torch.unique(pk[ok])
    row = torch.searchsorted(out_keys, pk)
    row = torch.where(ok, row, torch.full_like(row, -1))
    return _delinearize(out_keys, out_shape), out_shape, row


_FP8 = {"fwd": (torch.float8_e4m3fn, 448.0),
        "grad": (torch.float8_e5m2, 57344.0)}


def _q(t: torch.Tensor, quant: Optional[str], kind: str = "fwd"):
    """``t`` as the control's lower precision holds it (per-tensor scale,
    float8), returned in float32; ``t`` itself when ``quant`` is None."""
    if quant is None:
        return t
    if quant != "fp8":
        raise ValueError(f"quant must be one of {QUANTS}")
    dtype, top = _FP8[kind]
    scale = t.abs().max().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Conv(torch.autograd.Function):
    """``out[o] = sum_k W[:, k] x[i]`` over the rulebook's pairs, with
    the input and weight gradients written offset by offset."""

    @staticmethod
    def forward(ctx, x, w, rb, quant):
        kout = w.shape[0]
        wk = _q(w.reshape(kout, rb.kv, -1), quant)
        xq = _q(x, quant)
        out = x.new_zeros((rb.n_out, kout))
        for k, (i, o) in enumerate(rb.pairs):
            if i.numel():
                out.index_add_(0, o, xq[i] @ wk[:, k].t())
        ctx.save_for_backward(x, w)
        ctx.rb, ctx.quant = rb, quant
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        rb, quant = ctx.rb, ctx.quant
        kout = w.shape[0]
        wk = _q(w.reshape(kout, rb.kv, -1), quant)
        xq = _q(x, quant)
        dq = _q(dout.contiguous(), quant, "grad")
        dx = x.new_zeros(x.shape) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(wk) if ctx.needs_input_grad[1] else None
        for k, (i, o) in enumerate(rb.pairs):
            if not i.numel():
                continue
            g = dq[o]
            if dx is not None:
                dx.index_add_(0, i, g @ wk[:, k])
            if dw is not None:
                dw[:, k] = g.t() @ xq[i]
        return dx, (None if dw is None else dw.reshape(w.shape)), None, None


def conv(x: torch.Tensor, w: torch.Tensor, rb: Rulebook,
         bias: Optional[torch.Tensor] = None,
         quant: Optional[str] = None) -> torch.Tensor:
    """A sparse conv of the features ``x [n_in, C]`` by the KRSC weight
    ``w``, over the rulebook ``rb`` (float32)."""
    out = _Conv.apply(x, w, rb, quant)
    return out if bias is None else out + bias


def max_pool2(x: torch.Tensor, row: torch.Tensor, n_out: int
              ) -> torch.Tensor:
    """Max over each output site's children (``row`` from
    :func:`pool2_map`)."""
    ok = row >= 0
    c = x.shape[1]
    out = x.new_full((n_out, c), float("-inf"))
    return out.scatter_reduce(0, row[ok][:, None].expand(-1, c), x[ok],
                              "amax", include_self=True)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Batch norm over the sites (all active) with batch statistics: the
    biased variance, both summed in float64."""
    xd = x.double()
    mean = xd.mean(0)
    var = (xd * xd).mean(0) - mean * mean
    return ((x - mean.float()) * torch.rsqrt(var.float().clamp(min=0) + eps)
            * weight + bias)


def dense(x: torch.Tensor, coords: torch.Tensor, shape: Sequence[int],
          batch: int) -> torch.Tensor:
    """``[B, C, *shape]`` with the features at their sites, 0 elsewhere."""
    c = x.shape[1]
    flat = x.new_zeros((batch * int(np.prod(shape)), c))
    flat = flat.index_put((keys(coords, shape),), x)
    return flat.reshape(batch, *shape, c).permute(0, 4, 1, 2, 3)


@dataclass
class LayerWork:
    """One conv's work, as the benchmark counts it: channels, offsets,
    matched pairs, active input and output sites, and whether its input
    needs a gradient (a net's first conv does not)."""

    name: str
    c: int
    k: int
    kv: int
    pairs: int
    n_in: int
    n_out: int
    first: bool = False


@dataclass
class Plan:
    """Every rulebook and site set of one batch through a net, worked out
    from the coordinates alone, and the work of each conv."""

    batch: int
    stages: dict = field(default_factory=dict)
    work: List[LayerWork] = field(default_factory=list)
