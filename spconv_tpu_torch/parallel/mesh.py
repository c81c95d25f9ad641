"""Multi-rank execution (counterpart of ``spconv_tpu/parallel/mesh.py``).

The JAX package shards scans over a device mesh with ``shard_map`` and sums
gradients and BatchNorm statistics with ``psum``.  The port keeps its
contract over ``torch.distributed``: the caller starts the process group
(``torch.distributed.init_process_group``, with the backend of its
choice: ``gloo`` on the CPU or for several ranks on one card, ``nccl``
across cards), :func:`make_mesh` wraps it as a one-axis mesh and registers
it under its axis name (where ``SparseSyncBatchNorm`` finds it), and
stacked inputs carry a leading axis of the mesh size, of which rank ``r``
takes slice ``r``, as ``shard_map``'s ``P(axis)`` splits them.  Rulebooks
are per scan, so every rank builds its own and the sparse conv itself
never communicates.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..core import SparseConvTensor

__all__ = [
    "Mesh",
    "make_mesh",
    "axis_group",
    "stack_sparse_batch",
    "data_parallel_call",
    "data_parallel_value_and_grad",
    "channel_parallel_conv",
]

# axis name -> the process group make_mesh registered under it
_AXES: Dict[str, object] = {}


class Mesh:
    """A one-axis mesh: ranks ``0 .. size-1`` of the default process group
    as ``group``; ``rank`` is this process's place on it (-1 outside
    it).  ``shape`` is ``{axis: size}``, as a JAX mesh's."""

    def __init__(self, group, axis: str, size: int, rank: int):
        self.group = group
        self.axis = axis
        self.size = size
        self.rank = rank

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    def __repr__(self):
        return f"Mesh({self.axis}={self.size}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """The mesh of ranks ``0 .. n_devices-1`` (default: every rank) of the
    process group the caller started, registered under ``axis``.  Fewer
    ranks than the world take a ``new_group``, which every rank must call.
    Raises ``RuntimeError`` when ``torch.distributed`` is not initialised
    or ``n_devices`` exceeds the world; picks and switches no backend."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh wraps the caller's process group: call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise RuntimeError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(range(n))
    rank = dist.get_rank()
    _AXES[axis] = group
    return Mesh(group, axis, n, rank if rank < n else -1)


def axis_group(axis: str):
    """The process group registered under ``axis`` by :func:`make_mesh`;
    raises ``RuntimeError`` naming the axis when there is none."""
    try:
        return _AXES[axis]
    except KeyError:
        raise RuntimeError(
            f"no process group is registered under axis_name={axis!r}: "
            f"call parallel.make_mesh(axis={axis!r}) after "
            "torch.distributed.init_process_group") from None


def _member(mesh: Mesh) -> int:
    if mesh.rank < 0:
        raise RuntimeError(f"this rank is not on {mesh}")
    return mesh.rank


class _AllGather(torch.autograd.Function):
    """``x`` of every rank of ``mesh`` stacked on a new leading axis; its
    gradient is this rank's slice of the output's (the gradient of a loss
    that every rank computes alike on the gathered output)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank = mesh.rank
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None


def stack_sparse_batch(tensors: Sequence[SparseConvTensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scan tensors (one buffer size and spatial shape) stacked to
    features ``[D, N, C]`` and indices ``[D, N, ndim+1]``; each scan keeps
    its batch indices (a rank sees ``batch_size`` 1 scans)."""
    return (torch.stack([t.features for t in tensors]),
            torch.stack([t.indices for t in tensors]))


def data_parallel_call(net: nn.Module, mesh: Mesh, axis: str = "dp",
                       keys_sorted: bool = False) -> Callable:
    """``call(net, feats, inds, spatial, batch_per_shard) -> (features [D,
    N, K], indices [D, N, ndim+1])``: rank ``r`` runs ``net`` on slice ``r``
    of the stacked ``feats`` / ``inds``, and the outputs of every rank are
    all-gathered.  ``keys_sorted`` flags every slice's rows as key-sorted
    (``PointToVoxel`` output), which the dynamic-gather path needs.  The
    weights are the caller's, replicated."""
    del net, axis  # the JAX call takes its net per call as well

    def call(net_, feats, inds, spatial, batch_per_shard):
        r = _member(mesh)
        out = net_(SparseConvTensor(feats[r], inds[r], spatial,
                                    batch_per_shard, keys_sorted=keys_sorted))
        idx = [torch.empty_like(out.indices) for _ in range(mesh.size)]
        dist.all_gather(idx, out.indices.contiguous(), group=mesh.group)
        return _AllGather.apply(out.features, mesh), torch.stack(idx)

    return call


def data_parallel_value_and_grad(loss_fn: Callable, mesh: Mesh,
                                 axis: str = "dp") -> Callable:
    """``step(net, feats, inds) -> (loss, grads)``: rank ``r`` computes
    ``loss_fn(net, feats[r], inds[r])`` (a 0-d tensor) and its backward,
    then one all-reduce of its flattened f32 gradients, in
    ``named_parameters()`` order, and its loss gives the means over the
    ranks (the DDP contract): ``loss`` is the mean loss and ``grads`` is
    ``{name: mean gradient}``, each in its parameter's dtype, which every
    parameter's ``.grad`` also holds, so an optimizer can step.  A
    parameter that got no gradient counts as 0.  No
    ``DistributedDataParallel`` is inside: ``loss_fn`` may call any
    method of ``net`` (``SparseEncoder.bev``)."""
    del axis  # the mesh's own axis

    def step(net: nn.Module, feats: torch.Tensor, inds: torch.Tensor):
        r = _member(mesh)
        params = [(n, p) for n, p in net.named_parameters()
                  if p.requires_grad]
        for _, p in params:
            p.grad = None
        loss = loss_fn(net, feats[r], inds[r])
        loss.backward()
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .float().reshape(-1) for _, p in params]
            + [loss.detach().float().reshape(1)])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        grads, off = {}, 0
        for name, p in params:
            g = flat[off:off + p.numel()].view_as(p).to(p.dtype)
            p.grad = g
            grads[name] = g
            off += p.numel()
        return flat[-1].to(loss.dtype), grads

    return step


def channel_parallel_conv(conv: nn.Module, mesh: Mesh, axis: str = "tp",
                          keys_sorted: bool = False) -> Callable:
    """Column-parallel sparse conv: ``fn(weight, bias, feats, inds, spatial,
    batch) -> (features [N, K], indices)``.  Rank ``r`` runs ``conv`` on
    rows ``r*K/D .. (r+1)*K/D`` of the full KRSC ``weight`` (dim 0) and of
    ``bias`` (None for none) at ``K/D`` output channels on the replicated
    input; the column blocks of every rank are all-gathered in rank order
    (the Megatron column-parallel pattern, as the JAX function does).
    ``K`` must divide by the mesh size."""
    del axis  # the mesh's own axis
    d = mesh.size
    if conv.out_channels % d:
        raise ValueError(f"out_channels {conv.out_channels} does not divide "
                         f"by the mesh size {d}")
    kd = conv.out_channels // d

    def fn(weight, bias, feats, inds, spatial, batch):
        r = _member(mesh)
        m = copy.copy(conv)
        m._parameters = dict(conv._parameters)  # swapped below, not conv's
        m.out_channels = kd
        params = {"weight": weight[r * kd:(r + 1) * kd]}
        if bias is not None:
            params["bias"] = bias[r * kd:(r + 1) * kd]
        x = SparseConvTensor(feats, inds, spatial, batch,
                             keys_sorted=keys_sorted)
        out = torch.func.functional_call(m, params, (x,))
        cols = _AllGather.apply(out.features, mesh)  # [D, N, K/D]
        return cols.permute(1, 0, 2).reshape(cols.shape[1], -1), out.indices

    return fn
