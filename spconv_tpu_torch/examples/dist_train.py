"""Data-parallel training with SyncBN (counterpart of
``examples/dist_train.py``, itself the counterpart of the reference's
``test/fake_dist_train.py``).

The JAX example's net, SubM(4, 16) -> ``SparseSyncBatchNorm`` -> ReLU ->
Conv(16, 32, s2), its scans (:func:`make_scan`, 120 random sites of a
``(12, 14, 14)`` grid from ``numpy.random.RandomState(seed)``), its loss
(the mean of the squared global average pool) and its SGD step (lr 0.05),
on ``world_size`` ranks that :func:`main` starts itself
(``parallel.run_ranks``: ``torch.multiprocessing`` with a ``file://``
rendezvous).  At step ``s`` rank ``r`` trains on scan ``s * world_size +
r``.  The net trains in training mode, so SyncBN normalizes with the
statistics of every rank's scan (the JAX example calls its net without
``training=True``, which normalizes with the running statistics).

Two paths run in each rank on the same scans from the same weights:
``parallel.data_parallel_value_and_grad`` (one all-reduce of the
gradients a step), and the ``SparseSequential`` wrapped in
``torch.nn.parallel.DistributedDataParallel``, as PyTorch users train.

Usage: python -m spconv_tpu_torch.examples.dist_train [--steps 5]
[--world-size 2] [--device cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import SparseConvTensor, default_device
from ..modules import (SparseConv3d, SparseGlobalAvgPool, SparseReLU,
                       SparseSequential, SparseSyncBatchNorm, SubMConv3d)
from ..parallel import (data_parallel_value_and_grad, make_mesh, run_ranks,
                        stack_sparse_batch)

__all__ = ["SHAPE", "LR", "make_scan", "build_net", "loss_fn", "train_rank",
           "main"]

SHAPE = (12, 14, 14)
LR = 0.05


def make_scan(seed: int, nbuf: int = 256,
              device=None) -> SparseConvTensor:
    """The JAX example's scan: 120 distinct random sites of :data:`SHAPE`
    (batch 0) with 4 standard-normal features, padded to ``nbuf`` rows,
    rows in the sampled order (not key-sorted)."""
    rng = np.random.RandomState(seed)
    flat = rng.choice(int(np.prod(SHAPE)), 120, replace=False)
    coords = np.stack(np.unravel_index(flat, SHAPE), -1)
    inds = np.full((nbuf, 4), -1, np.int32)
    inds[:120, 0] = 0
    inds[:120, 1:] = coords
    feats = np.zeros((nbuf, 4), np.float32)
    feats[:120] = rng.randn(120, 4)
    device = default_device(device)
    return SparseConvTensor(torch.from_numpy(feats).to(device),
                            torch.from_numpy(inds).to(device), SHAPE, 1)


def build_net(device=None, seed: int = 0) -> SparseSequential:
    """SubMConv3d(4, 16) -> SparseSyncBatchNorm(16, "dp") -> ReLU ->
    SparseConv3d(16, 32, 3, s2, p1), weights drawn from ``seed``, in
    training mode."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    return SparseSequential(
        SubMConv3d(4, 16, 3, indice_key="c1", device=device, generator=gen),
        SparseSyncBatchNorm(16, axis_name="dp", device=device),
        SparseReLU(),
        SparseConv3d(16, 32, 3, stride=2, padding=1, device=device,
                     generator=gen),
    ).train()


def loss_fn(net, feats: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """The mean of the squared global average pool of ``net``'s output."""
    out = net(SparseConvTensor(feats, inds, SHAPE, 1))
    return (SparseGlobalAvgPool()(out) ** 2).mean()


def _sgd(net: torch.nn.Module) -> None:
    with torch.no_grad():
        for p in net.parameters():
            p.add_(p.grad, alpha=-LR)


def train_rank(rank: int, world_size: int, steps: int, device: str,
               seed: int = 0) -> Dict[str, object]:
    """One rank of :func:`main` (``parallel.run_ranks``' function): both
    paths ``steps`` steps on ``device`` (``"cuda"``: card ``rank`` modulo
    the count).  Returns the mean losses of each path, the first path's
    mean loss on the first step's scans after the last step
    (``"loss_after"``), the first step's mean gradients and the final
    weights, on the CPU."""
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
        torch.set_num_threads(1)
    mesh = make_mesh(world_size, axis="dp")

    def scans(s):
        return [make_scan(s * world_size + d, device=dev)
                for d in range(world_size)]

    net = build_net(dev, seed)
    step = data_parallel_value_and_grad(loss_fn, mesh)
    losses, grads0 = [], None
    for s in range(steps):
        loss, grads = step(net, *stack_sparse_batch(scans(s)))
        if grads0 is None:
            grads0 = {k: g.detach().cpu() for k, g in grads.items()}
        _sgd(net)
        losses.append(float(loss))
    # the first step's scans again, after the last step: training lowers
    # their loss (each step trains on new scans, so the step losses need
    # not fall)
    loss_after = float(step(net, *stack_sparse_batch(scans(0)))[0])

    ddp_net = build_net(dev, seed)
    ddp = torch.nn.parallel.DistributedDataParallel(ddp_net)
    ddp_losses, ddp_grads0 = [], None
    for s in range(steps):
        x = scans(s)[rank]
        ddp_net.zero_grad(set_to_none=True)
        loss = loss_fn(ddp, x.features, x.indices)
        loss.backward()
        if ddp_grads0 is None:
            ddp_grads0 = {k: p.grad.detach().cpu()
                          for k, p in ddp_net.named_parameters()}
        _sgd(ddp_net)
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        ddp_losses.append(float(mean) / world_size)
    return {"losses": losses, "loss_after": loss_after,
            "ddp_losses": ddp_losses, "grads0": grads0,
            "ddp_grads0": ddp_grads0,
            "state": {k: v.cpu() for k, v in net.state_dict().items()},
            "ddp_state": {k: v.cpu() for k, v in ddp_net.state_dict().items()}}


def main(steps: int = 5, world_size: int = 2, device: Optional[str] = None,
         backend: Optional[str] = None,
         workdir: Optional[str] = None) -> Dict[str, object]:
    """Trains :func:`build_net` ``steps`` steps on ``world_size`` ranks
    (``device`` None: the CUDA card, shared when there are fewer cards
    than ranks; ``backend`` None: ``"gloo"``, which serves the CPU and
    several ranks on one card; ``workdir``: where the rendezvous file
    goes, by default a new temporary directory) and returns rank 0's
    result (:func:`train_rank`), printing each step's mean loss."""
    device = default_device(device).type
    res = run_ranks(train_rank, world_size, (steps, device),
                    backend=backend or "gloo", workdir=workdir)
    for s, (a, b) in enumerate(zip(res[0]["losses"], res[0]["ddp_losses"])):
        print(f"step {s}: loss {a:.6f} (DistributedDataParallel {b:.6f})")
    print(f"step 0's scans after step {steps - 1}: loss "
          f"{res[0]['loss_after']:.6f}")
    return res[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    main(a.steps, a.world_size, a.device, a.backend)
