"""Sparse MNIST classifier (counterpart of ``examples/mnist_sparse.py``,
the reference's minimal end-to-end training example: SubMConv2d ->
SparseConv2d on thresholded images), on synthetic MNIST-like data (no
dataset download); swap :func:`make_batch` for a real loader for actual
MNIST.

Usage: python -m spconv_tpu_torch.examples.mnist_sparse [--steps 20]
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import SparseConvTensor, default_device
from ..models import SparseClassifier

__all__ = ["GRID", "LR", "make_batch", "ce", "sgd_step", "main"]

GRID = (28, 28)
LR = 0.1


def make_batch(rng: np.random.RandomState, batch: int = 8, nbuf: int = 256,
               device=None) -> Tuple[SparseConvTensor, torch.Tensor]:
    """Synthetic 28 x 28 'digit' images -> a key-sorted sparse tensor of
    ``nbuf * batch`` rows (flagged ``keys_sorted``) and the int64 labels
    (digit id = label).  Draws from ``rng`` exactly as the JAX example's
    ``make_batch`` does, so one seed gives both packages the same
    batches.  ``device`` None is the CUDA card."""
    device = default_device(device)
    feats_list, inds_list, labels = [], [], []
    for b in range(batch):
        label = rng.randint(10)
        # blob pattern whose position encodes the label
        cy, cx = 4 + (label // 5) * 14, 2 + (label % 5) * 5
        ys, xs = np.mgrid[0:28, 0:28]
        mask = ((ys - cy) ** 2 + (xs - cx) ** 2) < 16
        ys, xs = np.nonzero(mask)
        n = len(ys)
        inds = np.stack([np.full(n, b), ys, xs], 1).astype(np.int32)
        feats = rng.uniform(0.5, 1.0, (n, 1)).astype(np.float32)
        feats_list.append(feats)
        inds_list.append(inds)
        labels.append(label)
    feats = np.concatenate(feats_list)
    inds = np.concatenate(inds_list)
    n = feats.shape[0]
    # np.nonzero yields row-major order, batches follow in order: the rows
    # must come out in strictly ascending key order
    keys = (inds[:, 0].astype(np.int64) * GRID[0] + inds[:, 1]) * GRID[1] \
        + inds[:, 2]
    if not (np.diff(keys) > 0).all():
        raise RuntimeError("make_batch rows are not in ascending key order")
    fp = np.zeros((nbuf * batch, 1), np.float32)
    ip = np.full((nbuf * batch, 3), -1, np.int32)
    fp[:n], ip[:n] = feats, inds
    x = SparseConvTensor(torch.from_numpy(fp).to(device),
                         torch.from_numpy(ip).to(device), GRID, batch,
                         keys_sorted=True)
    return x, torch.tensor(labels, dtype=torch.int64, device=device)


def ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, ``mean(-log_softmax(logits)[i, y_i])``."""
    rows = torch.arange(y.shape[0], device=y.device)
    return -F.log_softmax(logits, -1)[rows, y].mean()


def sgd_step(net: torch.nn.Module, x: SparseConvTensor, y: torch.Tensor,
             lr: float = LR) -> torch.Tensor:
    """One SGD step of ``ce(net(x), y)``: clears the grads, backward,
    ``p -= lr * grad`` in place.  The step's grads stay on the parameters.
    Returns the loss (0-d, on the net's device)."""
    for p in net.parameters():
        p.grad = None
    loss = ce(net(x), y)
    loss.backward()
    with torch.no_grad():
        for p in net.parameters():
            if p.grad is not None:
                p.sub_(lr * p.grad)
    return loss.detach()


def main(device=None, steps: int = 20, seed: int = 0) -> List[float]:
    """``SparseClassifier(ndim=2, 1, 10)`` trained ``steps`` SGD steps on
    :func:`make_batch` batches from ``RandomState(seed)``; prints the loss
    and the batch's accuracy every 5 steps and returns every step's
    loss."""
    device = default_device(device)
    rng = np.random.RandomState(seed)
    net = SparseClassifier(ndim=2, in_channels=1, num_classes=10,
                           device=device, seed=seed)
    losses = []
    for step in range(steps):
        x, y = make_batch(rng, device=device)
        losses.append(sgd_step(net, x, y))
        if step % 5 == 0 or step == steps - 1:
            with torch.no_grad():
                acc = float((net(x).argmax(-1) == y).float().mean())
            print(f"step {step}: loss {float(losses[-1]):.4f} acc "
                  f"{acc:.2f}")
    return [float(v) for v in losses]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    main(steps=ap.parse_args().steps)
