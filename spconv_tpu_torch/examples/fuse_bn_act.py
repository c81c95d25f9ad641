"""BN + activation fusion for inference (counterpart of
``examples/fuse_bn_act.py``): conv -> BN -> ReLU folded into one conv with
a ReLU epilogue, checked against the unfused net.

Usage: python -m spconv_tpu_torch.examples.fuse_bn_act
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import SparseConvTensor, default_device
from ..modules import BatchNorm1d, SparseReLU, SparseSequential, SubMConv3d
from ..quantization import fuse_bn_act_in_sequential

__all__ = ["make_net", "make_input", "main"]

SHAPE = (9, 10, 11)


def make_net(rng: np.random.RandomState, device=None,
             seed: int = 0) -> SparseSequential:
    """SubMConv3d(4, 16) -> BatchNorm1d(16) -> ReLU -> SubMConv3d(16, 16),
    in eval mode, the BN's running statistics drawn from ``rng`` as if
    trained (as the JAX example draws them)."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    net = SparseSequential(
        SubMConv3d(4, 16, 3, bias=False, indice_key="c1", device=device,
                   generator=gen),
        BatchNorm1d(16, device=device),
        SparseReLU(),
        SubMConv3d(16, 16, 3, bias=True, indice_key="c1", device=device,
                   generator=gen),
    ).eval()
    bn = net[1]
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(
            rng.randn(16).astype(np.float32)) * 0.1)
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2, 16).astype(np.float32)))
    return net


def make_input(rng: np.random.RandomState, n: int = 150, nbuf: int = 256,
               device=None) -> SparseConvTensor:
    """``n`` distinct random sites of ``SHAPE`` (in draw order, not
    key-sorted) in a buffer of ``nbuf`` rows, 4 random features each."""
    device = default_device(device)
    flat = rng.choice(int(np.prod(SHAPE)), n, replace=False)
    coords = np.stack(np.unravel_index(flat, SHAPE), -1)
    inds = np.full((nbuf, 4), -1, np.int32)
    inds[:n, 0] = 0
    inds[:n, 1:] = coords
    feats = np.zeros((nbuf, 4), np.float32)
    feats[:n] = rng.randn(n, 4)
    return SparseConvTensor(torch.from_numpy(feats).to(device),
                            torch.from_numpy(inds).to(device), SHAPE, 1)


def main(device=None, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Folds the net's BN and ReLU into its first conv and runs both nets
    on one input; prints the layer counts and their largest difference and
    returns ``(unfused output, fused output)``."""
    device = default_device(device)
    rng = np.random.RandomState(seed)
    net = make_net(rng, device, seed)
    fused = fuse_bn_act_in_sequential(net).eval()
    print(f"layers: {len(net)} -> {len(fused)} (conv act_type="
          f"{fused[0].act_type})")
    x = make_input(rng, device=device)
    with torch.no_grad():
        ref, out = net(x).features, fused(x).features
    print(f"max abs diff fused vs unfused: "
          f"{float((ref - out).abs().max()):.2e}")
    return ref, out


if __name__ == "__main__":
    main()
