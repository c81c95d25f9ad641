"""The program side of ``spconv-benchnet``: the port's
``benchmark.basic.BenchNet`` (its output, the last stage's features),
its pool buffers from the port's ``measure_pool_bounds`` on each batch of
the cell's ring, the largest per pool."""

from __future__ import annotations

import torch


def build(cfg, *, train: bool, dtype: torch.dtype, inputs, load, device):
    """``(net, forward)``, as the CenterPoint config's ``build``."""
    from spconv_tpu_torch.benchmark.basic import (CHANNELS, BenchNet,
                                                  measure_pool_bounds)

    if tuple(cfg["channels"]) != tuple(CHANNELS):
        raise ValueError(f"the port's BenchNet has channels {CHANNELS}")
    grid = tuple(cfg["grid"])
    bounds = [max(b) for b in zip(*(measure_pool_bounds(grid, x)
                                    for x in inputs(dtype)))]
    net = BenchNet(grid, dtype=dtype, pool_bounds=bounds, device=device)
    load(net)
    net = net.train() if train else net.eval()
    return net, lambda m, x: m(x).features
