"""The program side of ``centerpoint-voxelres-nus01``: OpenPCDet's
VoxelResBackBone8x as the config file lists its layers, assembled from
the port's public modules (``SubMConv3d``, ``SparseConv3d``,
``BatchNorm1d``) with OpenPCDet's kernels, strides, paddings, biases,
``indice_key`` names and BN eps, then densified to the BEV ``[B, C * D,
H, W]`` as OpenPCDet's HeightCompression does.

Serving builds the net without BN (each BN folded into its conv, so
every conv has a bias) in float32, loads the benchmark's weights,
calibrates the regular convs' output buffers on the cell's ring
(``calibrate.calibrate_out_bounds``, the config's margin and multiple)
and casts it to the served dtype, as the port's
``build_calibrated_encoder`` does.  Training builds it with BN in the
served dtype (BN in float32), loads the weights, calibrates the same way
and sets it to training mode.

Parameter names are the reference's (``reference/<config>.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _net_class():
    from spconv_tpu_torch.modules import (BatchNorm1d, SparseConv3d,
                                          SubMConv3d)

    class Block(nn.Module):
        """OpenPCDet's SparseBasicBlock: its convs keep their bias beside
        BN (``USE_BIAS`` unset)."""

        def __init__(self, c, key, bn, eps, kw):
            super().__init__()
            self.conv1 = SubMConv3d(c, c, 3, bias=True,
                                    indice_key=key, **kw)
            self.conv2 = SubMConv3d(c, c, 3, bias=True,
                                    indice_key=key, **kw)
            self.bn1 = BatchNorm1d(c, eps=eps, device=kw["device"]) \
                if bn else None
            self.bn2 = BatchNorm1d(c, eps=eps, device=kw["device"]) \
                if bn else None

        def forward(self, x):
            out = self.conv1(x)
            if self.bn1 is not None:
                out = self.bn1(out)
            out = out.replace_feature(F.relu(out.features))
            out = self.conv2(out)
            if self.bn2 is not None:
                out = self.bn2(out)
            return out.replace_feature(F.relu(out.features + x.features))

    class ConvBnReLU(nn.Module):
        """A conv, its BN (none when folded) and a ReLU."""

        def __init__(self, conv, c, bn, eps, device):
            super().__init__()
            self.conv = conv
            self.bn = BatchNorm1d(c, eps=eps, device=device) if bn else None

        def forward(self, x):
            x = self.conv(x)
            if self.bn is not None:
                x = self.bn(x)
            return x.replace_feature(F.relu(x.features))

    class VoxelResBackBone8x(nn.Module):
        def __init__(self, cfg, bn, dtype, device):
            super().__init__()
            eps, ch = float(cfg["bn_eps"]), list(cfg["channels"])
            kw = dict(dtype=dtype, device=device)
            self.conv_input = ConvBnReLU(
                SubMConv3d(cfg["in_channels"], ch[0], 3,
                           bias=not bn, indice_key="subm1", **kw),
                ch[0], bn, eps, device)
            self.downs = nn.ModuleList(
                ConvBnReLU(SparseConv3d(
                    ch[s - 1], ch[s], 3, stride=2,
                    padding=tuple(cfg["down_padding"][s - 1]), bias=not bn,
                    indice_key=f"spconv{s + 1}", out_bound_ratio=1.5, **kw),
                    ch[s], bn, eps, device)
                for s in range(1, len(ch)))
            self.stages = nn.ModuleList(
                nn.ModuleList(Block(c, f"res{s + 1}", bn, eps, kw)
                              for _ in range(cfg["blocks_per_stage"]))
                for s, c in enumerate(ch))
            self.conv_out = ConvBnReLU(SparseConv3d(
                ch[-1], cfg["out_channels"], (3, 1, 1), stride=(2, 1, 1),
                padding=0, bias=not bn, indice_key="spconv_down2",
                out_bound_ratio=1.0, **kw), cfg["out_channels"], bn, eps,
                device)

        def forward(self, x):
            x = self.conv_input(x)
            for s, blocks in enumerate(self.stages):
                if s > 0:
                    x = self.downs[s - 1](x)
                for block in blocks:
                    x = block(x)
            return self.conv_out(x)

        def bev(self, x):
            dense = self(x).dense()  # [B, C, D, H, W]
            b, c, d, h, w = dense.shape
            return dense.reshape(b, c * d, h, w)

    return VoxelResBackBone8x


def build(cfg, *, train: bool, dtype: torch.dtype, inputs, load, device):
    """``(net, forward)``: ``inputs(dtype)`` gives the ring's tensors,
    ``load(net)`` copies the benchmark's weights into ``net``."""
    from spconv_tpu_torch.calibrate import calibrate_out_bounds

    bn = cfg["train" if train else "serve"]["bn"]
    net = _net_class()(cfg, bn, dtype if train else torch.float32, device)
    load(net)
    cal = cfg["calibration"]
    net = calibrate_out_bounds(net, lambda m, t: m.bev(t),
                               inputs(dtype if train else torch.float32),
                               margin=cal["margin"], mult=cal["mult"])
    net = net.train() if train else net.to(dtype).eval()
    return net, lambda m, x: m.bev(x)
