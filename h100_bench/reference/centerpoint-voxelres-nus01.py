"""Plain reference of OpenPCDet's VoxelResBackBone8x, the CenterPoint
nuScenes sparse encoder, as its config file lists the layers, to the
dense BEV ``[B, C * D, H, W]`` (HeightCompression).

``conv_input``: subm k3, BN, ReLU.  Stage ``s``: for ``s > 0`` a regular
conv k3 s2 with the config's ``down_padding``, BN, ReLU; then
``blocks_per_stage`` residual blocks ``relu(bn2(conv2(relu(bn1(conv1
x)))) + x)`` whose convs have a bias beside BN, every subm conv of the
stage on one rulebook.  ``conv_out``: regular conv k(3, 1, 1) s(2, 1, 1)
p0, BN, ReLU, densified.  Served, each BN is folded into its conv: no BN,
and every conv has a bias.  Parameter names are the program builder's
(``configs/<config>.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference import sparse as S

K3 = (3, 3, 3)


def _convs(cfg) -> List[Tuple[str, int, int, Tuple[int, ...], str, bool]]:
    """``(conv, C, K, ksize, its BN, bias beside BN)`` of every conv, in
    order."""
    ch = list(cfg["channels"])
    out = [("conv_input.conv", cfg["in_channels"], ch[0], K3,
            "conv_input.bn", False)]
    for s, c in enumerate(ch):
        if s > 0:
            out.append((f"downs.{s - 1}.conv", ch[s - 1], c, K3,
                        f"downs.{s - 1}.bn", False))
        for b in range(cfg["blocks_per_stage"]):
            for j in (1, 2):
                out.append((f"stages.{s}.{b}.conv{j}", c, c, K3,
                            f"stages.{s}.{b}.bn{j}", True))
    out.append(("conv_out.conv", ch[-1], cfg["out_channels"], (3, 1, 1),
                "conv_out.bn", False))
    return out


def param_specs(cfg, bn: bool) -> List[Tuple[str, Tuple[int, ...], str,
                                             int]]:
    """``(name, shape, kind, fan_in)``: kind ``weight`` or ``bias`` (a
    conv's, drawn by ``harness/weights.py``), ``ones`` or ``zeros``
    (BN)."""
    specs = []
    for name, c, k, ks, bn_name, bias_beside in _convs(cfg):
        fan_in = c * int(torch.tensor(ks).prod())
        specs.append((f"{name}.weight", (k, *ks, c), "weight", fan_in))
        if not bn or bias_beside:
            specs.append((f"{name}.bias", (k,), "bias", fan_in))
        if bn:
            specs.append((f"{bn_name}.weight", (k,), "ones", 0))
            specs.append((f"{bn_name}.bias", (k,), "zeros", 0))
    return specs


def plan(cfg, coords: torch.Tensor, batch: int) -> S.Plan:
    """The rulebooks of one batch (``coords [n, 4]``, the active sites)."""
    p = S.Plan(batch)
    shape = list(cfg["grid"])
    ch = list(cfg["channels"])
    work = p.work
    for s, c in enumerate(ch):
        if s > 0:
            out, out_shape, rb = S.conv_rulebook(
                coords, shape, K3, (2, 2, 2), cfg["down_padding"][s - 1])
            p.stages[f"down{s}"] = rb
            work.append(S.LayerWork(f"downs.{s - 1}", ch[s - 1], c, 27,
                                    rb.num_pairs(), rb.n_in, rb.n_out))
            coords, shape = out, out_shape
        rb = S.subm_rulebook(coords, shape, K3)
        p.stages[f"subm{s}"] = rb
        if s == 0:
            work.append(S.LayerWork("conv_input", cfg["in_channels"], c, 27,
                                    rb.num_pairs(), rb.n_in, rb.n_out,
                                    first=True))
        for b in range(cfg["blocks_per_stage"]):
            for j in (1, 2):
                work.append(S.LayerWork(f"stages.{s}.{b}.conv{j}", c, c, 27,
                                        rb.num_pairs(), rb.n_in, rb.n_out))
    out, out_shape, rb = S.conv_rulebook(coords, shape, (3, 1, 1),
                                         (2, 1, 1), (0, 0, 0))
    p.stages["out"] = rb
    p.stages["out_sites"] = (out, out_shape)
    work.append(S.LayerWork("conv_out", ch[-1], cfg["out_channels"], 3,
                            rb.num_pairs(), rb.n_in, rb.n_out))
    return p


def forward(cfg, p: S.Plan, params: Dict[str, torch.Tensor],
            feats: torch.Tensor, bn: bool,
            quant: Optional[str] = None) -> torch.Tensor:
    """The BEV ``[B, out_channels * D, H, W]`` (float32)."""
    eps = float(cfg["bn_eps"])

    def conv(name, x, rb):
        return S.conv(x, params[f"{name}.weight"], rb,
                      params.get(f"{name}.bias"), quant)

    def norm(name, x):
        if not bn:
            return x
        return S.batch_norm(x, params[f"{name}.weight"],
                            params[f"{name}.bias"], eps)

    x = F.relu(norm("conv_input.bn", conv("conv_input.conv", feats,
                                          p.stages["subm0"])))
    for s in range(len(cfg["channels"])):
        if s > 0:
            x = F.relu(norm(f"downs.{s - 1}.bn",
                            conv(f"downs.{s - 1}.conv", x,
                                 p.stages[f"down{s}"])))
        rb = p.stages[f"subm{s}"]
        for b in range(cfg["blocks_per_stage"]):
            pre = f"stages.{s}.{b}"
            y = F.relu(norm(f"{pre}.bn1", conv(f"{pre}.conv1", x, rb)))
            y = norm(f"{pre}.bn2", conv(f"{pre}.conv2", y, rb))
            x = F.relu(y + x)
    x = F.relu(norm("conv_out.bn", conv("conv_out.conv", x,
                                        p.stages["out"])))
    sites, shape = p.stages["out_sites"]
    d = S.dense(x, sites, shape, p.batch)
    b, c, dz, h, w = d.shape
    return d.reshape(b, c * dz, h, w)
