"""Plain reference of spconv's benchmark net (``spconv/benchmark/basic.py::
Net``): 14 subm convs k3 without bias or activation, paired by stage,
the channels of the config file's ``channels``, with a 2x/stride-2 max
pool before every stage but the first.  Its output is the last stage's
features ``[n, C]`` (in ascending key order).  Parameter names are the
port's state-dict names (``convs.<i>.weight``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from h100_bench.reference import sparse as S

K3 = (3, 3, 3)


def param_specs(cfg, bn: bool) -> List[Tuple[str, Tuple[int, ...], str,
                                             int]]:
    """``(name, shape, kind, fan_in)`` of every weight (no BN, no bias)."""
    ch = cfg["channels"]
    return [(f"convs.{i}.weight", (ch[i + 1], *K3, ch[i]), "weight",
             ch[i] * 27) for i in range(len(ch) - 1)]


def plan(cfg, coords: torch.Tensor, batch: int) -> S.Plan:
    """The rulebooks and pool maps of one batch (``coords [n, 4]``)."""
    p = S.Plan(batch)
    shape = list(cfg["grid"])
    ch = cfg["channels"]
    for stage in range((len(ch) - 1) // 2):
        if stage:
            coords, shape, row = S.pool2_map(coords, shape)
            p.stages[f"pool{stage}"] = (row, coords.shape[0])
        rb = S.subm_rulebook(coords, shape, K3)
        p.stages[f"c{stage}"] = rb
        for i in (2 * stage, 2 * stage + 1):
            p.work.append(S.LayerWork(f"convs.{i}", ch[i], ch[i + 1], 27,
                                      rb.num_pairs(), rb.n_in, rb.n_out,
                                      first=(i == 0)))
    return p


def forward(cfg, p: S.Plan, params: Dict[str, torch.Tensor],
            feats: torch.Tensor, bn: bool,
            quant: Optional[str] = None) -> torch.Tensor:
    """The last stage's features (float32)."""
    x = feats
    for stage in range((len(cfg["channels"]) - 1) // 2):
        if stage:
            x = S.max_pool2(x, *p.stages[f"pool{stage}"])
        rb = p.stages[f"c{stage}"]
        for i in (2 * stage, 2 * stage + 1):
            x = S.conv(x, params[f"convs.{i}.weight"], rb, quant=quant)
    return x
