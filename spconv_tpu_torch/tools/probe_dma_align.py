"""The DMA-alignment probe (``tools/probe_dma_align.py``) on the card:
64-row copies of bf16, int32 and f32 ``[4096, 128]`` tables from start rows
that are multiples of 128, 32, 16, 8 and 1, read on the device.

Run:  python -m spconv_tpu_torch.tools.probe_dma_align
"""

from typing import Dict

import numpy as np
import torch

from ..core import default_device
from ..ops import probes as P
from . import report

N, ROWS = 4096, 64


def main(device=None) -> Dict[str, bool]:
    dev = default_device(device)
    results: Dict[str, bool] = {}
    base = torch.from_numpy(np.arange(N * 128).reshape(N, 128) % 977)
    for dt, name in ((torch.bfloat16, "bf16"), (torch.int32, "int32"),
                     (torch.float32, "f32")):
        x = base.to(dt).to(dev)
        for mult in (128, 32, 16, 8, 1):
            start = mult * 3
            out = P.copy_rows(x, torch.tensor([start], dtype=torch.int32,
                                              device=dev), ROWS)
            report(results, f"{name} mult={mult}",
                   torch.equal(out.cpu(), x[start:start + ROWS].cpu()))
    return results


if __name__ == "__main__":
    main()
