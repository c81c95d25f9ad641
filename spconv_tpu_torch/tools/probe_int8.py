"""The int8 probe (``tools/probe_int8.py``) on the card: an int8 product
on the tensor cores, the one-hot int8 join and 64-row int8 copies from a
start row read on the device, widened to int32.

Run:  python -m spconv_tpu_torch.tools.probe_int8
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

    # probe_plain_matmul: int8 [128, 256] @ [256, 128] -> int32
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 127, (128, 256)).astype(np.int8)
    b = rng.randint(-127, 127, (256, 128)).astype(np.int8)
    out = P.gemm(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    ref = a.astype(np.int32) @ b.astype(np.int32)
    report(results, "int8 plain matmul",
           np.array_equal(out.cpu().numpy(), ref))

    # probe_matmul: 128 probes joined against 256 keys (each twice), times
    # an int8 [256, 128] table -> int32
    t, w, c = 128, 256, 128
    rng = np.random.RandomState(0)
    kt = (np.arange(t) * 3).astype(np.int32)
    wk = (np.arange(w) // 2 * 2).astype(np.int32)
    x = rng.randint(-127, 127, (w, c)).astype(np.int8)
    out = P.keyed_sum(*(torch.from_numpy(v).to(dev) for v in (kt, wk, x)))
    ref = (kt[:, None] == wk[None, :]).astype(np.int32) @ x.astype(np.int32)
    report(results, "int8 onehot matmul",
           np.array_equal(out.cpu().numpy(), ref))

    # probe_dma: a 64-row copy at a start row that is a multiple of 32, 8,
    # 4 and 1, widened to int32
    x = (np.arange(N * 128).reshape(N, 128) % 117 - 58).astype(np.int8)
    xd = torch.from_numpy(x).to(dev)
    for mult in (32, 8, 4, 1):
        st = mult * 3
        out = P.copy_rows(xd, torch.tensor([st], dtype=torch.int32,
                                           device=dev), ROWS)
        report(results, f"int8 dma mult={mult}",
               np.array_equal(out.cpu().numpy(),
                              x[st:st + ROWS].astype(np.int32)))
    return results


if __name__ == "__main__":
    main()
