"""The one-hot compare probe (``tools/probe_cast.py``) on the card: 256
probes joined against 1,024 sorted keys (each twice), times an f32 ``[1024,
64]`` table.  Its three Pallas forms (a 2-D compare, a 3-D broadcast, a
broadcast probe) compute one function, so each case runs the one kernel.

Run:  python -m spconv_tpu_torch.tools.probe_cast
"""

from typing import Dict

import numpy as np
import torch

from ..core import default_device
from ..ops import probes as P
from . import report

T, WR = 256, 8
W = WR * 128


def main(device=None) -> Dict[str, bool]:
    dev = default_device(device)
    results: Dict[str, bool] = {}
    kt = (np.arange(T) * 3).astype(np.int32)
    wk = (np.arange(W) // 2 * 2).astype(np.int32)
    feat = np.random.RandomState(0).randn(W, 64).astype(np.float32)
    ref = (kt[:, None] == wk[None, :]).astype(np.float32) @ feat
    args = [torch.from_numpy(v).to(dev) for v in (kt, wk, feat)]
    for name in ("2d", "2d_bcast", "3d"):
        out = P.keyed_sum(*args).cpu().numpy()
        # each output is a sum of two rows, exact in any order
        d = float(np.max(np.abs(out - ref)))
        report(results, name, np.array_equal(out, ref), f" maxdiff {d:.2e}")
    return results


if __name__ == "__main__":
    main()
