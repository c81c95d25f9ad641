"""The dynamic-gather probe (``tools/probe_dg.py``) on the card: f32 and
int32 lane gathers, a rank by lane reduction, a row stacked, extracted and
broadcast, a deep bf16 GEMM (``[128, 432] @ [432, 128]``), a 128 x 128
transpose and a chunk copy at a start read on the device.

Run:  python -m spconv_tpu_torch.tools.probe_dg
"""

from typing import Dict

import numpy as np
import torch

from ..core import default_device
from ..ops import probes as P
from . import report


def main(device=None) -> Dict[str, bool]:
    dev = default_device(device)
    print(dev, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "",
          flush=True)
    results: Dict[str, bool] = {}
    rs = np.random.RandomState(0)

    def on(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    # 1. f32 lane gather at several row counts
    for c in (8, 32, 64, 128):
        x = rs.rand(c, 128).astype(np.float32)
        idx = rs.randint(0, 128, (c, 128)).astype(np.int32)
        out = P.lane_gather(*on(x, idx)).cpu().numpy()
        report(results, f"f32 lane gather C={c}",
               np.array_equal(out, np.take_along_axis(x, idx, 1)))

    # 2. int32 lane gather
    x = rs.randint(-2**30, 2**30, (16, 128)).astype(np.int32)
    idx = rs.randint(0, 128, (16, 128)).astype(np.int32)
    out = P.lane_gather(*on(x, idx)).cpu().numpy()
    report(results, "int32 lane gather",
           np.array_equal(out, np.take_along_axis(x, idx, 1)))

    # 3. rank of each row's first lane among 128 sorted keys, broadcast
    keys = np.sort(rs.randint(0, 10_000, (1, 128))).astype(np.int32)
    probes = rs.randint(0, 10_000, (16, 128)).astype(np.int32)
    out = P.lane_rank(*on(keys[0], probes)).cpu().numpy()
    want = (keys[0][None, :] < probes[:, :1]).sum(1, keepdims=True)
    report(results, "lane-reduce rank",
           np.array_equal(out, np.broadcast_to(want, out.shape)))

    # 4. rows stacked (row i times i + 1), row 3 extracted and broadcast
    x = rs.rand(8, 128).astype(np.float32)
    out = P.row_broadcast(*on(x), 3, 4.0, 8).cpu().numpy()
    report(results, "stack/extract/bcast",
           np.array_equal(out, np.broadcast_to(x[3:4] * 4, (8, 128))))

    # 5. deep GEMM [128, 432] @ [432, 128], bf16 from f32, f32 sums
    a = rs.rand(128, 432).astype(np.float32)
    b = rs.rand(432, 128).astype(np.float32)
    out = P.gemm(*on(a, b)).cpu().numpy()
    report(results, "deep GEMM 432 bf16", np.allclose(out, a @ b, rtol=2e-2))

    # 6. 128 x 128 transpose
    a = rs.rand(128, 128).astype(np.float32)
    out = P.transpose(*on(a)).cpu().numpy()
    report(results, "transpose 128x128", np.array_equal(out, a.T))

    # 7. chunk 1 of the 3 chunks at a start read on the device, of a
    # [16, 16, 128] table: rows 16 * (s + 1) ... of its [256, 128] view
    nc, c = 16, 16
    tab = rs.rand(nc, c, 128).astype(np.float32)
    out = P.copy_rows(*on(tab.reshape(nc * c, 128), np.array([5], np.int32)),
                      c, scale=c, off=c).cpu().numpy()
    report(results, "chunked-table DMA", np.array_equal(out, tab[6]))
    return results


if __name__ == "__main__":
    main()
