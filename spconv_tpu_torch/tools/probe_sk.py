"""The sorted-key subm conv prototypes (``tools/probe_sk_v2.py``,
``probe_sk_v3.py``) on the card: a subm conv at kernel 3^3, C = K = 64,
bf16, with keys searched inside the kernel, on the benchmark's synthetic
scan (``benchmark.basic.synthetic_scan(0)``, standing in for the real scan
the prototypes read).  The port's kernel for that function is S1, the
search mode of B2 (``ops.dg_conv.dg_fwd_search``); it is held against its
plain version and timed.

Run:  python -m spconv_tpu_torch.tools.probe_sk
"""

import time
from typing import Dict, Sequence

import numpy as np
import torch

from ..benchmark import basic as B
from ..core import default_device
from ..ops import coords as C
from ..ops import dg_conv as D
from . import report

CH = 64
TOL = 1.6e-2  # bf16, of max|ref|: one output rounding plus sum order


def sk_case(dev: torch.device, shape: Sequence[int], n_target: int):
    """The probe's operands on ``dev``: the bf16 features ``[N, 64]`` (0 on
    the invalid rows) and weight ``[27, 64, 64]`` (``[kv, C, K]``) from seed
    0, the keys of seed 0's synthetic scan, and its grid."""
    voxels, coors, shape = B.synthetic_scan(0, shape, n_target)
    x = B.make_bench_input(voxels, coors, shape, dtype=torch.bfloat16,
                           device=dev)
    keys, _ = C.linearize(x.indices, x.spatial_shape, 1)
    rng = np.random.RandomState(0)
    n = x.indices.shape[0]
    valid = (x.indices[:, 0] >= 0).cpu().numpy()[:, None]
    feats = torch.from_numpy((rng.randn(n, CH) * valid).astype(np.float32))
    w = torch.from_numpy((rng.randn(27, CH, CH) / np.sqrt(27 * CH))
                         .astype(np.float32))
    return (feats.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16), keys,
            tuple(shape))


def main(device=None, shape: Sequence[int] = B.BASIC_SHAPE,
         n_target: int = B.BASIC_VOXELS) -> Dict[str, bool]:
    dev = default_device(device)
    results: Dict[str, bool] = {}
    feats, w, keys, shape = sk_case(dev, shape, n_target)
    geom = D.SearchGeom.of((3, 3, 3), (1, 1, 1), shape, 1)
    n = feats.shape[0]

    def run():
        return D.dg_fwd_search(feats, w, keys, geom)

    out = run()
    ref = D.dg_fwd_search_plain(feats, w, keys, geom).float()
    err = (out.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            run()
        end.record()
        end.synchronize()
        timing = f"{start.elapsed_time(end) / 10:.4f} ms on the card"
    else:
        t0 = time.perf_counter()
        run()
        timing = f"{(time.perf_counter() - t0) * 1e3:.1f} ms host (CPU)"
    report(results, f"sk subm conv C=K={CH} N={n}",
           scale > 0 and err <= TOL * scale,
           f" max|d|/max|ref| {err / max(scale, 1e-30):.3e}, {timing}")
    return results


if __name__ == "__main__":
    main()
