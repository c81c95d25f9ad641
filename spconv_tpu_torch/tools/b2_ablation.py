"""Where B2's bf16 time goes: builds ``csrc/dg_fwd.cu`` three ways and times
each at B2's shapes on the card.

- ``as is``: the kernel as it is;
- ``no MMA``: every warp returns before its ldmatrix and MMAs (the copies,
  the barriers and the row staging remain);
- ``no copy``: the 16-byte gathers of the features and the weight copies
  of a step of one offset (C > 16) are zero-fills (nothing is read from
  memory; the copies are still issued, and a packed step, C <= 16, still
  reads).

The shapes: BenchNet's stage 0 (the 125,952-row buffer of
``benchmark.basic.synthetic_scan(0)`` through its B1 table) at each tile
variant's width, the scalar gather (C = 3) and the dgrad (``W[k]^T``), and
dense tables (every offset of every row matched, as at BenchNet's late
stages) at its stage 3-6 row counts.  Every variant is timed with CUDA
events over 10 launches after a warm-up, behind a queued device sleep.
Each output is checked bit-equal to the library kernel's (the ablations'
are not checked).

Run:  python -m spconv_tpu_torch.tools.b2_ablation
"""

import ctypes
import sys

import numpy as np
import torch

from .._build import BUILD_DIR
from ..benchmark import basic as B
from ..ops import coords as C
from ..ops import dg_conv as D
from .ablation import build, cuda_ms

# (name, [(text in dg_fwd.cu, its replacement at every place)])
ABLATIONS = (
    ("as is", []),
    ("no MMA", [("    if (!warp_cols) return;", "    return;")]),
    ("no copy", [("const bool ok = p >= 0 && c0 + c < C;",
                  "const bool ok = false;"),
                 ("const bool ok = c0 + r < C && n0 + col < K;",
                  "const bool ok = false;"),
                 ("const bool ok = n0 + r < K && c0 + c < C;",
                  "const bool ok = false;")]),
)
# (label, rows, C, K, dgrad, dense table)
CASES = (
    ("stage 0", None, 3, 64, False, False),
    ("stage 0", None, 16, 16, False, False),
    ("stage 0", None, 64, 16, False, False),
    ("stage 0", None, 64, 32, False, False),
    ("stage 0", None, 64, 64, False, False),
    ("stage 0 dgrad", None, 64, 64, True, False),
    ("stage 0", None, 128, 128, False, False),
    ("stage 0", None, 256, 256, False, False),
    ("dense", 11_776, 160, 160, False, True),
    ("dense", 4_608, 192, 192, False, True),
    ("dense", 2_048, 224, 224, False, True),
    ("dense", 512, 256, 256, False, True),
)


def issued_rows(matched: np.ndarray, rows: int) -> float:
    """MMA rows a kernel multiplies per matched (row, offset) pair when a
    tile of ``rows`` rows skips an offset only if none of them matches it;
    ``matched`` [kv, N] bool, N a multiple of ``rows``."""
    kv, n = matched.shape
    live = matched.reshape(kv, n // rows, rows).any(axis=2)
    return live.sum() * rows / matched.sum()


def mask_sorted(matched: np.ndarray) -> np.ndarray:
    """``matched`` with its rows (columns) ordered by their match mask."""
    bits = (matched.T.astype(np.int64) << np.arange(matched.shape[0])).sum(1)
    return matched[:, np.argsort(bits, kind="stable")]


def main():
    dev = torch.device("cuda")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("dg_fwd.cu", ABLATIONS,
                 {"dg_fwd_bf16_launch": [vp] * 4 + [i32] * 7 + [vp]},
                 BUILD_DIR / "ablation")
    x0 = B.make_bench_input(*B.synthetic_scan(0), device=dev)
    keys, _ = C.linearize(x0.indices, x0.spatial_shape, 1)
    geom = D.SearchGeom.of((3, 3, 3), (1, 1, 1), x0.spatial_shape, 1)
    pos0 = D.build_dg_pos(keys, **geom._asdict())
    pairs0 = int((pos0 >= 0).sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    print(f"{torch.cuda.get_device_name(0)}; stage 0: {pos0.shape[1]} rows, "
          f"{pairs0} matched (row, offset) pairs")
    matched = (pos0 >= 0).cpu().numpy()
    print("MMA rows issued per matched pair at stage 0 (rows in key order / "
          "sorted by their match mask): "
          + "; ".join(f"{rows}-row tiles {issued_rows(matched, rows):.2f} / "
                      f"{issued_rows(mask_sorted(matched), rows):.2f}"
                      for rows in (16, 64)))
    print("case            rows     C    K  tile      "
          + "  ".join(f"{name:>8s}" for name, _ in ABLATIONS)
          + "  (ms)  matched TFLOP/s as is")
    for label, rows, c, k, dgrad, dense in CASES:
        if dense:
            pos = torch.randint(0, rows, (27, rows), device=dev,
                                generator=gen, dtype=torch.int32)
            x = torch.randn((rows, c), device=dev, generator=gen)
            pairs = 27 * rows
        else:
            pos, rows, pairs = pos0, pos0.shape[1], pairs0
            x = torch.randn((rows, c), device=dev, generator=gen) \
                * x0.valid_mask[:, None]
        x = x.bfloat16()
        # dgrad: W[k]^T read from [kv, K, C] (TRANS), output K channels
        w = (torch.randn((27, k, c) if dgrad else (27, c, k), device=dev,
                         generator=gen) / (27 * c) ** 0.5).bfloat16()
        v = D.b2_variant(rows, c, k, aligned=x.data_ptr() % 16 == 0)
        ref = D.dg_dgrad(x, w, pos) if dgrad else D.dg_fwd(x, w, pos)
        times = []
        for name, lib in libs.items():
            out = torch.empty((rows, k), dtype=torch.bfloat16, device=dev)

            def launch():
                err = lib.dg_fwd_bf16_launch(
                    x.data_ptr(), w.data_ptr(), pos.data_ptr(),
                    out.data_ptr(), rows, c, k, 27, v.tile, int(v.vec),
                    int(dgrad), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            times.append(cuda_ms(launch))
            if name == "as is" and not torch.equal(out, ref):
                raise RuntimeError(f"{label} C={c} K={k}: the rebuilt kernel "
                                   "differs from the library's")
        print(f"{label:14s} {rows:7d} {c:4d} {k:4d}  "
              f"{v.bm}x{v.bn}/{D.B2_TILES[v.tile][2]}"
              f"{'' if v.vec else ' scalar'}  "
              + "  ".join(f"{t:8.4f}" for t in times)
              + f"        {2 * pairs * c * k / times[0] / 1e9:.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
