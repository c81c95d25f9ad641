"""The sweep behind the probe GEMMs' plan (``ops/probes.py::gemm_plan``)
and where their time goes, on the card.

1. Each tile of ``GEMM_TILES`` at every split of K over 1-8 warps
   (printed warps x K a warp / K a round), timed at the probes' shapes
   (bf16 ``[128, 432] @ [432, 128]``, s8 ``[128, 256] @ [256, 128]``)
   beside the plan's choice (``*``); each
   output is checked against the plain version (s8 exact, bf16 within
   1e-5 of max|ref|).
2. ``csrc/probes.cu`` rebuilt with parts taken out (``tools/ablation.py``)
   and timed on the plan's launch: as is, with no MMA, with no adding of
   the warps' partials, and returning at once (the launch alone).

CUDA events over 100 launches after a warm-up, inputs warm in L2.

Run:  python -m spconv_tpu_torch.tools.gemm_tiles
"""

import ctypes
import sys

import torch

from .._build import BUILD_DIR, load_library
from ..ops import dg_conv as D
from ..ops import probes as P
from .ablation import build, cuda_ms

SHAPES = {"bf16": (128, 432, 128), "s8": (128, 256, 128)}

ABLATIONS = (
    ("as is", ()),
    ("no MMA", (
        ("mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);", ""),
        ("mma_s8(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],\n"
         "                 bfr[ni / 2][(ni % 2) * 2 + 1]);", ""))),
    ("no partial adds", (("for (int w = 1; w < kGemmMaxWarps; ++w) {",
                          "for (int w = 1; w < 1; ++w) {"),)),
    ("launch only", (("extern __shared__ __align__(16) unsigned char "
                      "smem[];",
                      "extern __shared__ __align__(16) unsigned char "
                      "smem[];\n  if (m >= 0) return;"),)),
)


def operands(kind, dev):
    m, k, n = SHAPES[kind]
    g = torch.Generator(device=dev).manual_seed(0)
    if kind == "s8":
        return (torch.randint(-128, 128, (m, k), device=dev,
                              generator=g).to(torch.int8),
                torch.randint(-128, 128, (k, n), device=dev,
                              generator=g).to(torch.int8))
    return (torch.rand((m, k), device=dev, generator=g),
            torch.rand((k, n), device=dev, generator=g))


def agrees(out, ref):
    if ref.dtype == torch.int32:
        return torch.equal(out, ref)
    tol = 1e-5 * ref.abs().max().item()
    return (out - ref).abs().max().item() <= tol


def main():
    dev = torch.device("cuda")
    sms = D.sm_count(dev.index or 0)
    lib = load_library()
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; probe GEMMs, ms a "
          "launch (* the plan's)")
    for kind, (m, k, n) in SHAPES.items():
        a, b = operands(kind, dev)
        is_int8 = kind == "s8"
        ref = P.gemm_plain(a, b)
        rule = P.gemm_plan(m, k, n, is_int8, sms)
        print(f"{kind} [{m}, {k}] @ [{k}, {n}]: plan {rule}")
        for tile in P.GEMM_TILES:
            if is_int8 and tile[1] < 16:
                continue
            cells = []
            plans = {P.gemm_plan(m, k, n, is_int8, sms, tile=tile, kw=kw)
                     for kw in range(1, P.GEMM_WARPS + 1)}
            for plan in sorted(plans, key=lambda p: p.kw):
                out = torch.empty_like(ref)
                ms = cuda_ms(lambda: P.launch_gemm(lib, a, b, plan, out), 100)
                if not agrees(out, ref):
                    raise RuntimeError(f"{kind} {tile} kw {kw}: output "
                                       "differs from plain")
                star = "*" if plan == rule else ""
                cells.append(f"{plan.kw}x{plan.ks}/{plan.kc} "
                             f"{ms:.4f}{star}")
            print(f"  {tile[0]:2d} x {tile[1]:2d}, {plan.grid:3d} blocks: "
                  + "  ".join(cells), flush=True)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("probes.cu", ABLATIONS,
                 {"probe_gemm_launch": [vp, vp, *[i32] * 11, vp, vp]},
                 BUILD_DIR / "gemm_ablation")
    print("ablations of csrc/probes.cu on the plan's launch, ms a launch")
    for kind, (m, k, n) in SHAPES.items():
        a, b = operands(kind, dev)
        plan = P.gemm_plan(m, k, n, kind == "s8", sms)
        out = torch.empty_like(P.gemm_plain(a, b))
        cells = []
        for name, dll in libs.items():
            if P.launch_gemm(dll, a, b, plan, out):
                raise RuntimeError(f"{kind} {name}: launch failed")
            ms = cuda_ms(lambda: P.launch_gemm(dll, a, b, plan, out), 100)
            cells.append(f"{name}: {ms:.4f}")
        print(f"  {kind}: " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
