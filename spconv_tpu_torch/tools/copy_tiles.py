"""The sweep behind the probe copy's and transpose's plans
(``ops/probes.py::copy_plan``, ``transpose_plan``) and where their time
goes, on the card.

1. The row copy at the probes' three shapes (64 int8 rows of ``[4096,
   128]`` at a device start of 96, widened to int32; 64 bf16 rows of
   ``[4096, 128]`` at 384; 16 f32 rows of ``[256, 128]`` at ``5 * 16 +
   16``) on blocks of 16-1,024 threads (256: the plan's, and the grid of
   the kernel this one replaced), and the transpose of an f32 ``[128, 128]`` on every
   lane pair of ``TRANSPOSE_TILES`` and two smaller ones, each beside the
   plan's choice (``*``) and the PyTorch call that computes the same
   function (for the copies with the start on the host); each output is
   checked bit-equal to plain.
2. ``csrc/probes.cu`` rebuilt with parts taken out (``tools/ablation.py``)
   and timed on the plans' launches: as is, launch only (every block
   returns at once), no stores (each thread's loaded bits feed a branch
   that never stores), and for the copy the start passed as the value of
   its pointer argument instead of read on the device ("host start": a
   copy with the start known on the host, as the PyTorch call's slice),
   that with no row loaded ("stores only"), and the start read by a plain
   load instead of ``__ldg`` ("plain start load").

Each time: the median of seven readings of CUDA events over 100 launches
after a warm-up, inputs warm in L2, the candidates of a row read in turn
in each of the seven rounds.

Run:  python -m spconv_tpu_torch.tools.copy_tiles
"""

import ctypes
import sys

import torch

from .._build import BUILD_DIR, load_library
from ..ops import dg_conv as D
from ..ops import probes as P
from .ablation import build, interleaved_ms as _ms

_COPY_FIRST = ("const long long s = static_cast<long long>(__ldg(start)) * "
               "scale + off;")
_COPY_LOAD = ("const Vec<Tin, V> in = *reinterpret_cast<const Vec<Tin, V>*>"
              "(xr + c);")
_COPY_STORE = "*reinterpret_cast<Vec<Tout, V>*>(o + c) = v;"
_HOST_START = ("__ldg(start)",
               "static_cast<int>(reinterpret_cast<intptr_t>(start))")
_REGS_FIRST = ("const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);"
               "  // rows of a")
_REGS_STORE = "*reinterpret_cast<float4*>(o) = t;"
# a store kept only where the loaded bits equal a value no input holds
# (inputs here are small integers or floats in [0, 1)): ptxas drops an
# empty asm and then the loads, so the loads must feed a branch
_NEVER = "(0xDEADBEEFu ^ static_cast<unsigned>({}))"

ABLATIONS = (
    ("as is", ()),
    ("launch only", ((_COPY_FIRST, "if (rows >= 0) return;\n  "
                      + _COPY_FIRST),
                     (_REGS_FIRST, "if (m >= 0) return;\n  "
                      + _REGS_FIRST))),
    ("no stores", (
        (_COPY_STORE,
         "unsigned h = 0;\n    for (int j = 0; j < V; ++j) h ^= "
         "static_cast<unsigned>(v.v[j]);\n    if (h == "
         + _NEVER.format("rows") + ") " + _COPY_STORE),
        (_REGS_STORE,
         "if ((__float_as_uint(t.x) ^ __float_as_uint(t.y) ^ "
         "__float_as_uint(t.z) ^ __float_as_uint(t.w)) == "
         + _NEVER.format("m") + ") " + _REGS_STORE))),
    ("host start", (_HOST_START,)),
    # the stores alone: start from the host, no row loaded (the output is
    # wrong by design): what a copy with the addresses known on the host
    # costs beyond its loads
    ("stores only", (_HOST_START,
                     (_COPY_LOAD, "Vec<Tin, V> in;\n      for (int j = 0; "
                      "j < V; ++j) in.v[j] = static_cast<Tin>(s);"))),
    ("plain start load", (("__ldg(start)", "start[0]"),)),
)
# the ablations that leave the copy's output right
_EXACT = ("as is", "host start", "plain start load")
# the ablations that change the copy only
_COPY_ONLY = ("host start", "stores only", "plain start load")


def copy_cases(dev):
    """``{row: (x, start, rows, scale, off, torch call)}`` at the probes'
    shapes, as ``chip_smoke.py`` phase 12 times them."""
    i32 = torch.int32
    ar = torch.arange(4096 * 128, device=dev).reshape(4096, 128)
    x8 = (ar % 117 - 58).to(torch.int8)
    xb = (ar % 977).to(torch.bfloat16)
    tab = torch.rand((256, 128), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    return {
        "probe_copy_int8": (x8, torch.tensor([96], dtype=i32, device=dev),
                            64, 1, 0, lambda: x8[96:160].to(i32)),
        "probe_copy_dma_align": (
            xb, torch.tensor([384], dtype=i32, device=dev), 64, 1, 0,
            lambda: xb[384:448].to(torch.bfloat16, copy=True)),
        "probe_copy_chunk": (tab, torch.tensor([5], dtype=i32, device=dev),
                             16, 16, 16,
                             lambda: tab[96:112].to(torch.float32,
                                                    copy=True)),
    }


def main():
    dev = torch.device("cuda")
    sms = D.sm_count(dev.index or 0)
    lib = load_library()
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; probe copy and "
          "transpose, ms a launch (* the plan's)")
    cases = copy_cases(dev)
    plans = {}
    for row, (x, start, rows, scale, off, call) in cases.items():
        ref = P.copy_rows_plain(x, start, rows, scale=scale, off=off)
        kind = P._COPY_KIND[x.dtype]
        rule = plans[row] = P.copy_plan(rows, x.shape[1], kind)
        sweep = [P.copy_plan(rows, x.shape[1], kind, threads=t)
                 for t in (16, 32, 64, 128, 256, 512, 1024)]
        fns = [call]
        for plan in sweep:
            out = torch.empty_like(ref)
            if P.launch_copy(lib, x, start, rows, plan, out, scale=scale,
                             off=off):
                raise RuntimeError(f"{row} {plan}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"{row} {plan}: output differs from "
                                   "plain")
            fns.append(lambda plan=plan, out=out: P.launch_copy(
                lib, x, start, rows, plan, out, scale=scale, off=off))
        ms = _ms(fns)
        cells = [f"{p.grid}x({p.tx}x{p.ty}) {t:.5f}{'*' if p == rule else ''}"
                 for p, t in zip(sweep, ms[1:])]
        print(f"  {row:20s} torch call {ms[0]:.5f}: " + "  ".join(cells),
              flush=True)
    a = torch.rand((128, 128), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    ref = P.transpose_plain(a)
    rule = plans["probe_transpose"] = P.transpose_plan(128, 128, sms)
    sweep = [P.transpose_plan(128, 128, sms, tile=t)
             for t in P.TRANSPOSE_TILES + ((4, 2), (2, 2))]
    fns = [lambda: a.t().contiguous()]
    for plan in sweep:
        out = torch.empty_like(ref)
        if P.launch_transpose(lib, a, plan, out):
            raise RuntimeError(f"transpose {plan}: launch failed")
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise RuntimeError(f"transpose {plan}: output differs from plain")
        fns.append(lambda plan=plan, out=out: P.launch_transpose(lib, a,
                                                                 plan, out))
    ms = _ms(fns)
    cells = [f"{p.p}x{p.q} {p.grid} {t:.5f}{'*' if p == rule else ''}"
             for p, t in zip(sweep, ms[1:])]
    print(f"  {'probe_transpose':20s} torch call {ms[0]:.5f}: "
          + "  ".join(cells), flush=True)

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("probes.cu", ABLATIONS,
                 {"probe_copy_launch": [vp, i32, i32, i32, vp, *[i32] * 7, vp,
                                        vp],
                  "probe_transpose_launch": [vp, *[i32] * 5, vp, vp]},
                 BUILD_DIR / "copy_ablation")
    print("ablations of csrc/probes.cu on the plans' launches, ms a launch")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for row, (x, start, rows, scale, off, _) in cases.items():
        ref = P.copy_rows_plain(x, start, rows, scale=scale, off=off)
        fns = []
        for name, dll in libs.items():
            out = torch.zeros_like(ref)
            args = P._copy_args(x, start, rows, plans[row], out, scale, off)
            if name in ("host start", "stores only"):
                # the start as the pointer's value: no device read
                args[4] = ctypes.c_void_p(int(start.item()))
            if dll.probe_copy_launch(*args, stream):
                raise RuntimeError(f"{row} {name}: launch failed")
            torch.cuda.synchronize()
            if name in _EXACT and not torch.equal(out, ref):
                raise RuntimeError(f"{row} {name}: output differs from "
                                   "plain")
            fns.append(lambda dll=dll, args=args: dll.probe_copy_launch(
                *args, stream))
        cells = [f"{name}: {t:.5f}" for name, t in zip(libs, _ms(fns))]
        print(f"  {row:20s} " + "  ".join(cells), flush=True)
    names = [name for name in libs if name not in _COPY_ONLY]
    fns = []
    for name in names:
        out = torch.empty_like(P.transpose_plain(a))
        if P.launch_transpose(libs[name], a, plans["probe_transpose"], out):
            raise RuntimeError(f"transpose {name}: launch failed")
        fns.append(lambda dll=libs[name], out=out: P.launch_transpose(
            dll, a, plans["probe_transpose"], out))
    cells = [f"{name}: {t:.5f}" for name, t in zip(names, _ms(fns))]
    print(f"  {'probe_transpose':20s} " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
