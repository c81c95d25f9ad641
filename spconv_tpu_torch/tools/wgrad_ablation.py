"""Where the bf16 wgrad's time goes: builds ``csrc/dg_wgrad.cu`` three ways
and times each at BenchNet's 14 wgrad shapes on the card, counts the MMA
rows the kernel issues, and times the library's kernel under five settings
of the row-split rule.

- ``as is``: the kernel as it is;
- ``no MMA``: every warp skips its ldmatrix and MMAs (the listing, the
  copies and the barriers remain);
- ``no copy``: every listed row's copies are zero-fills (nothing is read
  from x or dout; the copies are still issued).

The counting build (``COUNT``): the kernel as it is, with a device counter
that each block's thread 0 raises by one for every k16 slice its warp
multiplies (warp 0 holds outputs in every block, and every warp that does
multiplies the same slices), read by ``dg_wgrad_slices_issued``.  16 times
the count over the dW tiles is the MMA rows the kernel issued per tile;
``mma/pair`` divides it by the matched (row, offset) pairs.

The splits: ``ops/dg_conv.py``'s rule aims at ``_WGRAD_WAVES`` waves of
resident blocks; the sweep sets it to 1, 2, 3, 4 and 6.

The shapes: each layer's x and dout on its stage of
``benchmark.basic.synthetic_scan(0)`` (pool bounds calibrated on seed 0,
as ``chip_smoke.py`` builds them), through the reversed B1 table.  Times:
CUDA events over 10 launches after a warm-up, behind a queued device sleep
(the reduce included where there is more than one split).  The rebuilt
"as is" and counting outputs are checked bit-equal to the library
kernel's.

Run:  python -m spconv_tpu_torch.tools.wgrad_ablation
"""

import ctypes
import sys

import torch

from .._build import BUILD_DIR
from ..benchmark import basic as B
from ..modules import SparseMaxPool3d
from ..ops import coords as C
from ..ops import dg_conv as D
from .ablation import build, cuda_ms

# (name, [(text in dg_wgrad.cu, its replacement at every place)])
ABLATIONS = (
    ("as is", []),
    ("no MMA", [("    if (!warp_live) return;", "    return;")]),
    ("no copy", [("const bool ok = base + r < produced;",
                  "const bool ok = false;")]),
)
_SLICE = ("      if (s * T::BJ + ks * 16 >= produced) break;  "
          "// padding from here on\n")
COUNT = ("count", [
    ("namespace wg {\n",
     "namespace wg {\n__device__ unsigned long long slices_issued;\n"),
    (_SLICE, _SLICE + "      if (tid == 0) atomicAdd(&slices_issued, 1ull);\n"),
    ("}  // namespace\n", """}  // namespace

// the k16 slices counted so far into *out; zeroed if reset
extern "C" int dg_wgrad_slices_issued(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, wg::slices_issued, sizeof(*out));
  const unsigned long long zero = 0;
  if (e == cudaSuccess && reset) {
    e = cudaMemcpyToSymbol(wg::slices_issued, &zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""),
])
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"dg_wgrad_bf16_launch": [_VP] * 5 + [_I32] * 8 + [_VP]}
COUNT_ARGTYPES = {**ARGTYPES, "dg_wgrad_slices_issued": [
    ctypes.POINTER(ctypes.c_ulonglong), _I32]}
WAVES = (1, 2, 3, 4, 6)
SHAPE = (80, 1600, 1600)
N_VOXELS = 125_562


def launcher(lib, x, dout, pos_bwd, out):
    """A call of ``lib``'s ``dg_wgrad_bf16_launch`` writing ``out``, with
    the variant and splits ``ops/dg_conv.py`` would choose."""
    n, c = x.shape
    kv, k = pos_bwd.shape[0], dout.shape[1]
    v = D.wgrad_variant(n, c, k, kv, aligned=x.data_ptr() % 16 == 0,
                        dout_aligned=dout.data_ptr() % 16 == 0)
    part = torch.empty((v.grid[2], kv, c, k) if v.grid[2] > 1 else (1,),
                       dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.dg_wgrad_bf16_launch(
            x.data_ptr(), dout.data_ptr(), pos_bwd.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, c, k, kv, v.grid[2], v.tile,
            int(v.vec), int(v.dvec), stream)
        if err:
            raise RuntimeError(f"dg_wgrad_bf16_launch: CUDA error {err}")

    return launch


def issued_mma_rows(count_lib, x, dout, pos_bwd) -> float:
    """The MMA rows the counting build multiplies per dW tile in one bf16
    wgrad of ``x`` and ``dout`` through ``pos_bwd`` (16 times its k16
    slices over the tiles); its dW must be bit-equal to the library
    kernel's."""
    out = torch.empty((pos_bwd.shape[0], x.shape[1], dout.shape[1]),
                      dtype=torch.bfloat16, device=x.device)
    ref = D.dg_wgrad(x, dout, pos_bwd)
    got = ctypes.c_ulonglong(0)

    def read(reset):
        err = count_lib.dg_wgrad_slices_issued(ctypes.byref(got), reset)
        if err:
            raise RuntimeError(f"dg_wgrad_slices_issued: CUDA error {err}")

    torch.cuda.synchronize()
    read(1)
    launcher(count_lib, x, dout, pos_bwd, out)()
    torch.cuda.synchronize()
    read(0)
    if not torch.equal(out, ref):
        raise RuntimeError("the counting build's dW differs from the "
                           "library's")
    tiles = D.wgrad_variant(x.shape[0], x.shape[1], dout.shape[1],
                            pos_bwd.shape[0]).grid[0]
    return 16 * got.value / tiles


def stage_tables(dev):
    """The reversed B1 table and the valid-row mask of each BenchNet
    stage."""
    x0 = B.make_bench_input(*B.synthetic_scan(0, SHAPE, N_VOXELS), device=dev)
    bounds = B.measure_pool_bounds(SHAPE, x0)
    geo = [x0]
    for s in range(6):
        geo.append(SparseMaxPool3d(2, 2, out_bound=bounds[s])(geo[-1]))
    out = []
    for g in geo:
        keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        rev = D.build_dg_pos(keys, ksize=(3, 3, 3), dilation=(1, 1, 1),
                             spatial_shape=g.spatial_shape, batch_size=1,
                             reverse=True)
        out.append((rev, g.valid_mask))
    return out


def main():
    dev = torch.device("cuda")
    libs = build("dg_wgrad.cu", ABLATIONS + (COUNT,), ARGTYPES,
                 BUILD_DIR / "wgrad_ablation")
    count_lib = libs.pop(COUNT[0])
    count_lib.dg_wgrad_slices_issued.argtypes = COUNT_ARGTYPES[
        "dg_wgrad_slices_issued"]
    stages = stage_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    default_waves = D._WGRAD_WAVES
    print(f"{torch.cuda.get_device_name(0)}; BenchNet's 14 bf16 wgrads "
          f"(ms); splits at {default_waves} waves for the ablations; "
          "mma/pair counted by the counting build")
    print("layer   rows     C    K  tile     splits  mma/pair  "
          + "  ".join(f"{name:>8s}" for name, _ in ABLATIONS) + "  "
          + "  ".join(f"{w:d} waves" for w in WAVES))
    totals = [0.0] * (len(ABLATIONS) + len(WAVES))
    for layer in range(14):
        rev, valid = stages[layer // 2]
        n = rev.shape[1]
        c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
        x = (torch.randn((n, c), device=dev, generator=gen)
             * valid[:, None]).bfloat16()
        dout = (torch.randn((n, k), device=dev, generator=gen)
                * valid[:, None]).bfloat16()
        ref = D.dg_wgrad(x, dout, rev)
        v = D.wgrad_variant(n, c, k, aligned=x.data_ptr() % 16 == 0)
        rows = issued_mma_rows(count_lib, x, dout, rev)
        pairs = int((rev >= 0).sum())
        times = []
        for name, lib in libs.items():
            out = torch.empty((27, c, k), dtype=torch.bfloat16, device=dev)
            times.append(cuda_ms(launcher(lib, x, dout, rev, out)))
            if name == "as is" and not torch.equal(out, ref):
                raise RuntimeError(f"layer {layer}: the rebuilt kernel "
                                   "differs from the library's")
        for waves in WAVES:
            D._WGRAD_WAVES = waves
            try:
                times.append(cuda_ms(lambda: D.dg_wgrad(x, dout, rev)))
            finally:
                D._WGRAD_WAVES = default_waves
        totals = [a + b for a, b in zip(totals, times)]
        print(f"conv{layer:<3d} {n:7d} {c:4d} {k:4d}  {v.bm}x{v.bn}"
              f"{'' if v.vec else ' s'}  {v.grid[2]:5d}  {rows / pairs:8.4f}  "
              + "  ".join(f"{t:8.4f}" for t in times), flush=True)
    print("sum                                          "
          + "  ".join(f"{t:8.4f}" for t in totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
