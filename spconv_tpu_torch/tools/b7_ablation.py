"""Where B7's int8 time goes: builds ``csrc/dg_fwd_q.cu`` four ways and
times each at the int8 CenterPoint encoder's subm shapes on the card, and
counts the MMA rows the kernel issues.

- ``as is``: the kernel as it is;
- ``no MMA``: every warp returns before its ldmatrix and MMAs (the copies,
  the barriers, the row staging and the epilogue remain);
- ``no copy``: the 16-byte copies of the features and the weight are
  zero-fills (nothing is read from memory; the copies are still issued,
  and the scalar gather of C = 5 still reads);
- ``sync fill``: the table's rows staged one load at a time (``_SYNC_FILL``,
  the body ``dg::TableTile``'s fill had before it took 4-byte ``cp.async``
  copies), in place of the shared ``cp.async`` fill.

The counting build (``COUNT``): the kernel as it is, with a device counter
that lane 0 of each warp of the first column stripe (and of the first
column tile) raises by one for every (k32 slice, 16-row tile) it
multiplies, read by ``dg_fwd_q_slices_issued``.  16 times the count is the
MMA rows the kernel issued, which ``ops/dg_conv.py::b7_mma_rows`` models
on the host; ``issued/needed`` divides it by the rows of the matched pairs
alone (``b7_mma_rows``'s second count).

The shapes: the CenterPoint encoder's four subm stages on
``centerpoint.synthetic_centerpoint_input(0)`` (113,000 voxels on ``[80,
1024, 1024]``; the downsample buffers calibrated in f32 on seed 0, as
``chip_smoke.py`` builds them), each stage's B1 table, at the encoder's
widths: the first layer (C = 5 -> 16, packed, scalar gather) and 16, 32,
64 and 128 channels; bias and ReLU, and the residual at stages 0 and 3.
Times: CUDA events over 10 launches after a warm-up, behind a queued device
sleep.  The rebuilt "as is" and counting outputs are checked bit-equal to
the library kernel's.

Run:  python -m spconv_tpu_torch.tools.b7_ablation
"""

import ctypes
import sys

import torch

from .._build import BUILD_DIR
from ..benchmark import centerpoint as CPB
from ..ops import coords as C
from ..ops import dg_conv as D
from .ablation import build, cuda_ms

# A table row source whose fill waits on each load in turn
_SYNC_FILL = """
template <int BM>
struct SyncTable : dg::TableTile<BM> {
  __device__ __forceinline__ void fill(int* sm, int k0, int gk,
                                       int row0) const {
    for (int e = threadIdx.x; e < gk * BM; e += blockDim.x) {
      const int r = row0 + e % BM;
      sm[e] = r < this->n ? __ldg(this->pos + static_cast<size_t>(
                                      k0 + e / BM) * this->n + r)
                          : -1;
    }
  }
};
struct SyncTableArgs {
  const int* pos;
  int n;
  template <int BM>
  SyncTable<BM> make() const {
    return {{pos, n}};
  }
};
"""
# (name, [(text in dg_fwd_q.cu, its replacement at every place)])
ABLATIONS = (
    ("as is", []),
    ("no MMA", [("    if (!warp_cols) return;", "    return;")]),
    ("no copy", [("const bool ok = p >= 0 && c < C;",
                  "const bool ok = false;"),
                 ("const bool ok = li < cnt && n0 + r < K && c < C;",
                  "const bool ok = false;")]),
    ("sync fill", [("namespace b7 {\n", "namespace b7 {\n" + _SYNC_FILL),
                   ("dg::TableArgs{", "b7::SyncTableArgs{")]),
)
_TILE = "        if (!(m >> mi & 1u)) continue;\n"
COUNT = ("count", [
    ("namespace b7 {\n",
     "namespace b7 {\n__device__ unsigned long long slices_issued;\n"),
    (_TILE, _TILE + "        if (lane == 0 && wn == 0 && blockIdx.y == 0) "
                    "atomicAdd(&slices_issued, 1ull);\n"),
    ("}  // namespace\n", """}  // namespace

// the (k32 slice, 16-row tile) MMAs counted so far into *out; zeroed if
// reset
extern "C" int dg_fwd_q_slices_issued(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, b7::slices_issued, sizeof(*out));
  const unsigned long long zero = 0;
  if (e == cudaSuccess && reset) {
    e = cudaMemcpyToSymbol(b7::slices_issued, &zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""),
])
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# x, wt, pos, scale, bias, add, add_scale, relu, out, n, C, K, kv, tile,
# vec, stream
ARGTYPES = {"dg_fwd_q_launch": [_VP] * 6 + [ctypes.c_float, _I32, _VP]
            + [_I32] * 6 + [_VP]}
COUNT_ARGTYPES = {**ARGTYPES, "dg_fwd_q_slices_issued": [
    ctypes.POINTER(ctypes.c_ulonglong), _I32]}
# (stage, C, K, residual)
CASES = ((0, 5, 16, False), (0, 16, 16, False), (0, 16, 16, True),
         (1, 32, 32, False), (2, 64, 64, False), (3, 128, 128, False),
         (3, 128, 128, True))


def launcher(lib, x, w, pos, scale, bias, add, out, relu=True,
             add_scale=0.37):
    """A call of ``lib``'s ``dg_fwd_q_launch`` on the table ``pos``
    writing ``out``, with the variant ``ops/dg_conv.py`` would choose; ``w``
    ``[kv, C, K]`` is read through a ``[kv, K, C]`` copy made here."""
    n, c = pos.shape[1], x.shape[1]
    kv, k = w.shape[0], w.shape[2]
    wt = w.transpose(1, 2).contiguous()
    v = D.b7_variant(n, c, k, aligned=x.data_ptr() % 16 == 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch():
        err = lib.dg_fwd_q_launch(
            ptr(x), wt.data_ptr(), pos.data_ptr(), ptr(scale), ptr(bias),
            ptr(add), add_scale, int(relu), out.data_ptr(), n, c, k, kv,
            v.tile, int(v.vec), stream)
        if err:
            raise RuntimeError(f"dg_fwd_q_launch: CUDA error {err}")

    return launch


def issued_mma_rows(count_lib, x, w, pos, scale, bias=None, add=None):
    """The MMA rows the counting build issues in one B7 call (ReLU, the
    residual ``add`` at scale 0.37 where given) through the table ``pos``:
    16 times its (k32 slice, 16-row tile) count; its output must be
    bit-equal to the library kernel's."""
    out = torch.empty((pos.shape[1], w.shape[2]), dtype=torch.int8,
                      device=x.device)
    ref = D.dg_fwd_q(x, w, pos, scale, bias, act="relu", add=add,
                     add_scale=0.37)
    got = ctypes.c_ulonglong(0)

    def read(reset):
        err = count_lib.dg_fwd_q_slices_issued(ctypes.byref(got), reset)
        if err:
            raise RuntimeError(f"dg_fwd_q_slices_issued: CUDA error {err}")

    torch.cuda.synchronize()
    read(1)
    launcher(count_lib, x, w, pos, scale, bias, add, out)()
    torch.cuda.synchronize()
    read(0)
    if not torch.equal(out, ref):
        raise RuntimeError("the counting build's output differs from the "
                           "library's")
    return 16 * got.value


def stage_tables(dev):
    """``[(table, valid rows)]`` of the CenterPoint encoder's four subm
    stages on seed 0's synthetic scan."""
    x, _ = CPB.synthetic_centerpoint_input(0, device=dev)
    net = CPB.build_calibrated_encoder(x, dtype=torch.bfloat16)
    with torch.inference_mode():
        rec = net(x.replace_feature(x.features.bfloat16())).indice_dict
    out = []
    for si in range(4):
        if si:
            r = rec[f"__dgreg__down{si}"]
            inds, shape = r.out_indices, r.out_shape
        else:
            inds, shape = x.indices, x.spatial_shape
        keys, _ = C.linearize(inds, shape, 1)
        pos = D.build_dg_pos(keys, ksize=(3, 3, 3), dilation=(1, 1, 1),
                             spatial_shape=shape, batch_size=1)
        out.append((pos, inds[:, 0] >= 0))
    return out


def main():
    dev = torch.device("cuda")
    libs = build("dg_fwd_q.cu", ABLATIONS + (COUNT,), ARGTYPES,
                 BUILD_DIR / "b7_ablation")
    count_lib = libs.pop(COUNT[0])
    count_lib.dg_fwd_q_slices_issued.argtypes = COUNT_ARGTYPES[
        "dg_fwd_q_slices_issued"]
    stages = stage_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randq(shape, valid=None):
        q = torch.randint(-127, 128, shape, device=dev, generator=gen,
                          dtype=torch.int32).to(torch.int8)
        return q if valid is None else q * valid[:, None]

    print(f"{torch.cuda.get_device_name(0)}; the int8 CenterPoint encoder's "
          "subm shapes (ms; issued/needed: MMA rows counted by the counting "
          "build over those of the matched pairs alone)")
    print("stage    rows     C    K  add  tile       "
          + "  ".join(f"{name:>8s}" for name, _ in ABLATIONS)
          + "  issued/needed  matched TOP/s")
    totals = [0.0] * len(ABLATIONS)
    for si, c, k, residual in CASES:
        pos, valid = stages[si]
        n = pos.shape[1]
        x, w = randq((n, c), valid), randq((27, c, k))
        scale = (0.5 + torch.rand(k, device=dev, generator=gen)) * 60 / (
            5300 * (9 * c) ** 0.5)
        bias = (torch.rand(k, device=dev, generator=gen) - 0.5) * 40
        add = randq((n, k), valid) if residual else None
        ref = D.dg_fwd_q(x, w, pos, scale, bias, act="relu", add=add,
                         add_scale=0.37)
        v = D.b7_variant(n, c, k, aligned=x.data_ptr() % 16 == 0)
        issued = issued_mma_rows(count_lib, x, w, pos, scale, bias, add)
        model, needed = D.b7_mma_rows(pos, c, k)
        if issued != model:
            raise RuntimeError(f"stage {si} C={c}: the card issued {issued} "
                               f"MMA rows, the host model {model}")
        times = []
        for name, lib in libs.items():
            out = torch.empty((n, k), dtype=torch.int8, device=dev)
            times.append(cuda_ms(launcher(lib, x, w, pos, scale, bias, add,
                                          out)))
            if name == "as is" and not torch.equal(out, ref):
                raise RuntimeError(f"stage {si} C={c} K={k}: the rebuilt "
                                   "kernel differs from the library's")
        totals = [a + b for a, b in zip(totals, times)]
        pairs = int((pos >= 0).sum())
        tile = (f"{v.bm}x{v.bn}{'' if v.vec else ' s'}"
                f"{' p' if v.packed else ''}")
        print(f"{si:5d} {n:7d} {c:4d} {k:4d}  {'yes' if residual else 'no':3s}"
              f"  {tile:11s}" + "  ".join(f"{t:8.4f}" for t in times)
              + f"  {issued / needed:13.4f}"
              f"  {2 * pairs * c * k / times[0] / 1e9:13.1f}", flush=True)
    print("sum                                   "
          + "  ".join(f"{t:8.4f}" for t in totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
