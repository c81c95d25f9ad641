// B1 `dg_pos`: the match table of a submanifold conv stage on key-sorted
// input, in the forward direction or reversed (the backward's table); in
// affine mode the table of a regular (strided) conv, and in divide mode its
// inverse, the table of the inverse conv and of the strided backward (on
// swapped spaces, of the transposed conv).
//
// Replaces: spconv_tpu/ops/pallas/dg_conv.py::_dg_pos_kernel (launched by
//   _build_dg_pos, public entry build_dg_pos), and the affine and divide
//   probes of the same file's kernels that the strided, inverse and
//   transposed convs run in search mode: :302 (_vec_affine_probes) and :315
//   (_vec_divide_probes) inside :339 (_dg_fwd_kernel, launched at :1020)
//   and :1307 (_dg_bwd_kernel, launched at :1598), from _dg_reg_conv
//   (:1837-1860) and _dg_reg_conv_bwd (:1874-1889).  The TPU kernel
//   searches 128-lane tiles of probes inside DMA'd, lane-chunked key windows
//   chosen by a window plan; here a block finds its own windows.
//
// Computes: for each row i of the table's rows and kernel offset k
//   (row-major 'ij' order over the kernel dims), the row of the searched
//   keys whose key is row i's key moved by k, or -1 (dg_search.cuh's
//   WindowRows gives the maps), written to pos[k * N + i] (offset-major, so
//   the gather-GEMMs read one offset's column of a row tile coalesced).
//   Rows with the sentinel get -1 at every offset.  Modes:
//   - subm (`divide` 0, `self` 1): the stage's own keys, each axis moved by
//     (offset - centre) * dilation and bounds-checked;
//   - subm reversed (`divide` 1, `self` 1): every displacement negated, the
//     table dgrad and wgrad gather dout through (for an odd kernel the
//     forward table flipped on its offset axis; computed directly);
//   - affine (`divide` 0): output rows, each axis at coord * stride + off *
//     dil - pad inside the input grid, searched in the input keys;
//   - divide (`divide` 1): input rows, each axis at (coord - off * dil +
//     pad) / stride where that divides and lies inside the output grid,
//     searched in the output keys: the exact inverse of the affine table.
//
// Bound on the H100: bytes (N keys read, kv * N table entries written: 13.6
//   MB at BenchNet's first stage); the searches are integer compares.  A
//   search of all N keys per probe is ~17 dependent L2 loads, so the table
//   was latency-bound at 14x its bound.
//
// Design (dg_search.cuh, WindowRows): a block owns a tile of consecutive
//   rows; for each group of offsets (fixed indices on all but the last two
//   kernel axes) it stages the window of searched keys that the tile's
//   probes can reach in shared memory (two lower bounds, one warp each,
//   128 keys a step), then walks each (row, line of the last kernel axis):
//   one
//   lower bound in the window, a short forward scan to each next offset.
//   A 3^3 kernel does 9 searches a row, in shared memory; a subm stage's
//   centre line starts at the row itself.  The windows of a pass share a
//   pool of 4,096 keys; one that does not fit whole keeps every s-th key
//   there where the rest of the pool allows one key each (else none), and
//   its searches end in global memory.  A warp walks one line for 32
//   consecutive rows and stores their results offset-major, 32
//   consecutive ints a store; in divide
//   mode with a stride the rows are walked by residue class, and the
//   results collect in shared memory and are written out after the pass.
//   The tile, the groups a pass holds, the pool, the shared memory and the
//   grid come from the host plan (ops/dg_conv.py::b1_plan): tiles of 128
//   rows at the large stages, 64 or 32 where 128 would leave fewer than
//   two blocks an SM.  A table of at most 131,072 (row, offset) probes
//   (BenchNet's stages 4-6) takes the direct path instead, one thread a
//   probe searching the whole table: there a window's fixed chain (rows,
//   group pass, bounds, staging, walks) outlasts one search.

#include <cuda_runtime.h>

#include "dg_search.cuh"

namespace {

// The direct path: one thread per (row, offset), offset-major (coalesced
// writes, neighbouring threads on neighbouring keys): the row moved by the
// offset, searched in the whole table (dg::search_row).
template <int NDIM, bool kDivide>
__global__ void __launch_bounds__(256, 2)
dg_pos_direct_kernel(const int* __restrict__ rows, int n_rows,
                     const int* __restrict__ tab, int n_tab, dg::WinGeom g,
                     int row_sent, int kv, int* __restrict__ pos) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= kv * n_rows) return;
  const int k = t / n_rows;
  const int key = __ldg(rows + t - k * n_rows);
  int res = -1;
  if (key != row_sent) {
    int rem = key;
    int kr = k;
    int lin = 0;  // the moved key without the batch term
    int vol = 1;  // the volume of the table's axes done so far
    bool ok = true;
#pragma unroll
    for (int a = NDIM - 1; a >= 0; --a) {
      const int x = rem % g.row_dims[a];
      rem /= g.row_dims[a];
      const int ka = kr % g.ksize[a];
      kr /= g.ksize[a];
      int c = 0;
      ok = ok && dg::win_axis<kDivide>(g, a, x, ka, &c);
      lin += c * vol;
      vol *= g.tab_dims[a];
    }
    // rem is now the batch index
    if (ok) res = dg::search_row(tab, n_tab, rem * vol + lin);
  }
  pos[t] = res;
}

template <int NDIM, bool kDivide>
__global__ void __launch_bounds__(256, 2)
dg_pos_kernel(const int* __restrict__ rows, int n_rows,
              const int* __restrict__ tab, int n_tab, dg::WinGeom g,
              int row_sent, int self, int sort, int tile, int gpp, int pool,
              int* __restrict__ pos) {
  extern __shared__ int sm[];
  // without sort the walks store straight into pos
  const dg::WindowRows<NDIM, kDivide> w{rows, n_rows,   tab,  n_tab,
                                        g,    row_sent, self, sort,
                                        tile, gpp,      pool,
                                        sort ? nullptr : pos};
  const int row0 = blockIdx.x * tile;
  const int here = min(tile, n_rows - row0);
  const int per_group = w.kline() * w.klast();
  const int groups = w.groups();
  w.load_rows(sm, row0);
  for (int g0 = 0; g0 < groups; g0 += gpp) {
    const int gc = min(gpp, groups - g0);
    const int fell_back = w.search(sm, g0, gc, row0);
    (void)fell_back;  // windows searched in global memory this pass
    if (sort) {
      // the pass's results, offset-major; the next pass writes out only
      // after the barriers of its search
      const int* out = w.out(sm);
      const size_t k0 = static_cast<size_t>(g0) * per_group;
      for (int e = threadIdx.x; e < gc * per_group * tile; e += blockDim.x) {
        const int kk = e / tile;
        const int r = e - kk * tile;
        if (r < here) pos[(k0 + kk) * n_rows + row0 + r] = out[e];
      }
    }
  }
}

template <int NDIM>
cudaError_t launch(const int* rows, int n_rows, const int* tab, int n_tab,
                   const dg::WinGeom& g, int row_sent, int divide, int self,
                   int sort, int tile, int gpp, int pool, int smem, int* pos,
                   cudaStream_t s) {
  if (tile == 0) {
    int kv = 1;
    for (int a = 0; a < NDIM; ++a) kv *= g.ksize[a];
    const int blocks = (kv * n_rows + 255) / 256;
    auto direct = divide ? dg_pos_direct_kernel<NDIM, true>
                         : dg_pos_direct_kernel<NDIM, false>;
    direct<<<blocks, 256, 0, s>>>(rows, n_rows, tab, n_tab, g, row_sent, kv,
                                  pos);
    return cudaGetLastError();
  }
  const int blocks = (n_rows + tile - 1) / tile;
  auto kernel =
      divide ? dg_pos_kernel<NDIM, true> : dg_pos_kernel<NDIM, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, 256, smem, s>>>(rows, n_rows, tab, n_tab, g, row_sent,
                                   self, sort, tile, gpp, pool, pos);
  return cudaGetLastError();
}

}  // namespace

// One table [kv, n_rows] of the rows' sorted keys searched in tab's
// (dg_search.cuh's WindowRows): geom (host memory) as dg::win_geom reads
// it; divide != 0 takes the divide map, else the affine one; self != 0
// when tab is rows (a subm stage); sort != 0 walks the rows by residue
// class (divide mode, stride product 2-64).  The plan
// (ops/dg_conv.py::b1_plan): tile rows a block (<= 256; 0: the direct
// path, which reads no other plan value), gpp offset groups a pass, pool
// keys of windows a pass, smem bytes of dynamic shared memory.  The wrapper checks kv * n_rows < 2**31 and that both key spaces
// fit in int32.
extern "C" int dg_pos_launch(const void* rows, int n_rows, const void* tab,
                             int n_tab, const int* geom, int row_sent,
                             int divide, int self, int sort, int tile,
                             int gpp, int pool, int smem, void* pos,
                             void* stream) {
  const dg::WinGeom g = dg::win_geom(geom);
  const int* r = static_cast<const int*>(rows);
  const int* t = static_cast<const int*>(tab);
  int* p = static_cast<int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g.ndim) {
    case 1:
      return launch<1>(r, n_rows, t, n_tab, g, row_sent, divide, self, sort,
                       tile, gpp, pool, smem, p, s);
    case 2:
      return launch<2>(r, n_rows, t, n_tab, g, row_sent, divide, self, sort,
                       tile, gpp, pool, smem, p, s);
    case 3:
      return launch<3>(r, n_rows, t, n_tab, g, row_sent, divide, self, sort,
                       tile, gpp, pool, smem, p, s);
    case 4:
      return launch<4>(r, n_rows, t, n_tab, g, row_sent, divide, self, sort,
                       tile, gpp, pool, smem, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
