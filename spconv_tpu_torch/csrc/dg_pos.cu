// B1 `dg_pos`: the match table of a submanifold conv stage on key-sorted
// input, in the forward direction or reversed (the backward's table).
//
// Replaces: spconv_tpu/ops/pallas/dg_conv.py::_dg_pos_kernel (launched by
//   _build_dg_pos, public entry build_dg_pos).  The TPU kernel searches
//   128-lane tiles of probes inside DMA'd, lane-chunked key windows chosen by
//   a window plan, with a serial sweep when a probe falls outside its window.
//   None of that is needed here: the whole key array (N int32, about 0.5 MB
//   for a 125k-voxel scan) stays resident in L2, so every probe searches all
//   of it.
//
// Computes: for output row i and kernel offset k (row-major 'ij' order over
//   the kernel dims), decode the row's coordinates from its key, add the
//   displacement d_k = (offset_k - centre) * dilation, bounds-check every
//   axis, and binary-search the shifted key in keys[0, N).  Writes the
//   matching row or -1 to pos[k * N + i] (offset-major, so the gather-GEMM
//   reads one offset's column of a row tile coalesced).  Sentinel rows get
//   -1 at every offset.  With `reverse` every displacement is negated
//   (probe = key - delta_k, each axis bounds-checked at coord - d_k): the
//   table that dgrad and wgrad gather dout through (build_dg_pos with
//   reverse=True, built in _dg_conv_p_fwd).  For a subm kernel, odd and so
//   symmetric, that is the forward table with its offset axis flipped, but
//   the kernel computes it directly and does not rely on the symmetry.
//
// Bound on the H100: latency.  A probe is ~log2(N) = 17 dependent key loads
//   that hit L2 (the top levels of the search hit L1); there is almost no
//   arithmetic and the output is 4 bytes per (row, offset).
//
// Design: one thread per (row, offset), offset-major thread order so that
//   writes are coalesced and neighbouring threads search for neighbouring
//   keys, which share the upper levels of the search path in cache.  Many
//   independent searches in flight hide the load latency.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxNdim = 4;

struct PosGeom {
  int ndim;
  int dims[kMaxNdim];
  int ksize[kMaxNdim];
  int dil[kMaxNdim];
};

__global__ void dg_pos_kernel(const int* __restrict__ keys, int n, int kv,
                              PosGeom g, int sentinel, int reverse,
                              int* __restrict__ pos) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= kv * n) return;
  const int k = t / n;
  const int i = t - k * n;
  const int key = keys[i];
  int res = -1;
  if (key != sentinel) {
    int rem = key;
    int kr = k;
    int delta = 0;
    int stride = 1;
    bool ok = true;
#pragma unroll
    for (int a = kMaxNdim - 1; a >= 0; --a) {
      if (a < g.ndim) {
        const int coord = rem % g.dims[a];
        rem /= g.dims[a];
        const int ka = kr % g.ksize[a];
        kr /= g.ksize[a];
        int d = (ka - g.ksize[a] / 2) * g.dil[a];
        if (reverse) d = -d;
        const int c = coord + d;
        ok = ok && c >= 0 && c < g.dims[a];
        delta += d * stride;
        stride *= g.dims[a];
      }
    }
    if (ok) {
      const int probe = key + delta;
      int lo = 0;
      int hi = n;
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(keys + mid) < probe) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo < n && __ldg(keys + lo) == probe) res = lo;
    }
  }
  pos[t] = res;
}

}  // namespace

// geom (host memory): ndim, dims[4], ksize[4], dilation[4].  reverse != 0
// negates every displacement.
extern "C" int dg_pos_launch(const void* keys, int n, int kv, const int* geom,
                             int sentinel, int reverse, void* pos,
                             void* stream) {
  PosGeom g;
  g.ndim = geom[0];
  for (int a = 0; a < kMaxNdim; ++a) {
    g.dims[a] = geom[1 + a];
    g.ksize[a] = geom[1 + kMaxNdim + a];
    g.dil[a] = geom[1 + 2 * kMaxNdim + a];
  }
  const int threads = 256;
  const int total = kv * n;
  const int blocks = (total + threads - 1) / threads;
  dg_pos_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, kv, g, sentinel, reverse != 0,
      static_cast<int*>(pos));
  return static_cast<int>(cudaGetLastError());
}
