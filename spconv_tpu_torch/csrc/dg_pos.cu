// B1 `dg_pos`: the match table of a submanifold conv stage on key-sorted
// input, in the forward direction or reversed (the backward's table); in
// affine mode the table of a regular (strided) conv, and in divide mode its
// inverse, the table of the inverse conv and of the strided backward (see
// below).
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
//
// Affine mode (`dg_pos_affine_launch`): the match table of a regular
//   (strided) conv, whose output sites differ from its input sites.
//   Replaces the affine probes of the same Pallas kernels that the strided
//   conv runs in search mode: spconv_tpu/ops/pallas/dg_conv.py:302
//   (_vec_affine_probes) inside :339 (_dg_fwd_kernel), launched at :1020
//   through _dg_reg_conv (:1837-1849), public entry dg_regular_conv.  The
//   TPU kernel searches windows of the input keys inside its GEMM; here the
//   search is this table, and B2 (dg_fwd.cu) gathers through it unchanged.
//   For output row o and kernel offset k, decode o's key with the OUTPUT
//   dims (batch b first), move each axis to coord * stride + off_k * dil -
//   pad (the regular conv's displacement: no centring, unlike the subm
//   mode), bounds-check it against the INPUT dims, relinearize with the
//   input dims and b, and binary-search in_keys[0, N_in) (about 0.5 MB for
//   the CenterPoint scan, resident in L2).  Writes the input row or -1 to
//   pos[k * N_out + o]; sentinel output rows get -1 at every offset.  Bound
//   and design as the subm mode.
//
// Divide mode (`dg_pos_divide_launch`): the exact inverse of the affine
//   table, [kv, N_in].  Replaces the divide probes of the same Pallas
//   kernels: spconv_tpu/ops/pallas/dg_conv.py:315 (_vec_divide_probes)
//   inside :339 (_dg_fwd_kernel, the inverse conv's forward) and :1307
//   (_dg_bwd_kernel, the strided conv's backward, probes from
//   sorted_conv.py:392 _probe_divide_fn), launched at :1020 and :1598 from
//   _dg_reg_conv (:1850-1860) and _dg_reg_conv_bwd (:1874-1881).  For input
//   row i and kernel offset k, decode i's key with the INPUT dims (batch b
//   first); per axis t = coord - (off_k * dil - pad) must be >= 0 and
//   divisible by the stride, and c = t / stride must lie inside the OUTPUT
//   dims; relinearize c with the output dims and b, and binary-search
//   out_keys[0, N_out) (~0.45 MB at the U-Net's first downsample, resident
//   in L2).  Writes the output row or -1 to pos[k * N_in + i]; sentinel
//   input rows get -1.  Row i holds o at offset k iff the affine table
//   holds i at (k, o): each offset's map is one-to-one.
//   Bound: latency of the dependent L2 loads of the search, as the other
//   modes; the bytes are N_in * 4 read and kv * N_in * 4 written.  Design:
//   as the other modes, one thread per (row, offset), offset-major, so many
//   independent searches are in flight and the writes are coalesced; most
//   probes fail the divisibility test (7 of 8 offsets of a k3 s2 input row)
//   and never search.

#include <cuda_runtime.h>

#include "dg_search.cuh"

namespace {

using dg::kMaxNdim;
using dg::search_row;

struct AffineGeom {
  int ndim;
  int out_dims[kMaxNdim];
  int in_dims[kMaxNdim];
  int stride[kMaxNdim];
  int ksize[kMaxNdim];
  int dil[kMaxNdim];
  int pad[kMaxNdim];
};

// The subm probe is dg_search.cuh's, shared with the search-mode kernels.
__global__ void dg_pos_kernel(const int* __restrict__ keys, int n, int kv,
                              dg::SubmGeom g, int sentinel, int reverse,
                              int* __restrict__ pos) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= kv * n) return;
  const int k = t / n;
  const int i = t - k * n;
  pos[t] = dg::subm_probe(keys, n, keys[i], k, g, sentinel, reverse != 0);
}

__global__ void dg_pos_affine_kernel(const int* __restrict__ out_keys,
                                     int n_out,
                                     const int* __restrict__ in_keys,
                                     int n_in, int kv, AffineGeom g,
                                     int sent_out, int* __restrict__ pos) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= kv * n_out) return;
  const int k = t / n_out;
  const int o = t - k * n_out;
  const int key = out_keys[o];
  int res = -1;
  if (key != sent_out) {
    int rem = key;
    int kr = k;
    int lin = 0;  // input key without the batch term
    int vol = 1;  // volume of the input axes done so far
    bool ok = true;
#pragma unroll
    for (int a = kMaxNdim - 1; a >= 0; --a) {
      if (a < g.ndim) {
        const int coord = rem % g.out_dims[a];
        rem /= g.out_dims[a];
        const int ka = kr % g.ksize[a];
        kr /= g.ksize[a];
        const int c = coord * g.stride[a] + ka * g.dil[a] - g.pad[a];
        ok = ok && c >= 0 && c < g.in_dims[a];
        if (ok) lin += c * vol;
        vol *= g.in_dims[a];
      }
    }
    // rem is now the batch index
    if (ok) res = search_row(in_keys, n_in, rem * vol + lin);
  }
  pos[t] = res;
}

// Same geometry record as the affine mode; here the row decodes with
// in_dims and the probe relinearizes with out_dims.
__global__ void dg_pos_divide_kernel(const int* __restrict__ in_keys,
                                     int n_in,
                                     const int* __restrict__ out_keys,
                                     int n_out, int kv, AffineGeom g,
                                     int sent_in, int* __restrict__ pos) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= kv * n_in) return;
  const int k = t / n_in;
  const int i = t - k * n_in;
  const int key = in_keys[i];
  int res = -1;
  if (key != sent_in) {
    int rem = key;
    int kr = k;
    int lin = 0;  // output key without the batch term
    int vol = 1;  // volume of the output axes done so far
    bool ok = true;
#pragma unroll
    for (int a = kMaxNdim - 1; a >= 0; --a) {
      if (a < g.ndim) {
        const int coord = rem % g.in_dims[a];
        rem /= g.in_dims[a];
        const int ka = kr % g.ksize[a];
        kr /= g.ksize[a];
        const int tt = coord - (ka * g.dil[a] - g.pad[a]);
        // tt >= 0 is checked first: C's % and / truncate toward zero
        ok = ok && tt >= 0 && tt % g.stride[a] == 0 &&
             tt / g.stride[a] < g.out_dims[a];
        if (ok) lin += (tt / g.stride[a]) * vol;
        vol *= g.out_dims[a];
      }
    }
    // rem is now the batch index
    if (ok) res = search_row(out_keys, n_out, rem * vol + lin);
  }
  pos[t] = res;
}

AffineGeom affine_geom(const int* geom) {
  AffineGeom g;
  g.ndim = geom[0];
  for (int a = 0; a < kMaxNdim; ++a) {
    g.out_dims[a] = geom[1 + a];
    g.in_dims[a] = geom[1 + kMaxNdim + a];
    g.stride[a] = geom[1 + 2 * kMaxNdim + a];
    g.ksize[a] = geom[1 + 3 * kMaxNdim + a];
    g.dil[a] = geom[1 + 4 * kMaxNdim + a];
    g.pad[a] = geom[1 + 5 * kMaxNdim + a];
  }
  return g;
}

}  // namespace

// geom (host memory): ndim, dims[4], ksize[4], dilation[4].  reverse != 0
// negates every displacement.
extern "C" int dg_pos_launch(const void* keys, int n, int kv, const int* geom,
                             int sentinel, int reverse, void* pos,
                             void* stream) {
  const int threads = 256;
  const int total = kv * n;
  const int blocks = (total + threads - 1) / threads;
  dg_pos_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n, kv, dg::subm_geom(geom), sentinel,
      reverse, static_cast<int*>(pos));
  return static_cast<int>(cudaGetLastError());
}

// geom (host memory): ndim, out_dims[4], in_dims[4], stride[4], ksize[4],
// dilation[4], padding[4].  The wrapper checks kv * n_out < 2**31 and that
// both key spaces fit in int32.
extern "C" int dg_pos_affine_launch(const void* out_keys, int n_out,
                                    const void* in_keys, int n_in, int kv,
                                    const int* geom, int sent_out, void* pos,
                                    void* stream) {
  const int threads = 256;
  const int total = kv * n_out;
  const int blocks = (total + threads - 1) / threads;
  dg_pos_affine_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(out_keys), n_out,
      static_cast<const int*>(in_keys), n_in, kv, affine_geom(geom),
      sent_out, static_cast<int*>(pos));
  return static_cast<int>(cudaGetLastError());
}

// geom: as dg_pos_affine_launch's.  The wrapper checks kv * n_in < 2**31.
extern "C" int dg_pos_divide_launch(const void* in_keys, int n_in,
                                    const void* out_keys, int n_out, int kv,
                                    const int* geom, int sent_in, void* pos,
                                    void* stream) {
  const int threads = 256;
  const int total = kv * n_in;
  const int blocks = (total + threads - 1) / threads;
  dg_pos_divide_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in_keys), n_in,
      static_cast<const int*>(out_keys), n_out, kv, affine_geom(geom),
      sent_in, static_cast<int*>(pos));
  return static_cast<int>(cudaGetLastError());
}
