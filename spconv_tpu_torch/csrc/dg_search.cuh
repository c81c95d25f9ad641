// The subm probe, shared by B1's subm mode (dg_pos.cu) and the search-mode
// gather-GEMMs (dg_fwd.cu, dg_wgrad.cu, dg_fwd_q.cu), the two row sources
// of a gather-GEMM's output tile (a cached match table, or an in-block
// search of the same rows), and the staging of a group of offsets' rows
// that the pipelined forward kernels (B2, B7) share.
//
// The search row sources replace the search mode (posmode=False, shift
// probes) of spconv_tpu/ops/pallas/dg_conv.py::_dg_fwd_kernel (:339,
// launched at :1020 and :1152) and ::_dg_bwd_kernel (:1307, launched at
// :1598).  The TPU kernel streams DMA'd windows of the sorted keys and
// binary-searches key(i) + delta_k in them inside the GEMM, building no
// table.  Here each block searches the whole key array (about 0.5 MB at
// 126k rows, resident in L2, as B1 assumes) for its own rows before it
// gathers through them, so no [kv, N] table reaches device memory.  A
// search row source returns exactly the rows B1 writes, so a search-mode
// kernel is bit-equal to B1 followed by the table-mode kernel.

#pragma once

#include <cuda_runtime.h>

#include "sm90_mma.cuh"

namespace dg {

constexpr int kMaxNdim = 4;

// A subm stage's geometry: the grid, the kernel and its dilation.
struct SubmGeom {
  int ndim;
  int dims[kMaxNdim];
  int ksize[kMaxNdim];
  int dil[kMaxNdim];
};

// geom (host memory): ndim, dims[4], ksize[4], dilation[4].
inline SubmGeom subm_geom(const int* geom) {
  SubmGeom g;
  g.ndim = geom[0];
  for (int a = 0; a < kMaxNdim; ++a) {
    g.dims[a] = geom[1 + a];
    g.ksize[a] = geom[1 + kMaxNdim + a];
    g.dil[a] = geom[1 + 2 * kMaxNdim + a];
  }
  return g;
}

// Row of `probe` in keys[0, n), or -1.
__device__ __forceinline__ int search_row(const int* __restrict__ keys,
                                          int n, int probe) {
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
  return (lo < n && __ldg(keys + lo) == probe) ? lo : -1;
}

// The key that `key` moves to by kernel offset k (row-major 'ij' order
// over the kernel dims): decode key's coordinates, add d_k = (offset_k -
// centre) * dilation (negated with `reverse`: the backward's probe) and
// bounds-check every axis.  False where an axis leaves the grid or `key` is
// the sentinel.
__device__ __forceinline__ bool subm_probe_key(int key, int k,
                                               const SubmGeom& g,
                                               int sentinel, bool reverse,
                                               int* probe) {
  if (key == sentinel) return false;
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
  *probe = key + delta;
  return ok;
}

// The row of keys[0, n) whose key is `key` moved by kernel offset k
// (subm_probe_key), or -1: where an axis leaves the grid, no row has the
// moved key, or `key` is the sentinel.
__device__ __forceinline__ int subm_probe(const int* __restrict__ keys,
                                          int n, int key, int k,
                                          const SubmGeom& g, int sentinel,
                                          bool reverse) {
  int probe;
  return subm_probe_key(key, k, g, sentinel, reverse, &probe)
             ? search_row(keys, n, probe)
             : -1;
}

// search_row for R probes at once, n >= 1: a branch-free lower bound whose
// steps depend on n alone, so the R searches' loads are in flight
// together.  ok[r] false gives -1.
template <int R>
__device__ __forceinline__ void search_rows(const int* __restrict__ keys,
                                            int n, const int (&probe)[R],
                                            const bool (&ok)[R],
                                            int (&row)[R]) {
  int base[R];
#pragma unroll
  for (int r = 0; r < R; ++r) base[r] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      base[r] = __ldg(keys + base[r] + half) < probe[r] ? base[r] + half
                                                       : base[r];
    }
    len -= half;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int lb = base[r] + (__ldg(keys + base[r]) < probe[r] ? 1 : 0);
    row[r] = ok[r] && lb < n && __ldg(keys + lb) == probe[r] ? lb : -1;
  }
}

// Row sources of a gather-GEMM block that owns BM output rows from row0.
// tile(sm, k, row0) returns the BM source rows of offset k (-1 = none), in
// the shared memory `sm` of kSmem ints, or nullptr when none of them
// matches, block-wide, so the whole block skips the offset together.  Every
// thread of the block calls it with the same k, for k = 0, 1, ..., kv - 1.
// fill(sm, k0, gk, row0) writes the source rows of the gk offsets from k0
// at once, sm[kk * BM + r] for offset k0 + kk, with no barrier: the
// pipelined forward kernels (B2, B7) stage a group of offsets' rows ahead
// of their gathers (stage_group).

// The rows from a cached match table pos [kv, n].
template <int BM>
struct TableTile {
  static constexpr int kSmem = BM;
  const int* pos;
  int n;

  // The table's rows are copied with 4-byte cp.async, so that all of a
  // thread's table reads are in flight at once.  It waits for all of the
  // thread's cp.async groups (B2 and B7 call it with none in flight).
  __device__ __forceinline__ void fill(int* sm, int k0, int gk,
                                       int row0) const {
    for (int e = threadIdx.x; e < gk * BM; e += blockDim.x) {
      const int r = row0 + e % BM;
      if (r < n) {
        sm90::cp_async4(sm + e,
                        pos + static_cast<size_t>(k0 + e / BM) * n + r);
      } else {
        sm[e] = -1;
      }
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  }

  __device__ __forceinline__ const int* tile(int* sm, int k,
                                             int row0) const {
    int p = -1;
    if (threadIdx.x < BM) {
      const int r = row0 + threadIdx.x;
      if (r < n) p = pos[static_cast<size_t>(k) * n + r];
      sm[threadIdx.x] = p;
    }
    return __syncthreads_or(p >= 0) ? sm : nullptr;
  }
};

// Offsets searched at once: 32 x BM rows x 4 B (8 KB at BM = 64, 16 KB at
// B2's BM = 128) of shared memory.  A 3^3 kernel is one group, 5^3 four,
// 7^3 eleven.
constexpr int kSearchGroup = 32;

// The rows from an in-block search: at the first offset of each group of
// kSearchGroup offsets, the block searches every (offset, row) probe of
// the group at once, offset-major, so neighbouring threads search for
// neighbouring keys, and flags the offsets that match anywhere in the
// tile.  The searches are repeated by every column tile of the same rows
// (one at B2's full-width tiles, K / 64 in the wgrad and int8 kernels).
template <int BM>
struct SearchTile {
  static constexpr int kSmem = kSearchGroup * BM + kSearchGroup;
  const int* keys;
  int n;
  int kv;
  SubmGeom g;
  int sentinel;
  int reverse;

  // hit (or nullptr): flags, set to 1 for each offset kk that matches
  __device__ __forceinline__ void fill(int* sm, int k0, int gk, int row0,
                                       int* hit = nullptr) const {
    for (int e = threadIdx.x; e < gk * BM; e += blockDim.x) {
      const int r = row0 + e % BM;
      const int p = r < n ? subm_probe(keys, n, __ldg(keys + r),
                                       k0 + e / BM, g, sentinel,
                                       reverse != 0)
                          : -1;
      sm[e] = p;
      if (hit != nullptr && p >= 0) hit[e / BM] = 1;
    }
  }

  __device__ __forceinline__ const int* tile(int* sm, int k,
                                             int row0) const {
    int* hit = sm + kSearchGroup * BM;
    const int kk = k % kSearchGroup;
    if (kk == 0) {
      __syncthreads();  // the previous group's rows and flags are read
      if (threadIdx.x < kSearchGroup) hit[threadIdx.x] = 0;
      __syncthreads();
      fill(sm, k, min(kSearchGroup, kv - k), row0, hit);
      __syncthreads();
    }
    return hit[kk] ? sm + kk * BM : nullptr;
  }
};

// The two row sources' launch arguments, made into the Src of a tile's BM.
struct TableArgs {
  const int* pos;
  int n;
  template <int BM>
  TableTile<BM> make() const {
    return {pos, n};
  }
};

struct SearchArgs {
  const int* keys;
  int n;
  int kv;
  SubmGeom g;
  int sentinel;
  int reverse;
  template <int BM>
  SearchTile<BM> make() const {
    return {keys, n, kv, g, sentinel, reverse};
  }
};

// Stages the block's rows of the gk (<= kSearchGroup) offsets from k0:
// rows[kk * BM + r] (src.fill), live[kk] with bit j set where some row of
// the block's j-th 16 matches at offset k0 + kk, and the offsets that match
// anywhere in the block, ascending, in list.  Returns their count.  Every
// thread of the block calls it; it begins and ends with a barrier, so the
// previous group's rows and lists may still be read up to the call.
template <int BM, class Src>
__device__ __forceinline__ int stage_group(const Src& src, int* rows,
                                           unsigned* live, int* list,
                                           int* count, int k0, int gk,
                                           int row0) {
  static_assert(BM % 32 == 0 && BM / 16 <= 32,
                "one live bit per 16 rows, two per warp ballot");
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();  // the previous group's rows and lists are read
  src.fill(rows, k0, gk, row0);
  __syncthreads();
  for (int kk = warp; kk < gk; kk += blockDim.x / 32) {
    unsigned bits = 0u;
#pragma unroll
    for (int j = 0; j < BM / 32; ++j) {
      const unsigned b =
          __ballot_sync(0xffffffffu, rows[kk * BM + j * 32 + lane] >= 0);
      bits |= ((b & 0xffffu) != 0u ? 1u : 0u) << (2 * j);
      bits |= ((b >> 16) != 0u ? 1u : 0u) << (2 * j + 1);
    }
    if (lane == 0) live[kk] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned bits = lane < gk ? live[lane] : 0u;
    const unsigned any = __ballot_sync(0xffffffffu, bits != 0u);
    if (bits != 0u) list[__popc(any & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *count = __popc(any);
  }
  __syncthreads();
  return *count;
}

}  // namespace dg
