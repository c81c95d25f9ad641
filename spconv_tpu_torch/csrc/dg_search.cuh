// The subm probe of the search-mode gather-GEMMs (dg_fwd.cu, dg_wgrad.cu,
// dg_fwd_q.cu), the two row sources of a gather-GEMM's output tile (a
// cached match table, or an in-block search of the same rows), the staging
// of a group of offsets' rows that the pipelined forward kernels (B2, B7)
// share, and the windowed table search (WindowRows, at the end) that B1
// (dg_pos.cu) and B6's child search (sk_pool.cu) share.
//
// The search row sources replace the search mode (posmode=False, shift
// probes) of spconv_tpu/ops/pallas/dg_conv.py::_dg_fwd_kernel (:339,
// launched at :1020 and :1152) and ::_dg_bwd_kernel (:1307, launched at
// :1598).  The TPU kernel streams DMA'd windows of the sorted keys and
// binary-searches key(i) + delta_k in them inside the GEMM, building no
// table.  Here each block searches the whole key array (about 0.5 MB at
// 126k rows, resident in L2) for its own rows before it
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


// ---------------------------------------------------------------------------
// The windowed table search of B1 (dg_pos.cu) and B6 (sk_pool.cu).
//
// A table maps each row of one sorted key set (the rows) at each kernel
// offset k (row-major over the kernel dims) to the row of another sorted
// key set (the table keys) whose key is the row's key moved by k, or -1.
// Per axis, with x the row's coordinate (decoded with row_dims) and ka the
// offset's index on that axis:
//   affine: c = x * stride + ka * dil - pad, valid where 0 <= c < tab_dims;
//   divide: t = x - (ka * dil - pad), valid where t >= 0, t % stride == 0
//           and c = t / stride < tab_dims;
// and the moved key is b * vol(tab_dims) + lin(c), b the row's batch.  A
// subm stage's table is the affine map with stride 1 and pad = (ksize / 2)
// * dil on its own keys, the reversed table the divide map with the same
// numbers; a regular conv's is the affine map (output rows, input keys),
// its inverse the divide map (input rows, output keys), and B6's children
// the affine map with ksize 2, stride 2, dil 1, pad 0.
//
// The offsets fall into groups (fixed indices on every axis but the last
// two) and, in a group, into lines (one index on the second-last axis,
// every index on the last).  A block owns a tile of consecutive rows.  For
// one offset the valid moved keys of the tile rise strictly with the row
// (each axis map is strictly monotone and the key is lexicographic, batch
// first), so every match of a group lies between the least and the largest
// valid moved key of the tile over the group.  The block reduces those
// two, finds their lower bounds in the table keys with one warp each (128
// keys a step) and stages the keys between, the group's window, in a pool
// of shared memory that the pass's windows share, whole in group order
// while they fit.  The windows that do not fit share what is left, each
// as every s-th key: a search there brackets the key between two samples
// and ends with ~log2(s) loads of the window in global memory (the same
// answer).  Where what is left holds fewer keys than those windows, none
// is sampled and their searches run in global memory from the start.  A
// table short enough is staged whole once, as every group's window.  Then each (row, line) is one walk: a
// lower bound of its first valid moved key in the window (log2 of the
// window's length in shared-memory steps), then a forward scan to each next
// one, which the affine map moves up by dil and the divide map (walked
// from the last index down) by dil / stride: with distinct keys at most
// that many rows further on.  With the table keys the rows' own (subm), the
// line through the centre offset holds the row's own key, at its own row,
// and its first search is narrowed to the rows just below it.  In divide
// mode with stride > 1 most offsets of a row do not divide; the tile's
// rows are walked in order of their residues (x + pad) mod stride, on
// which divisibility depends, so the lanes of a warp mostly share which
// lines and offsets they walk.
//
// A warp walks one line of 32 consecutive walk slots.  The results go to
// global memory, pos[k * n_rows + i], where the slots are the rows in
// order (each store a warp's 32 consecutive ints), else to shared memory,
// out(sm)[kk * tile + r] for the pass's kk-th offset, for the caller.
// Every thread of the block calls load_rows, then search once per pass
// over a run of groups; both end with a barrier.
// ---------------------------------------------------------------------------

// The geometry of a windowed table (see above).
struct WinGeom {
  int ndim;
  int row_dims[kMaxNdim];
  int tab_dims[kMaxNdim];
  int stride[kMaxNdim];
  int ksize[kMaxNdim];
  int dil[kMaxNdim];
  int pad[kMaxNdim];
  int shift[kMaxNdim];  // log2(stride) for a power of two, else -1
};

// log2(s) for a power of two s, else -1.
inline int stride_shift(int s) {
  int k = 0;
  while ((1 << k) < s) ++k;
  return (1 << k) == s ? k : -1;
}

// geom (host memory): ndim, row_dims[4], tab_dims[4], stride[4], ksize[4],
// dilation[4], padding[4].
inline WinGeom win_geom(const int* geom) {
  WinGeom g;
  g.ndim = geom[0];
  for (int a = 0; a < kMaxNdim; ++a) {
    g.row_dims[a] = geom[1 + a];
    g.tab_dims[a] = geom[1 + kMaxNdim + a];
    g.stride[a] = geom[1 + 2 * kMaxNdim + a];
    g.ksize[a] = geom[1 + 3 * kMaxNdim + a];
    g.dil[a] = geom[1 + 4 * kMaxNdim + a];
    g.pad[a] = geom[1 + 5 * kMaxNdim + a];
    g.shift[a] = stride_shift(g.stride[a]);
  }
  return g;
}

// On axis a at kernel index ka, the coordinate c that x moves to (the
// affine map, or with kDivide the divide map); false where it leaves the
// table's grid or does not divide.
template <bool kDivide>
__device__ __forceinline__ bool win_axis(const WinGeom& g, int a, int x,
                                         int ka, int* c) {
  if (kDivide) {
    const int t = x - (ka * g.dil[a] - g.pad[a]);
    // t >= 0 is checked first: C's % and / truncate toward zero
    if (t < 0) return false;
    if (g.shift[a] >= 0) {
      if (t & (g.stride[a] - 1)) return false;
      *c = t >> g.shift[a];
    } else {
      if (t % g.stride[a] != 0) return false;
      *c = t / g.stride[a];
    }
  } else {
    *c = x * g.stride[a] + ka * g.dil[a] - g.pad[a];
    if (*c < 0) return false;
  }
  return *c < g.tab_dims[a];
}

// Residue classes the divide mode sorts a tile's rows by, at most.
constexpr int kWinClasses = 64;

// The first index of keys[0, n) whose key is >= v (n if none), found by
// one warp, every lane of which calls it with the same n and v: each step
// reads 128 keys spread over the remaining range, four loads a lane in
// flight, so ~log128(n) dependent steps (3 at 126k keys).
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys,
                                                int n, int v) {
  const int lane = threadIdx.x % 32;
  int lo = 0;
  int hi = n;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int step = (hi - lo + 127) / 128;
    bool less[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = lo + (4 * lane + u) * step;
      less[u] = idx < hi && __ldg(keys + idx) < v;
    }
    int c = 0;  // the probes below v are a prefix of the 128
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c += __popc(__ballot_sync(0xffffffffu, less[u]));
    }
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + c * step);
      lo += (c - 1) * step + 1;
    }
  }
  return lo;
}

// The first index of base[a, a + n) whose key is >= q (a + n if none): a
// branch-free lower bound whose steps depend on n alone.
__device__ __forceinline__ int window_lower_bound(const int* base, int a,
                                                  int n, int q) {
  if (n == 0) return a;
  while (n > 1) {
    const int half = n >> 1;
    a = base[a + half] < q ? a + half : a;
    n -= half;
  }
  return a + (base[a] < q ? 1 : 0);
}

template <int NDIM, bool kDivide>
struct WindowRows {
  static_assert(NDIM >= 1 && NDIM <= kMaxNdim, "ndim 1-4");
  static constexpr int kLast = NDIM - 1;                  // the walked axis
  static constexpr int kLine = NDIM >= 2 ? NDIM - 2 : 0;  // lines' axis
  const int* rows;  // the rows' sorted keys, sentinel tail
  int n_rows;
  const int* tab;   // the sorted keys searched
  int n_tab;
  WinGeom g;
  int row_sent;     // a row with this key matches nothing
  int self;         // tab is rows (a subm stage)
  int sort;         // walk the rows by residue class (divide, stride > 1)
  int tile;         // rows a block owns; divides blockDim.x
  int gpp;          // groups a pass holds
  int pool;         // keys the pass's windows share in shared memory
  int* pos;         // [kv, n_rows] results, or nullptr: out(sm) (so with sort)

  __device__ __forceinline__ int klast() const { return g.ksize[kLast]; }
  __device__ __forceinline__ int kline() const {
    return NDIM >= 2 ? g.ksize[kLine] : 1;
  }
  __device__ __forceinline__ int groups() const {
    int n = 1;
#pragma unroll
    for (int a = 0; a + 2 < NDIM; ++a) n *= g.ksize[a];
    return n;
  }

  // shared memory, in ints: key[tile] | batch[tile] | perm[tile] |
  // coord[NDIM][tile] | span lo[tile], hi[tile] | class counts
  // [kWinClasses + 1] | gmin (then the window's place in the pool), gmax
  // (then its step: 1 whole, else sampled), lo, hi [gpp each] |
  // lead[gpp][tile] | pool |
  // out[gpp * kline * klast][tile] (without pos)
  template <class P>  // int* or const int*
  __device__ __forceinline__ P crd(P sm) const {
    return sm + 3 * tile;
  }
  template <class P>
  __device__ __forceinline__ P span(P sm) const {
    return crd(sm) + NDIM * tile;
  }
  template <class P>
  __device__ __forceinline__ P lohi(P sm) const {
    return span(sm) + 2 * tile + kWinClasses + 1;
  }
  template <class P>
  __device__ __forceinline__ P lead(P sm) const {
    return lohi(sm) + 4 * gpp;
  }
  template <class P>
  __device__ __forceinline__ P windows(P sm) const {
    return lead(sm) + gpp * tile;
  }
  template <class P>
  __device__ __forceinline__ P out(P sm) const {
    return windows(sm) + pool;
  }

  __device__ __forceinline__ bool axis(int a, int x, int ka, int* c) const {
    return win_axis<kDivide>(g, a, x, ka, c);
  }

  // The least and largest valid coordinate on axis a over every kernel
  // index; false where none is valid.
  __device__ __forceinline__ bool axis_range(int a, int x, int& lo_c,
                                             int& hi_c) const {
    bool any = false;
    for (int ka = 0; ka < g.ksize[a]; ++ka) {
      int c;
      if (axis(a, x, ka, &c)) {
        lo_c = any ? min(lo_c, c) : c;
        hi_c = any ? max(hi_c, c) : c;
        any = true;
      }
    }
    return any;
  }

  // Copies src[0, len) to the shared dst, eight loads a thread in flight.
  __device__ __forceinline__ static void stage(int* dst, const int* src,
                                               int len) {
    const int nt = blockDim.x;
    for (int j0 = threadIdx.x; j0 < len; j0 += 8 * nt) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = j0 + u * nt < len ? __ldg(src + j0 + u * nt) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u * nt < len) dst[j0 + u * nt] = v[u];
      }
    }
  }

  // Copies every step-th key of src[0, len), ceil(len / step) of them,
  // to the shared dst.
  __device__ __forceinline__ static void stage_sample(int* dst,
                                                      const int* src,
                                                      int len, int step) {
    const int nt = blockDim.x;
    const int n = (len + step - 1) / step;
    for (int j0 = threadIdx.x; j0 < n; j0 += 8 * nt) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = j0 + u * nt < n ? __ldg(src + (j0 + u * nt) * step) : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u * nt < n) dst[j0 + u * nt] = v[u];
      }
    }
  }

  // A table short enough to stage whole (two rounds of loads a thread)
  // is every group's window: no bounds are searched.
  __device__ __forceinline__ bool whole() const {
    return n_tab <= pool && n_tab <= 16 * static_cast<int>(blockDim.x);
  }

  // Stages, for rows row0 .. row0 + tile (rows past n_rows take the
  // sentinel), their keys, batches, coordinates, the span of moved keys
  // their last two axes reach within a plane of the table's grid (span hi
  // -1: none, or a sentinel row) and their walk order: with sort by
  // residue class (sentinel rows last), else as they are; and a short
  // table whole (whole()).  Ends with a barrier.
  __device__ void load_rows(int* sm, int row0) const {
    if (whole()) stage(windows(sm), tab, n_tab);
    int* key = sm;
    int* bat = key + tile;
    int* perm = bat + tile;
    int* cr = crd(sm);
    int* sp = span(sm);
    int* cls = sp + 2 * tile;
    for (int r = threadIdx.x; r < tile; r += blockDim.x) {
      const int i = row0 + r;
      const int k = i < n_rows ? __ldg(rows + i) : row_sent;
      int rem = k;
      int x_last = 0, x_line = 0;
#pragma unroll
      for (int a = NDIM - 1; a >= 0; --a) {
        const int x = rem % g.row_dims[a];
        rem /= g.row_dims[a];
        cr[a * tile + r] = x;
        if (a == kLast) x_last = x;
        if (a == kLine) x_line = x;
      }
      int lo_m = 0, hi_m = 0, lo_l = 0, hi_l = 0;
      bool ok = k != row_sent && axis_range(kLast, x_last, lo_m, hi_m);
      if (NDIM >= 2) ok = ok && axis_range(kLine, x_line, lo_l, hi_l);
      const int dm = g.tab_dims[kLast];
      sp[r] = lo_l * dm + lo_m;
      sp[tile + r] = ok ? hi_l * dm + hi_m : -1;
      key[r] = k;
      bat[r] = rem;
      perm[r] = r;
    }
    if (!kDivide || !sort) {
      __syncthreads();
      return;
    }
    // a counting sort, one row a thread
    for (int j = threadIdx.x; j <= kWinClasses; j += blockDim.x) cls[j] = 0;
    __syncthreads();
    int c = kWinClasses;
    int rank = 0;
    const int r = threadIdx.x;
    if (r < tile) {
      if (key[r] != row_sent) {
        c = 0;
#pragma unroll
        for (int a = 0; a < NDIM; ++a) {
          c = c * g.stride[a] + (cr[a * tile + r] + g.pad[a]) % g.stride[a];
        }
      }
      rank = atomicAdd(cls + c, 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
#pragma unroll 1
      for (int j = 0; j <= kWinClasses; ++j) {
        const int cnt = cls[j];
        cls[j] = sum;
        sum += cnt;
      }
    }
    __syncthreads();
    if (r < tile) perm[cls[c] + rank] = r;
    __syncthreads();
  }

  // The moved key of staged row r's batch and group gi's leading axes
  // (all but the last two), before the last two axes' part; -1 where an
  // axis leaves the grid or r has no valid span.
  __device__ __forceinline__ int lead_key(const int* sm, int gi,
                                          int r) const {
    if (span(sm)[tile + r] < 0) return -1;
    const int* cr = crd(sm);
    int key = 0;
    int vol = 1;
#pragma unroll
    for (int a = NDIM - 3; a >= 0; --a) {
      // gi < ksize[0] once the later axes are divided out
      const int ka = a == 0 ? gi : gi % g.ksize[a];
      if (a > 0) gi /= g.ksize[a];
      int c = 0;
      if (!axis(a, cr[a * tile + r], ka, &c)) return -1;
      key += c * vol;
      vol *= g.tab_dims[a];
    }
    return sm[tile + r] * vol + key;
  }

  // The table rows of one (row, line) walk's klast offsets, searched in
  // base[0, len) (lo + the index of a match), to o[0], o[os], ...: x is
  // the row's last coordinate, prefix the moved key before it.  sample:
  // every step-th key of base (step > 1), else null.
  __device__ __forceinline__ void walk_in(const int* base, int len, int lo,
                                          const int* sample, int step,
                                          int prefix, int x, int key,
                                          int own, bool centre, int* o,
                                          size_t os) const {
    const int kl = klast();
    // in ascending moved keys: the affine map rises with the index, the
    // divide map falls
    if (kDivide) o += (kl - 1) * os;
    int p = -1;
    for (int mm = 0; mm < kl; ++mm) {
      const int m = kDivide ? kl - 1 - mm : mm;
      int c;
      int res = -1;
      if (axis(kLast, x, m, &c)) {
        const int q = prefix + c;
        if (p < 0) {
          int a = 0;
          int n = len;
          bool narrowed = false;
          if (self && centre) {
            // the row's own key is at its own row, own in the window, and
            // with distinct keys q's row is at most key - q below it
            a = max(0, own - (key - q));
            narrowed = a == 0 || base[a - 1] < q;
            n = narrowed ? own - a + 1 : len;
            a = narrowed ? a : 0;
          }
          if (!narrowed && sample != nullptr) {
            // the sample's lower bound i brackets q's: past the (i-1)-th
            // sampled key, at most at the i-th
            const int i = window_lower_bound(sample, 0,
                                             (len + step - 1) / step, q);
            a = i > 0 ? (i - 1) * step + 1 : 0;
            n = min(i * step, len) - a;
          }
          p = window_lower_bound(base, a, n, q);
        } else {
          while (p < len && base[p] < q) ++p;
        }
        if (p < len && base[p] == q) res = lo + p;
      }
      *o = res;
      if (kDivide) {
        o -= os;
      } else {
        o += os;
      }
    }
  }

  // One (row, line) walk of pass group gi: writes the table rows of the
  // line's klast offsets to o[0], o[os], ...  A window staged whole is
  // searched in shared memory, any other in global memory (bracketed
  // first by its sample where it has one).
  __device__ __forceinline__ void walk(int* sm, int gi, int l, int r,
                                       bool centre, int row0, int* o,
                                       size_t os) const {
    const int ld = lead(sm)[gi * tile + r];
    const int* cr = crd(sm);
    int c_l = 0;
    if (ld < 0 ||
        (NDIM >= 2 && !axis(kLine, cr[kLine * tile + r], l, &c_l))) {
      for (int m = 0; m < klast(); ++m, o += os) *o = -1;
      return;
    }
    const int prefix =
        (NDIM >= 2 ? ld * g.tab_dims[kLine] + c_l : ld) * g.tab_dims[kLast];
    const int* lh = lohi(sm);
    const int at = lh[gi];
    // 1: staged whole; 0: not staged; else sampled, every step-th key
    const int step = lh[gpp + gi];
    const int lo = lh[2 * gpp + gi];
    const int len = lh[3 * gpp + gi] - lo;
    const int x = cr[kLast * tile + r];
    const int own = row0 + r - lo;
    walk_in(step == 1 ? windows(sm) + at : tab + lo, len, lo,
            step > 1 ? windows(sm) + at : nullptr, step, prefix, x, sm[r],
            own, centre, o, os);
  }

  // The table rows of groups g0 .. g0 + gc (gc <= gpp) for the staged
  // rows.  Returns the number of the pass's windows that did not fit in
  // the pool whole (sampled or not staged; their searches end in global
  // memory).  It begins by writing the pass's leading keys and bounds,
  // which a previous pass read before its last barrier, and ends with a
  // barrier.
  __device__ int search(int* sm, int g0, int gc, int row0) const {
    int* lh = lohi(sm);
    int* gmin = lh;
    int* gmax = lh + gpp;
    int* lo = lh + 2 * gpp;
    int* hi = lh + 3 * gpp;
    int* ld = lead(sm);
    const int* sp = span(sm);
    const int nt = blockDim.x;
    const bool whole_tab = whole();
    int plane = g.tab_dims[kLast];
    if (NDIM >= 2) plane *= g.tab_dims[kLine];
    for (int j = threadIdx.x; j < gc; j += nt) {
      gmin[j] = 0x7fffffff;
      gmax[j] = -1;
    }
    __syncthreads();
    // each (group, row)'s leading key, and each group's least and largest
    // moved key: a warp's 32 items are of one group where tile is a
    // multiple of 32 (one atomic a warp), else one atomic an item
    const bool by_warp = tile % 32 == 0;
    for (int e = threadIdx.x; e < gc * tile; e += nt) {
      const int gi = e / tile;
      const int r = e - gi * tile;
      const int k = lead_key(sm, g0 + gi, r);
      ld[e] = k;
      if (whole_tab) continue;
      int kmin = k < 0 ? 0x7fffffff : k * plane + sp[r];
      int kmax = k < 0 ? -1 : k * plane + sp[tile + r];
      if (by_warp) {
        kmin = __reduce_min_sync(0xffffffffu, kmin);
        kmax = __reduce_max_sync(0xffffffffu, kmax);
      }
      if (kmin <= kmax && (!by_warp || threadIdx.x % 32 == 0)) {
        atomicMin(gmin + gi, kmin);
        atomicMax(gmax + gi, kmax);
      }
    }
    __syncthreads();
    int fell_back = 0;
    if (whole_tab) {
      // the whole table, staged by load_rows, is every group's window
      for (int j = threadIdx.x; j < gc; j += nt) {
        gmin[j] = 0;
        gmax[j] = 1;
        lo[j] = 0;
        hi[j] = n_tab;
      }
    } else {
      const int warp = threadIdx.x / 32;
      for (int b = warp; b < 2 * gc; b += nt / 32) {
        const int gi = b / 2;
        const bool empty = gmin[gi] > gmax[gi];
        const int v = b % 2 ? gmax[gi] + 1 : gmin[gi];
        const int at = empty ? 0 : warp_lower_bound(tab, n_tab, v);
        if (threadIdx.x % 32 == 0) (b % 2 ? hi : lo)[gi] = at;
      }
      __syncthreads();
      // the windows' places in the pool: whole, in group order, while
      // they fit; the others share what is left, each as every step-th
      // key, where that leaves each at least one key, else none is staged
      // (step 0).  A window that did not fit is longer than what is left,
      // so its step is >= 2 and its ceil(len / step) <= share keys stay
      // inside the pool.  Every thread finds the places; thread 0 keeps
      // them in gmin and the steps in gmax, read after the barrier.
      int used = 0;
      for (int gi = 0; gi < gc; ++gi) {
        const int len = hi[gi] - lo[gi];
        if (len <= pool - used) {
          used += len;
        } else {
          ++fell_back;
        }
      }
      const int share = fell_back ? (pool - used) / fell_back : 0;
      int whole_at = 0;
      int sample_at = used;
      for (int gi = 0; gi < gc; ++gi) {
        const int len = hi[gi] - lo[gi];
        const bool fits = len <= pool - whole_at;
        const int step = fits ? 1 : share ? (len + share - 1) / share : 0;
        const int at = fits ? whole_at : sample_at;
        if (threadIdx.x == 0) {
          gmin[gi] = at;
          gmax[gi] = step;
        }
        if (fits) {
          stage(windows(sm) + at, tab + lo[gi], len);
          whole_at += len;
        } else if (step) {
          stage_sample(windows(sm) + at, tab + lo[gi], len, step);
          sample_at += (len + step - 1) / step;
        }
      }
    }
    __syncthreads();
    // the walks: a thread keeps one row (slot) and steps over the pass's
    // lines; with distinct keys the centre line's first search starts at
    // the row itself
    const int kl = klast();
    const int lines = kline();
    int cg = 0;  // the centre group
#pragma unroll
    for (int a = 0; a + 2 < NDIM; ++a) cg = cg * g.ksize[a] + g.ksize[a] / 2;
    const int slot = threadIdx.x % tile;
    const int r = sm[2 * tile + slot];  // perm
    const int dli = nt / tile;
    int li = threadIdx.x / tile;
    int gi = li / lines;
    int l = li - gi * lines;
    const bool stored = pos == nullptr || r < n_rows - row0;
    for (; li < gc * lines; li += dli) {
      const bool centre = g0 + gi == cg && l == lines / 2;
      if (pos == nullptr) {
        walk(sm, gi, l, r, centre, row0, out(sm) + li * kl * tile + r,
             tile);
      } else if (stored) {
        const size_t k = static_cast<size_t>(g0 * lines + li) * kl;
        walk(sm, gi, l, r, centre, row0, pos + k * n_rows + row0 + r,
             static_cast<size_t>(n_rows));
      }
      l += dli;
      while (l >= lines) {
        l -= lines;
        ++gi;
      }
    }
    __syncthreads();
    return fell_back;
  }
};

}  // namespace dg
