// B9: the probe kernels of the JAX package's tools/ scripts, on Hopper.
//
// Replaces: the 16 fixed-shape Pallas kernels of tools/probe_int8.py,
//   tools/probe_dg.py, tools/probe_cast.py and tools/probe_dma_align.py.
//   Those probed what Mosaic could lower (DMA row starts, lane gathers,
//   one-hot joins, MXU products); they compute only seven functions, so
//   here they are four kernel families, templated on the element type:
//   - copy: `probe_copy_launch` (probe_int8.py::probe_dma.kern,
//     probe_dma_align.py::make.kern, probe_dg.py::kd): rows of a table from
//     a start row read on the device (the scalar prefetch's role), widened
//     int8 -> int32 in the int8 probe; `probe_transpose_launch`
//     (probe_dg.py::kt): a transpose of 4 x 4 blocks in registers.
//   - gather: `probe_gather_launch` (probe_dg.py::k, ::ki): out[r, l] =
//     x[r, idx[r, l]] (f32 or int32); `probe_broadcast_launch` (::ks): a
//     row broadcast times a scale.
//   - search: `probe_join_launch` (probe_int8.py::probe_matmul.kern,
//     probe_cast.py::k_2d, k_3d, k_2d_bcast): the one-hot join
//     out[t] = sum_w [probe[t] == keys[w]] * table[w], as an equal-range
//     search in the sorted keys and a sum of the matched rows in
//     ascending w (int8 -> int32 or f32); `probe_rank_launch`
//     (probe_dg.py::kr): the count of keys below each row's first lane,
//     broadcast over the row.
//   - gemm: `probe_gemm_launch` (probe_int8.py::probe_plain_matmul.kern,
//     probe_dg.py::kg): a dense product on the tensor cores, s8 x s8 -> s32
//     (mma.sync m16n8k32, as B7 multiplies) and f32 inputs rounded to bf16
//     (nearest even) -> f32 sums (mma.sync m16n8k16, as B2 multiplies).
//
// Bound on the H100: every probe moves a few KB to a few hundred KB and
//   does at most ~14 MFLOP, so on the card each is bound by the launch and
//   one trip to memory (a few microseconds), not by bytes or operations.
//
// The rank (host plan ops/probes.py::rank_plan; a few KB at the probe's
//   shape, bound by the launch and one trip to memory) gives a warp to each
//   row and several rows to a block: lane 0 loads the row's probe and a
//   shuffle hands it to the warp, while the warp reads the keys once,
//   coalesced, 16 bytes a lane; each lane counts its keys below the probe
//   and the warp adds the counts (past 1,024 keys: the join's ballot lower
//   bound in global memory instead).  The warp then writes the row with
//   16-byte stores, the elements before and after its 16-byte body one a
//   lane.  (The parent gave each row a block of 128 threads whose thread 0
//   ran a serial binary search in global memory while the others waited
//   at a barrier, then wrote the row 4 bytes a thread.)
//
// The join and the gathers (a few KB at the probes' shapes) are bound by
//   the launch and their chains of dependent trips, so their design is
//   about latency.  The join (host plan ops/probes.py::join_plan) gives a
//   warp to each probe and several probes to a block.  Up to 1,024 keys
//   the warp loads them all into registers, 32 a lane, with its probe's
//   load, and counts the keys below and at the probe across the warp: no
//   search, no shared memory, no barrier.  Past that each warp finds its
//   probe's equal range in global memory with ballots (32-fold a step).
//   Each lane then loads up to 8 matched rows at once and sums them in
//   ascending order, 16 output bytes a lane.  The lane gather (gather_plan)
//   gives a warp to each output row: the row's loads and the indices' are
//   issued together, and the row is read from the warp's own slice of
//   shared memory behind a __syncwarp, with no block barrier.  The row
//   broadcast stages nothing: a lane loads its 16 bytes of the row once
//   and stores them, scaled, to each of its rows.
//
// The copies (8-32 KB at the probes' shapes) and the transpose (64 KB each
//   way) are bound by the launch and one or two dependent trips to L2, so
//   their design is about latency: each thread makes one round of 16-byte
//   accesses on both sides with nothing between them, on the host plans'
//   grids (ops/probes.py::copy_plan, transpose_plan): the copy on blocks
//   of 256 threads (on the H100 smaller blocks, hence more of them, are no
//   faster), the transpose on at least a third of the SMs.  The copy reads
//   its start through the read-only path before anything else, since every
//   row load waits on it (the device read is the function: the Pallas
//   probes' scalar prefetch); int8 -> int32 reads 4 bytes and writes 16 a
//   thread.
//   The transpose moves a 4 x 4 block a thread in registers: no shared
//   memory and no barrier.  A width, shape or pointer that 16-byte
//   accesses do not fit takes a one-element path, masked at the edges.
//
// The GEMMs: at the probes' shapes (bf16 [128 x 432] @ [432 x 128], 14.2
//   MFLOP; s8 [128 x 256] @ [256 x 128], 8.4 MOP) the bytes take 0.15 and
//   0.04 us and the tensor cores less, so each is bound by the launch and
//   one trip to memory; wgmma and TMA would add set-up and no speed at this
//   size.  The host plan (ops/probes.py::gemm_plan) picks an output tile
//   small enough for a grid of at least a third of the SMs (16 x 16 at
//   128 x 128: 64 blocks, against 4 of 64 x 64) and splits K over up to
//   8 warps of a block, so that each warp issues every load of its K
//   slice before its first MMA: s8 by 16-byte cp.async, f32 by 16-byte
//   register loads rounded to bf16 on their way into shared memory
//   (cp.async cannot convert, and staging f32 first would add a pass
//   through shared memory).  A and bf16 B fragments come from ldmatrix
//   (.trans for B's [K, N] rows); s8 B rows are turned into K-contiguous
//   columns by 4 x 4-byte permutes, since ldmatrix.trans moves 16-bit
//   elements only.  The warps' partial tiles are added in shared memory
//   in warp order (repeated runs bit-equal) and stored from registers, 16
//   bytes a thread.  Ragged M, N and K are zero-filled (cp.async with 0
//   source bytes, or masked loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "sm90_mma.cuh"

namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// ---------------------------------------------------------------------------
// copy: out[r, :] = x[start[0] * scale + off + r, :] for r < rows, widened
// to Tout; rows outside [0, n) of x give 0.  A thread writes V elements at
// once: one 16-byte vector of out (int8 -> int32: 4 bytes in, 16 out), or
// one element on the one-element path (V = 1).  Block (tx, ty): ty rows
// of out, tx threads along each (a thread steps by tx * V), so a thread's
// row and column follow from its indices with no division.
// ---------------------------------------------------------------------------

template <typename Tin, typename Tout, int V>
__global__ void copy_rows_kernel(const Tin* __restrict__ x, int n, int width,
                                 const int* __restrict__ start, int scale,
                                 int off, int rows, Tout* __restrict__ out) {
  // the start first (read-only path): every row load waits on it
  const long long s = static_cast<long long>(__ldg(start)) * scale + off;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const long long src = s + r;
  const bool ok = src >= 0 && src < n;
  const Tin* xr = x + src * width;
  Tout* o = out + static_cast<size_t>(r) * width;
  for (int c = threadIdx.x * V; c < width; c += blockDim.x * V) {
    Vec<Tout, V> v;
    if (ok) {
      const Vec<Tin, V> in = *reinterpret_cast<const Vec<Tin, V>*>(xr + c);
#pragma unroll
      for (int j = 0; j < V; ++j) v.v[j] = static_cast<Tout>(in.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v.v[j] = static_cast<Tout>(0);
    }
    *reinterpret_cast<Vec<Tout, V>*>(o + c) = v;
  }
}

template <typename Tin, typename Tout, int V>
int copy_rows(const void* x, int n, int width, const void* start, int scale,
              int off, int rows, int tx, int ty, int grid, void* out,
              cudaStream_t s) {
  if (tx < 1 || ty < 1 || tx * ty > 1024 || grid < 1 ||
      static_cast<long long>(grid) * ty < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  copy_rows_kernel<Tin, Tout, V><<<grid, dim3(tx, ty), 0, s>>>(
      static_cast<const Tin*>(x), n, width, static_cast<const int*>(start),
      scale, off, rows, static_cast<Tout*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// transpose: out [n, m] = a [m, n]^T, f32
// ---------------------------------------------------------------------------

// Thread (p, q) of block (bx, by) moves the 4 x 4 block of a at rows
// 4 * (bx * P + p), columns 4 * (by * Q + q): four rows in, a transpose in
// registers, four rows of out back, with no shared memory and no barrier.
// Lanes run along p first, so each store instruction writes P * 16
// consecutive bytes of each of its out rows, and each load reads Q * 16
// consecutive bytes of each row of a: whole 32-byte sectors both ways.
// VEC: 16-byte loads and stores (m and n multiples of 4, a and out 16-byte
// aligned); else one element at a time, masked at the edges.
template <bool VEC>
__global__ void transpose_regs_kernel(const float* __restrict__ a, int m,
                                      int n, float* __restrict__ out) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);  // rows of a
  const int j = 4 * (blockIdx.y * blockDim.y + threadIdx.y);  // columns
  if (i >= m || j >= n) return;
  float v[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* row = a + static_cast<size_t>(i + k) * n + j;
    if constexpr (VEC) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row));
      v[k][0] = t.x;
      v[k][1] = t.y;
      v[k][2] = t.z;
      v[k][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[k][e] = i + k < m && j + e < n ? __ldg(row + e) : 0.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* o = out + static_cast<size_t>(j + k) * m + i;
    if constexpr (VEC) {
      const float4 t = make_float4(v[0][k], v[1][k], v[2][k], v[3][k]);
      *reinterpret_cast<float4*>(o) = t;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + k < n && i + e < m) o[e] = v[e][k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// gather: the lane gather out[r, l] = x[r, idx[r, l]] (4-byte elements, the
// bits moved as they are; 0 for an index outside [0, width)), and the row
// broadcast out[r, :] = x[row, :] * scale (f32).  A warp per output row
// (the broadcast: rw rows a warp), rb warps a block, on the host plan's
// grid (ops/probes.py::gather_plan); width a multiple of 4, x, idx and
// out 16-byte aligned, 16 bytes a thread.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lane_at(const uint32_t* row, int width,
                                           int i) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(width) ? row[i]
                                                                : 0u;
}

// The row's loads (cp.async into the warp's own slice of shared memory,
// width elements) and the first idx vector's are issued together, before
// anything waits; the row is read there behind a __syncwarp: no block
// barrier.
__global__ void lane_gather_kernel(const uint32_t* __restrict__ x, int width,
                                   const int* __restrict__ idx, int rows,
                                   uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= rows) return;  // the whole warp
  const int w4 = width >> 2;
  const uint4* xs =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * width);
  const int4* is =
      reinterpret_cast<const int4*>(idx + static_cast<size_t>(r) * width);
  uint4* os = reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * width);
  int4 ix = lane < w4 ? __ldg(is + lane) : make_int4(0, 0, 0, 0);
  uint4* srow = reinterpret_cast<uint4*>(smem) + warp * w4;
  for (int e = lane; e < w4; e += 32) sm90::cp_async16(srow + e, xs + e, 16);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncwarp();
  const uint32_t* s = reinterpret_cast<const uint32_t*>(srow);
  for (int e = lane; e < w4; e += 32) {
    if (e != lane) ix = __ldg(is + e);
    const uint4 o = make_uint4(lane_at(s, width, ix.x),
                               lane_at(s, width, ix.y),
                               lane_at(s, width, ix.z),
                               lane_at(s, width, ix.w));
    os[e] = o;
  }
}

// Nothing staged: a lane loads its 16 bytes of x[row] once, scales them
// and stores them to each of its warp's rw rows.
__global__ void broadcast_rows_kernel(const float* __restrict__ x, int width,
                                      int row, float scale, int rows, int rw,
                                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * rw;
  const int r1 = min(r0 + rw, rows);
  const float4* xs =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * width);
  for (int e = lane; e < width >> 2; e += 32) {
    if (r0 >= r1) break;
    float4 v = __ldg(xs + e);
    v = make_float4(__fmul_rn(v.x, scale), __fmul_rn(v.y, scale),
                    __fmul_rn(v.z, scale), __fmul_rn(v.w, scale));
    for (int r = r0; r < r1; ++r) {
      reinterpret_cast<float4*>(out + static_cast<size_t>(r) * width)[e] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// search: the one-hot join and the rank, through searches of keys sorted
// ascending
// ---------------------------------------------------------------------------

// keys a join counts in registers, at most (ops/probes.py::
// JOIN_COUNT_KEYS): 32 a lane; more are searched in global memory
constexpr int kJoinCountKeys = 1024;
// matched rows a lane loads before it adds them
constexpr int kJoinBatch = 8;

// a join's searches (ops/probes.py::JOIN_SEARCHES)
enum JoinSearch {
  kWarpSearch = 0,  // the warp's ballot search: a step narrows 32-fold
  kWarpCount = 1,   // the keys counted in registers, 32 a lane, and summed
                    // across the warp: no search, no shared memory
};

// [lo, hi) = [#{keys < p}, #{keys <= p}) in keys[0, w_n), ascending, the
// same in every lane of the warp (every lane takes part).  kWarpSearch: a
// step's lane g tests the last key of the g-th of 32 sub-ranges, and the
// ballot's count narrows the range 32-fold (2 steps for 1,024 keys); both
// bounds step together.  kWarpCount: a lane compares its keys lane, lane +
// 32, ... (loaded at once, with the probe's load) and the warp adds the
// counts.  (Each lane's own binary search, by broadcast reads, was 0.2-0.3
// us slower than the ballot search at the probes' shapes on the H100:
// tools/join_gather_tiles.py.)
template <int SEARCH>
__device__ __forceinline__ int2 equal_range(const int* keys, int w_n, int p) {
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = 0;
  if constexpr (SEARCH == kWarpCount) {
    int k[kJoinCountKeys / 32];
#pragma unroll
    for (int j = 0; j < kJoinCountKeys / 32; ++j) {
      k[j] = lane + 32 * j < w_n ? __ldg(keys + lane + 32 * j) : 0;
    }
#pragma unroll
    for (int j = 0; j < kJoinCountKeys / 32; ++j) {
      const bool in = lane + 32 * j < w_n;
      lo += in && k[j] < p;
      hi += in && k[j] <= p;
    }
    lo = __reduce_add_sync(0xffffffffu, lo);
    hi = __reduce_add_sync(0xffffffffu, hi);
  } else {
    // a step of 32^l keys a lane, from the top level down
    int shift = 0;
    while (shift < 30 && (1 << (shift + 5)) < w_n) shift += 5;
    for (; shift >= 0; shift -= 5) {
      const long long i = lo + (static_cast<long long>(lane + 1) << shift);
      const long long j = hi + (static_cast<long long>(lane + 1) << shift);
      const bool a = i <= w_n && __ldg(keys + i - 1) < p;
      const bool b = j <= w_n && __ldg(keys + j - 1) <= p;
      lo += __popc(__ballot_sync(0xffffffffu, a)) << shift;
      hi += __popc(__ballot_sync(0xffffffffu, b)) << shift;
    }
  }
  return make_int2(lo, hi);
}

// The join out[t, :] = sum of table[w, :] over keys[w] == probes[t], the
// matched rows added in ascending w from 0 (the plain version's order):
// int8 -> int32 (exact) or f32.  A warp per probe, blockDim.x / 32 probes
// a block (the host plan's, ops/probes.py::join_plan), the probe's equal
// range found by SEARCH in the keys in global memory.  Then lane l sums
// its output vectors v = l, l + 32, ... (V elements: int8 reads 4 bytes
// and writes 16, f32 reads and writes 16; V = 1 where the columns or the
// table's alignment do not fit vectors), loading kJoinBatch matched rows
// before it adds them, so that a run of rows costs one trip, not one a
// row.
template <typename Tin, typename Tacc, int V, int SEARCH>
__global__ void join_kernel(const int* __restrict__ probes, int t_n,
                            const int* __restrict__ keys, int w_n,
                            const Tin* __restrict__ table, int c,
                            Tacc* __restrict__ out) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int p = t < t_n ? __ldg(probes + t) : 0;
  const int2 r = equal_range<SEARCH>(keys, w_n, p);
  if (t >= t_n) return;
  for (int v = (threadIdx.x & 31) * V; v < c; v += 32 * V) {
    Vec<Tacc, V> acc;
#pragma unroll
    for (int j = 0; j < V; ++j) acc.v[j] = 0;
    const Tin* rp = table + static_cast<size_t>(r.x) * c + v;
    for (int n = r.y - r.x; n > 0; n -= kJoinBatch) {
      Vec<Tin, V> row[kJoinBatch];
#pragma unroll
      for (int b = 0; b < kJoinBatch; ++b) {
        if (b < n) {
          row[b] = *reinterpret_cast<const Vec<Tin, V>*>(rp);
          rp += c;
        }
      }
#pragma unroll
      for (int b = 0; b < kJoinBatch; ++b) {
        if (b < n) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc.v[j] += static_cast<Tacc>(row[b].v[j]);
          }
        }
      }
    }
    Tacc* o = out + static_cast<size_t>(t) * c + v;
    *reinterpret_cast<Vec<Tacc, V>*>(o) = acc;
  }
}

// keys a rank counts whole, at most (ops/probes.py::RANK_COUNT_KEYS); more
// are searched
constexpr int kRankCountKeys = 1024;

// a rank's searches (ops/probes.py::RANK_SEARCHES)
enum RankSearch {
  kRankSearch = 0,  // the warp's ballot lower bound: a step narrows 32-fold
  kRankCount = 1,   // every key read once, 16 bytes a lane (KVEC: the keys
                    // 16-byte aligned; the last W % 4 one a lane), counted
                    // below the probe and summed across the warp
};

// The rank out[r, :] = #{w : keys[w] < probes[r, 0]}, keys ascending (the
// count needs no order; the search does).  A warp a row, blockDim.x / 32
// rows a block (the host plan's, ops/probes.py::rank_plan).  Lane 0 loads
// the row's probe and __shfl_sync hands it to the warp; the count's key
// loads do not wait on it.  The row is written from its 16-byte boundary
// on (out 16-byte aligned): `head` elements before the first boundary and
// the `tail` after the last one a lane, the body one int4 a lane
// (ops/probes.py::rank_row_split repeats the arithmetic).
template <int SEARCH, bool KVEC>
__global__ void rank_kernel(const int* __restrict__ keys, int w_n,
                            const int* __restrict__ probes, int rows,
                            int lanes, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp: a warp owns one row
  const size_t row0 = static_cast<size_t>(r) * lanes;
  int p = lane == 0 ? __ldg(probes + row0) : 0;
  int n = 0;
  if constexpr (SEARCH == kRankCount) {
    int i = 0;
    if constexpr (KVEC) {
      const int w4 = w_n >> 2;
      int4 k[kRankCountKeys / 128];
#pragma unroll
      for (int j = 0; j < kRankCountKeys / 128; ++j) {
        const int v = lane + 32 * j;
        k[j] = v < w4 ? __ldg(reinterpret_cast<const int4*>(keys) + v)
                      : make_int4(0, 0, 0, 0);
      }
      p = __shfl_sync(0xffffffffu, p, 0);
#pragma unroll
      for (int j = 0; j < kRankCountKeys / 128; ++j) {
        if (lane + 32 * j < w4) {
          n += (k[j].x < p) + (k[j].y < p) + (k[j].z < p) + (k[j].w < p);
        }
      }
      i = w4 << 2;
    } else {
      p = __shfl_sync(0xffffffffu, p, 0);
    }
    for (i += lane; i < w_n; i += 32) n += __ldg(keys + i) < p;
    n = __reduce_add_sync(0xffffffffu, n);
  } else {
    p = __shfl_sync(0xffffffffu, p, 0);
    // a step of 32^l keys a lane, from the top level down (equal_range's
    // lower half)
    int shift = 0;
    while (shift < 30 && (1 << (shift + 5)) < w_n) shift += 5;
    for (; shift >= 0; shift -= 5) {
      const long long i = n + (static_cast<long long>(lane + 1) << shift);
      const bool a = i <= w_n && __ldg(keys + i - 1) < p;
      n += __popc(__ballot_sync(0xffffffffu, a)) << shift;
    }
  }
  int* o = out + row0;
  const int head = min(lanes, static_cast<int>((4 - (row0 & 3)) & 3));
  const int body = (lanes - head) >> 2;
  const int tail0 = head + 4 * body;
  if (lane < head) o[lane] = n;
  const int4 v4 = make_int4(n, n, n, n);
  for (int v = lane; v < body; v += 32) {
    reinterpret_cast<int4*>(o + head)[v] = v4;
  }
  if (lane < lanes - tail0) o[tail0 + lane] = n;
}

// ---------------------------------------------------------------------------
// gemm: out [m, n] = a [m, k] @ b [k, n], row-major, on the tensor cores.
// A block owns a BM x BN tile of out; its warps each sum one K slice of it
// (warp w: [w * ks, min((w + 1) * ks, k)), KC at a time) into registers,
// and the block adds the warps' partials in warp order.  The host plan
// (ops/probes.py::gemm_plan) picks BM x BN, the warps, ks and KC.
// ---------------------------------------------------------------------------

constexpr int kGemmMaxWarps = 8;  // ops/probes.py::GEMM_WARPS

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::mma_bf16;
using sm90::mma_s8;

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(sm90::smem_addr(p)));
}

// The f32 tile: a round stages KC of K (the plan's: one round covers a
// warp's slice where it can) from f32 by 16-byte register loads (NA of a
// and NB of b a lane, all issued before the first is used), rounded to
// bf16 into shared memory.  Pitches are an odd number of 16 bytes, so
// ldmatrix's eight rows fall in distinct banks.
template <int BM_, int BN_, int KC_>
struct Bf16Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int MI = BM / 16;  // m16 tiles
  static constexpr int NI = BN / 8;   // n8 tiles
  static constexpr int KC = KC_;
  static constexpr int LDA = KC + 8;
  static constexpr int LDB = (BN / 8) % 2 ? BN + 16 : BN + 8;
  static constexpr int NA = BM * KC / 128;
  static constexpr int NB = KC * BN / 128;
  static constexpr int kWarpSmem = 2 * (BM * LDA + KC * LDB);
};

// The s8 tile: a round copies KC bytes of K with 16-byte cp.async (NA of a
// and NB of b a lane, all in flight at once), then turns b's rows [KC, BN]
// into bt [BN, KC] by 4 x 4-byte blocks (ldmatrix moves 16-bit elements, so
// it cannot transpose bytes), so the m16n8k32 B fragment is read from
// columns of K-contiguous bytes.
template <int BM_, int BN_, int KC_>
struct S8Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int MI = BM / 16;
  static constexpr int NI = BN / 8;
  static constexpr int KC = KC_;
  static constexpr int LDA = KC + 16;
  static constexpr int LDT = KC + 16;
  static constexpr int NA = BM * KC / 512;
  static constexpr int NB = KC * BN / 512;
  static constexpr int kWarpSmem = BM * LDA + KC * BN + BN * LDT;
};

// a block's dynamic shared memory: each warp's stage, then the warps'
// partial sums [kw][BM][BN + 4] of 4 bytes
template <class T>
constexpr int gemm_smem(int kw) {
  return kw * (T::kWarpSmem + T::BM * (T::BN + 4) * 4);
}

// f32 [c, c + 4) of a row at p; those at or past c_end, or all where
// !row_ok, are 0.  VEC: one 16-byte load (c and c_end multiples of 4).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, bool row_ok, int c,
                                        int c_end) {
  if constexpr (VEC) {
    return row_ok && c < c_end
               ? __ldg(reinterpret_cast<const float4*>(p + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = row_ok && c + j < c_end ? __ldg(p + c + j) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// four f32 rounded to nearest even bf16, stored 8 bytes at once
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Each warp's m16n8 accumulators into its partial tile, then the block's
// threads load the kw partials of 4 consecutive outputs at once and add
// them in warp order (a fixed order: repeated runs are bit-equal), and
// store them from registers, 16 bytes at once where VEC (n a multiple of
// 4).
template <class T, bool VEC, typename Acc>
__device__ __forceinline__ void reduce_store(
    Acc (&acc)[T::MI][T::NI][4], unsigned char* red_base, int m, int n,
    int row0, int col0, Acc* __restrict__ out) {
  constexpr int LDR = T::BN + 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kw = blockDim.x / 32;
  Acc* red = reinterpret_cast<Acc*>(red_base);
  Acc* mine = red + warp * T::BM * LDR;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int r = mi * 16 + lane / 4;
      const int c = ni * 8 + (lane % 4) * 2;
      mine[r * LDR + c] = acc[mi][ni][0];
      mine[r * LDR + c + 1] = acc[mi][ni][1];
      mine[(r + 8) * LDR + c] = acc[mi][ni][2];
      mine[(r + 8) * LDR + c + 1] = acc[mi][ni][3];
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < T::BM * T::BN / 4; q += blockDim.x) {
    const int r = q / (T::BN / 4);
    const int c = (q % (T::BN / 4)) * 4;
    using V = Vec<Acc, 4>;
    V p[kGemmMaxWarps];
#pragma unroll
    for (int w = 0; w < kGemmMaxWarps; ++w) {
      if (w < kw) {
        p[w] = *reinterpret_cast<const V*>(red + (w * T::BM + r) * LDR + c);
      }
    }
    V s = p[0];
#pragma unroll
    for (int w = 1; w < kGemmMaxWarps; ++w) {
      if (w < kw) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s.v[j] += p[w].v[j];
      }
    }
    const int row = row0 + r;
    const int col = col0 + c;
    if (row >= m) continue;
    Acc* o = out + static_cast<size_t>(row) * n + col;
    if constexpr (VEC) {
      if (col < n) *reinterpret_cast<V*>(o) = s;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j < n) o[j] = s.v[j];
      }
    }
  }
}

// bf16 products of f32 inputs rounded to bf16 (nearest even) while staging,
// f32 sums.  Block (x, y) owns row tile x and column tile y; VEC: k and n
// multiples of 4, a and b 16-byte aligned.
template <class T, bool VEC>
__global__ void __launch_bounds__(kGemmMaxWarps * 32)
gemm_bf16_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 int m, int k, int n, int ks, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * T::BM;
  const int col0 = blockIdx.y * T::BN;
  auto* as = reinterpret_cast<__nv_bfloat16*>(smem + warp * T::kWarpSmem);
  __nv_bfloat16* bs = as + T::BM * T::LDA;
  float acc[T::MI][T::NI][4] = {};
  const int k_end = min(k, (warp + 1) * ks);
  for (int k0 = warp * ks; k0 < k_end; k0 += T::KC) {
    float4 ra[T::NA];
    float4 rb[T::NB];
#pragma unroll
    for (int i = 0; i < T::NA; ++i) {
      const int u = lane + 32 * i;
      const int r = row0 + u / (T::KC / 4);
      ra[i] = load4<VEC>(a + static_cast<size_t>(r) * k, r < m,
                         k0 + (u % (T::KC / 4)) * 4, k_end);
    }
#pragma unroll
    for (int i = 0; i < T::NB; ++i) {
      const int u = lane + 32 * i;
      const int r = k0 + u / (T::BN / 4);
      rb[i] = load4<VEC>(b + static_cast<size_t>(r) * n, r < k_end,
                         col0 + (u % (T::BN / 4)) * 4, n);
    }
#pragma unroll
    for (int i = 0; i < T::NA; ++i) {
      const int u = lane + 32 * i;
      store_bf16x4(as + (u / (T::KC / 4)) * T::LDA + (u % (T::KC / 4)) * 4,
                   ra[i]);
    }
#pragma unroll
    for (int i = 0; i < T::NB; ++i) {
      const int u = lane + 32 * i;
      store_bf16x4(bs + (u / (T::BN / 4)) * T::LDB + (u % (T::BN / 4)) * 4,
                   rb[i]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < T::KC; kk += 16) {
      if (k0 + kk >= k_end) break;
      unsigned af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        ldsm_x4(af[mi], as + (mi * 16 + (lane & 15)) * T::LDA + kk +
                            (lane >> 4) * 8);
      }
      unsigned bfr[T::NI][2];
#pragma unroll
      for (int nj = 0; nj + 1 < T::NI; nj += 2) {
        unsigned r4[4];
        ldsm_x4_trans(r4, bs + (kk + (lane & 15)) * T::LDB + nj * 8 +
                              (lane >> 4) * 8);
        bfr[nj][0] = r4[0];
        bfr[nj][1] = r4[1];
        bfr[nj + 1][0] = r4[2];
        bfr[nj + 1][1] = r4[3];
      }
      if constexpr (T::NI % 2) {
        ldsm_x2_trans(bfr[T::NI - 1],
                      bs + (kk + (lane & 15)) * T::LDB + (T::NI - 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
        }
      }
    }
    __syncwarp();
  }
  reduce_store<T, VEC, float>(acc, smem + (blockDim.x / 32) * T::kWarpSmem,
                              m, n, row0, col0, out);
}

// the four bytes j of w0..w3 as one word, for j = 0..3: a 4 x 4-byte
// transpose
__device__ __forceinline__ void transpose4x4(unsigned (&w)[4]) {
  const unsigned lo01 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned hi01 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned lo23 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned hi23 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// s8 x s8 -> s32 (exact in any order).  VEC: k and n multiples of 16, a
// and b 16-byte aligned; else byte loads.
template <class T, bool VEC>
__global__ void __launch_bounds__(kGemmMaxWarps * 32)
gemm_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               int m, int k, int n, int ks, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * T::BM;
  const int col0 = blockIdx.y * T::BN;
  auto* as = reinterpret_cast<int8_t*>(smem + warp * T::kWarpSmem);
  int8_t* braw = as + T::BM * T::LDA;  // [KC][BN], rows of b
  int8_t* bt = braw + T::KC * T::BN;   // [BN][LDT], columns of b
  int acc[T::MI][T::NI][4] = {};
  const int k_end = min(k, (warp + 1) * ks);
  for (int k0 = warp * ks; k0 < k_end; k0 += T::KC) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < T::NA; ++i) {
        const int u = lane + 32 * i;
        const int r = u / (T::KC / 16);
        const int c = (u % (T::KC / 16)) * 16;
        const bool ok = row0 + r < m && k0 + c < k_end;
        cp_async16(as + r * T::LDA + c,
                   ok ? a + static_cast<size_t>(row0 + r) * k + k0 + c : a,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < T::NB; ++i) {
        const int u = lane + 32 * i;
        const int r = u / (T::BN / 16);
        const int c = (u % (T::BN / 16)) * 16;
        const bool ok = k0 + r < k_end && col0 + c < n;
        cp_async16(braw + r * T::BN + c,
                   ok ? b + static_cast<size_t>(k0 + r) * n + col0 + c : b,
                   ok ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int e = lane; e < T::BM * T::KC; e += 32) {
        const int r = e / T::KC;
        const int c = e % T::KC;
        as[r * T::LDA + c] = row0 + r < m && k0 + c < k_end
                                 ? a[static_cast<size_t>(row0 + r) * k + k0 + c]
                                 : 0;
      }
      for (int e = lane; e < T::KC * T::BN; e += 32) {
        const int r = e / T::BN;
        const int c = e % T::BN;
        braw[e] = k0 + r < k_end && col0 + c < n
                      ? b[static_cast<size_t>(k0 + r) * n + col0 + c]
                      : 0;
      }
    }
    __syncwarp();
    for (int e = lane; e < (T::KC / 4) * (T::BN / 4); e += 32) {
      const int kb = (e / (T::BN / 4)) * 4;
      const int nb = (e % (T::BN / 4)) * 4;
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = *reinterpret_cast<const unsigned*>(braw + (kb + j) * T::BN + nb);
      }
      transpose4x4(w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<unsigned*>(bt + (nb + j) * T::LDT + kb) = w[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < T::KC; kk += 32) {
      if (k0 + kk >= k_end) break;
      unsigned af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        ldsm_x4(af[mi], as + (mi * 16 + (lane & 15)) * T::LDA + kk +
                            (lane >> 4) * 16);
      }
      unsigned bfr[T::NI / 2][4];
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        ldsm_x4(bfr[nj], bt + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                  T::LDT + kk + ((lane >> 3) & 1) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          mma_s8(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],
                 bfr[ni / 2][(ni % 2) * 2 + 1]);
        }
      }
    }
    __syncwarp();
  }
  reduce_store<T, VEC, int>(acc, smem + (blockDim.x / 32) * T::kWarpSmem, m,
                            n, row0, col0, out);
}

// one launch of a tile's kernel on the plan's grid and warps; dynamic
// shared memory above 48 KB only by the opt-in, once per instantiation (of
// the tile and VEC), to what kGemmMaxWarps warps take
template <class T, bool VEC, typename In, typename Out, class Kern>
int launch_gemm(Kern kern, const void* a, const void* b, int m, int k, int n,
                int kw, int ks, int smem, void* out, cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           gemm_smem<T>(kGemmMaxWarps));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (kw < 1 || kw > kGemmMaxWarps || smem != gemm_smem<T>(kw) || ks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN);
  kern<<<grid, kw * 32, smem, s>>>(static_cast<const In*>(a),
                                   static_cast<const In*>(b), m, k, n, ks,
                                   static_cast<Out*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 = int8 -> int32, 1 = 2-byte elements, 2 = 4-byte elements; vec:
// 16-byte output vectors (width a multiple of their elements, x aligned to
// the vector's input bytes, out to 16).  start is one int32 on the device.
// The plan (ops/probes.py::copy_plan): blocks of tx x ty threads (ty rows
// of out a block), grid blocks covering the rows.
extern "C" int probe_copy_launch(const void* x, int n, int width, int kind,
                                 const void* start, int scale, int off,
                                 int rows, int vec, int tx, int ty, int grid,
                                 void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROBE_COPY(Tin, Tout, V)                                        \
  return copy_rows<Tin, Tout, V>(x, n, width, start, scale, off, rows, \
                                 tx, ty, grid, out, s)
  switch (kind * 2 + (vec != 0)) {
    case 0:
      PROBE_COPY(int8_t, int32_t, 1);
    case 1:
      PROBE_COPY(int8_t, int32_t, 4);
    case 2:
      PROBE_COPY(uint16_t, uint16_t, 1);
    case 3:
      PROBE_COPY(uint16_t, uint16_t, 8);
    case 4:
      PROBE_COPY(uint32_t, uint32_t, 1);
    case 5:
      PROBE_COPY(uint32_t, uint32_t, 4);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_COPY
}

// a [m, n] f32 -> out [n, m].  The plan (ops/probes.py::transpose_plan):
// blocks of p x q threads, each moving a 4 x 4 block (vec: 16-byte
// accesses).
extern "C" int probe_transpose_launch(const void* a, int m, int n, int p,
                                      int q, int vec, void* out,
                                      void* stream) {
  if (p < 1 || q < 1 || p * q > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(a);
  float* o = static_cast<float*>(out);
  const dim3 grid((m + 4 * p - 1) / (4 * p), (n + 4 * q - 1) / (4 * q));
  if (vec) {
    transpose_regs_kernel<true><<<grid, dim3(p, q), 0, s>>>(in, m, n, o);
  } else {
    transpose_regs_kernel<false><<<grid, dim3(p, q), 0, s>>>(in, m, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// x [*, width] 4-byte elements, idx and out [rows, width] (width a
// multiple of 4, all 16-byte aligned).  The plan (ops/probes.py::
// gather_plan): a warp per output row, rb rows a block, grid blocks, smem
// bytes of shared memory (rb rows).
extern "C" int probe_gather_launch(const void* x, int width, const void* idx,
                                   int rows, int rb, int smem, int grid,
                                   void* out, void* stream) {
  if (rb < 1 || rb > 32 || grid < 1 ||
      static_cast<long long>(grid) * rb < rows || smem != rb * width * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lane_gather_kernel<<<grid, rb * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), width, static_cast<const int*>(idx),
      rows, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [*, width] f32, out [rows, width] (width a multiple of 4, both 16-byte
// aligned): out[r] = x[row] * scale.  The plan (ops/probes.py::
// gather_plan, broadcast): rb warps a block, rw rows a warp, grid blocks.
extern "C" int probe_broadcast_launch(const void* x, int width, int row,
                                      float scale, int rows, int rb, int rw,
                                      int grid, void* out, void* stream) {
  if (rb < 1 || rb > 32 || rw < 1 || grid < 1 ||
      static_cast<long long>(grid) * rb * rw < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  broadcast_rows_kernel<<<grid, rb * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), width, row, scale, rows, rw,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename Tin, typename Tacc, int V>
int launch_join(const void* probes, int t_n, const void* keys, int w_n,
                const void* table, int c, int threads, int search, int grid,
                void* out, cudaStream_t s) {
  const auto* pr = static_cast<const int*>(probes);
  const auto* ks = static_cast<const int*>(keys);
  const auto* tb = static_cast<const Tin*>(table);
  auto* o = static_cast<Tacc*>(out);
  if (search == kWarpCount) {
    join_kernel<Tin, Tacc, V, kWarpCount><<<grid, threads, 0, s>>>(
        pr, t_n, ks, w_n, tb, c, o);
  } else {
    join_kernel<Tin, Tacc, V, kWarpSearch><<<grid, threads, 0, s>>>(
        pr, t_n, ks, w_n, tb, c, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// probes [t_n] and keys [w_n] (ascending) int32, table [w_n, c] int8
// (is_int8, out int32) or f32 (out f32); out [t_n, c].  The plan
// (ops/probes.py::join_plan): vec (16-byte output vectors: c a multiple of
// 4, table aligned to a vector's input bytes), threads a block (a warp a
// probe), search (a JoinSearch; kWarpCount: at most kJoinCountKeys keys),
// grid blocks covering the probes.
extern "C" int probe_join_launch(const void* probes, int t_n, const void* keys,
                                 int w_n, const void* table, int c,
                                 int is_int8, int vec, int threads, int search,
                                 int grid, void* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || grid < 1 ||
      static_cast<long long>(grid) * (threads / 32) < t_n || search < 0 ||
      search > kWarpCount || (search == kWarpCount && w_n > kJoinCountKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROBE_JOIN_V(Tin, Tacc, V)                                    \
  return launch_join<Tin, Tacc, V>(probes, t_n, keys, w_n, table, c, \
                                   threads, search, grid, out, s)
  if (is_int8) {
    if (vec) PROBE_JOIN_V(int8_t, int32_t, 4);
    PROBE_JOIN_V(int8_t, int32_t, 1);
  }
  if (vec) PROBE_JOIN_V(float, float, 4);
  PROBE_JOIN_V(float, float, 1);
#undef PROBE_JOIN_V
}

// keys [w_n] ascending, probes and out [rows, lanes] int32, out 16-byte
// aligned.  The plan (ops/probes.py::rank_plan): search (a RankSearch;
// kRankCount: at most kRankCountKeys keys), kvec (16-byte key loads, the
// keys 16-byte aligned), rb warps (rows) a block, grid blocks covering the
// rows.
extern "C" int probe_rank_launch(const void* keys, int w_n, const void* probes,
                                 int rows, int lanes, int search, int kvec,
                                 int rb, int grid, void* out, void* stream) {
  if (rb < 1 || rb > 32 || grid < 1 ||
      static_cast<long long>(grid) * rb < rows || search < 0 ||
      search > kRankCount ||
      (search == kRankCount && w_n > kRankCountKeys) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (kvec && reinterpret_cast<uintptr_t>(keys) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ks = static_cast<const int*>(keys);
  const auto* pr = static_cast<const int*>(probes);
  auto* o = static_cast<int*>(out);
  if (search == kRankSearch) {
    rank_kernel<kRankSearch, false><<<grid, rb * 32, 0, s>>>(ks, w_n, pr,
                                                           rows, lanes, o);
  } else if (kvec) {
    rank_kernel<kRankCount, true><<<grid, rb * 32, 0, s>>>(ks, w_n, pr, rows,
                                                         lanes, o);
  } else {
    rank_kernel<kRankCount, false><<<grid, rb * 32, 0, s>>>(ks, w_n, pr,
                                                          rows, lanes, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// is_int8: a [m, k], b [k, n] int8 -> out int32; else f32 inputs, bf16
// products, f32 out.  The plan (ops/probes.py::gemm_plan): a bm x bn tile
// a block, kw warps each summing ks of K, kc a round, vec 16-byte loads,
// smem bytes of dynamic shared memory; a tile and round it has no kernel
// for, or smem that is not the kernel's, is refused.
extern "C" int probe_gemm_launch(const void* a, const void* b, int m, int k,
                                 int n, int is_int8, int bm, int bn, int kw,
                                 int ks, int kc, int vec, int smem, void* out,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROBE_GEMM(Tile, kernel, In, Out, BM_, BN_, KC_)                     \
  if (bm == BM_ && bn == BN_ && kc == KC_) {                                 \
    using T = Tile<BM_, BN_, KC_>;                                           \
    return vec ? launch_gemm<T, true, In, Out>(kernel<T, true>, a, b, m, k,  \
                                               n, kw, ks, smem, out, s)      \
               : launch_gemm<T, false, In, Out>(kernel<T, false>, a, b, m,   \
                                                k, n, kw, ks, smem, out, s); \
  }
#define PROBE_GEMM_S8(BM_, BN_, KC_) \
  PROBE_GEMM(S8Tile, gemm_s8_kernel, int8_t, int, BM_, BN_, KC_)
#define PROBE_GEMM_BF16(BM_, BN_, KC_) \
  PROBE_GEMM(Bf16Tile, gemm_bf16_kernel, float, float, BM_, BN_, KC_)
  if (is_int8) {
    PROBE_GEMM_S8(32, 32, 32)
    PROBE_GEMM_S8(32, 32, 64)
    PROBE_GEMM_S8(32, 16, 32)
    PROBE_GEMM_S8(32, 16, 64)
    PROBE_GEMM_S8(16, 16, 32)
    PROBE_GEMM_S8(16, 16, 64)
    PROBE_GEMM_S8(16, 16, 128)
  } else {
    PROBE_GEMM_BF16(32, 32, 16)
    PROBE_GEMM_BF16(32, 32, 32)
    PROBE_GEMM_BF16(32, 16, 16)
    PROBE_GEMM_BF16(32, 16, 32)
    PROBE_GEMM_BF16(16, 16, 16)
    PROBE_GEMM_BF16(16, 16, 32)
    PROBE_GEMM_BF16(16, 16, 64)
    PROBE_GEMM_BF16(16, 8, 16)
    PROBE_GEMM_BF16(16, 8, 32)
    PROBE_GEMM_BF16(16, 8, 64)
  }
#undef PROBE_GEMM_BF16
#undef PROBE_GEMM_S8
#undef PROBE_GEMM
  return static_cast<int>(cudaErrorInvalidValue);
}
