// B3 `dg_wgrad`: the weight gradient of a gather-GEMM conv through the
// backward's match table.
//
// Replaces: the dW half of spconv_tpu/ops/pallas/dg_conv.py::_dg_bwd_kernel
//   (launched by _dg_bwd_call from the VJP _dg_conv_p_bwd), and so also of
//   sorted_conv.py::_sk_bwd_kernel, which computes the same function through
//   a one-hot key join.  The TPU kernel gathers dout once per 128-row tile
//   and accumulates both din and dW from it, carrying dW across the
//   sequential grid in VMEM.  Blocks on the H100 run in parallel with no
//   order, so dW is split over rows instead: each block sums its own share
//   into an f32 partial, and a second kernel adds the partials in a fixed
//   order (no atomics, so two runs give bit-equal dW).  din is B2's function
//   on the reversed table and runs through dg_fwd.cu.
//
// Computes: dW[k][c, kk] = sum_j x[j, c] * dout[pos_rev[k, j], kk], x [N, C]
//   and dout [N_dst, K] in f32 or bf16, pos_rev [kv, N] int32 (-1 = no
//   match), sums in f32, rounded once to the input dtype; zero where nothing
//   matches.
//
// The f32 kernel (a block owns a 64 x 64 dW tile and walks its split in
//   32-row chunks: it loads the chunk's matches, skips the chunk if all 32
//   are -1, else gathers x and dout into shared memory, zero where -1 or
//   past C / K, and accumulates with f32 FMAs) runs only the f32 parity
//   checks.
//
// The bf16 kernel, redesigned for Hopper.  Its first design was that loop
//   with 16x16x16 WMMA: one 2-byte element a thread and loop trip behind a
//   shared-memory read of the row index, two barriers per 32-row chunk and
//   nothing in flight during the MMAs, MMAs on all 32 rows of a chunk with
//   any match (2.36 MMA rows per matched pair at BenchNet's stage 0), fixed
//   64 x 64 dW tiles (61 of 64 rows zero at C = 3; x gathered K / 64 times,
//   dout C / 64 times, and in search mode every row searched again by each
//   tile) and an f32 staging tile in the epilogue.  On an NVIDIA H100 80GB
//   HBM3 at 700 W (chip_smoke.py) it took 9.13 ms per BenchNet step on the
//   subm path (125x its bound) and 8.73 ms in search mode.
//
// Bound on the H100: 2 * C * K flops per matched (row, offset) pair (~56
//   GFLOP a BenchNet step, 0.06 ms at the bf16 peak) against the gathered
//   rows (each matched pair's x and dout rows, once per dW tile that needs
//   them, from L2).  At C, K <= 64 the gathers bound it, above that the
//   MMAs.
//
// Design, one part per cause:
//   - Matched rows compacted: a block owns one offset k, one dW tile and
//     one row split.  It walks the split 512 rows at a time, reading each
//     row's match (coalesced from the table, or in search mode searched),
//     one chunk ahead of its use, and appends the matched (j, p) pairs in
//     ascending j to a ring list in shared memory (warp ballots, a prefix
//     over the warp counts).  The MMA steps consume BJ listed rows each, so
//     only the last step of a split multiplies padding, and whole k16
//     slices past the list's end are skipped: ~1.0x MMA rows per matched
//     pair.  The list's order is the table's, so the search mode builds the
//     same list and is bit-equal to B1 followed by the table mode.
//   - Gathers in flight: each listed row's C-chunk of x[j] and K-chunk of
//     dout[p] are copied with 16-byte cp.async.cg into a ring of kStages
//     shared-memory stages, one barrier a step; rows past the list's end
//     are zero-filled (source size 0).  C % 8 != 0 or an x pointer off 16
//     bytes takes the scalar-gather variant for x (`VEC` false): element
//     loads into registers, written to the ring one step later, so that
//     their latency overlaps a step's MMAs.  The same for dout by a runtime
//     flag, stored at once (K % 8 != 0 runs in none of the configurations).
//   - Tensor cores from ldmatrix.trans: mma.sync.m16n8k16 with M = input
//     channels, N = output channels and the sum over rows.  Both chunks
//     are stored by row (x as [BJ][BM + 8], dout as [BJ][BN + 8]), so A =
//     x^T and B = dout both load with ldmatrix.trans, conflict-free (an odd
//     number of 16-byte units a row).  A k16 slice's fragments are all
//     loaded before its MMAs, which run with no branch between them.
//   - Tiles that follow C and K: BM = 16, 32, 64 or 128 input channels and
//     BN = 64 or 128 output channels (wg::Tile0..5), chosen on the host
//     (ops/dg_conv.py::wgrad_variant), so C = 3 runs a 16-row tile and x
//     and dout are each gathered once per offset up to C = 128 (K = 128);
//     a warp whose rows or columns lie past C or K skips its MMAs.  Every
//     variant keeps at most 32 f32 sums a thread and 128 registers.
//   - Epilogue: the f32 sums go from registers straight to the partial
//     tile (8-byte stores); with one split, rounded to bf16 straight into
//     dW, and the reduce is not launched.  Splits (ops/dg_conv.py::
//     wgrad_splits) aim at four waves of resident blocks, at least 512 rows
//     a split and at most 64 MB of partials.
//   - Determinism: no atomics; each block sums its rows in ascending j, in
//     k16 slices of a fixed size, and the reduce adds splits s = 0, 1, ...
//
// Search mode (`dg_wgrad_search_*_launch`, S3): the same kernels with each
//   row's match from an in-block search of the sorted keys (dg_search.cuh's
//   subm probe, reversed) instead of the table, replacing the dW half of
//   _dg_bwd_kernel with posmode=False (launched at dg_conv.py:1598 from
//   _dg_conv_bwd :1661).  The f32 kernel searches a chunk of blockDim rows
//   at once and flags each 32-row chunk that matches anywhere.  The bf16
//   kernel searches a thread's rows of the next 512 together, in lockstep
//   (dg::search_rows: a branch-free lower bound whose steps depend on N
//   alone), so their loads are in flight at once.  Both build
//   exactly the table mode's chunks or list, so dW is bit-equal to B1's
//   reversed table followed by the table mode.  Every dW tile of an offset
//   repeats the searches of its rows (one tile up to C, K = 128 in bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dg_search.cuh"
#include "sm90_mma.cuh"

namespace {

constexpr int TM = 64;  // input channels c per tile (rows of dW[k])
constexpr int TN = 64;  // output channels kk per tile (columns of dW[k])
constexpr int BJ = 32;  // rows j per chunk

constexpr int kF32Threads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kReduceThreads = 256;

struct TileCoords {
  int c0, n0, k, j_begin, j_end;
};

__device__ __forceinline__ TileCoords tile_coords(int n, int K,
                                                  int rows_per_split) {
  const int tiles_n = (K + TN - 1) / TN;
  TileCoords t;
  t.c0 = (blockIdx.x / tiles_n) * TM;
  t.n0 = (blockIdx.x % tiles_n) * TN;
  t.k = blockIdx.y;
  t.j_begin = blockIdx.z * rows_per_split;
  t.j_end = min(n, t.j_begin + rows_per_split);
  return t;
}

// Row sources of the f32 kernel's chunks.  chunk(sm, k, j0, j_begin, j_end)
// returns the reversed matches of rows j0 .. j0 + BJ - 1 at offset k (-1
// past j_end), in the shared memory `sm` of kSmem ints, or nullptr when none
// of them matches, block-wide, so the whole block skips the chunk together.
// Every thread calls it with the same arguments, for j0 = j_begin, j_begin +
// BJ, ... below j_end.

// The matches from the reversed table pos_rev [kv, n].
struct TableChunks {
  static constexpr int kSmem = BJ;
  const int* pos_rev;
  int n;

  __device__ __forceinline__ const int* chunk(int* sm, int k, int j0, int,
                                              int j_end) const {
    int p = -1;
    if (threadIdx.x < BJ) {
      const int j = j0 + threadIdx.x;
      if (j < j_end) p = pos_rev[static_cast<size_t>(k) * n + j];
      sm[threadIdx.x] = p;
    }
    return __syncthreads_or(p >= 0) ? sm : nullptr;
  }
};

// The matches from an in-block search of the reversed probes: at every
// blockDim-th row from j_begin, each thread searches one row, and each warp
// flags whether its chunk matches.
template <int kThreads>
struct SearchChunks {
  static_assert(BJ == 32, "a chunk is one warp's rows");
  static constexpr int kSmem = kThreads + kThreads / BJ;
  const int* keys;
  int n;
  dg::SubmGeom g;
  int sentinel;

  __device__ __forceinline__ const int* chunk(int* sm, int k, int j0,
                                              int j_begin, int j_end) const {
    int* hit = sm + kThreads;
    const int off = (j0 - j_begin) % kThreads;
    if (off == 0) {
      __syncthreads();  // the previous rows and flags are read
      const int j = j0 + threadIdx.x;
      const int p = j < j_end ? dg::subm_probe(keys, n, __ldg(keys + j), k,
                                               g, sentinel, true)
                              : -1;
      sm[threadIdx.x] = p;
      const bool any = __any_sync(0xffffffffu, p >= 0);
      if (threadIdx.x % 32 == 0) hit[threadIdx.x / 32] = any;
      __syncthreads();
    }
    return hit[off / BJ] ? sm + off : nullptr;
  }
};

// Src: where each chunk's matches come from (TableChunks or SearchChunks).
template <class Src>
__global__ void __launch_bounds__(kF32Threads)
dg_wgrad_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ dout, Src src,
                    float* __restrict__ part, int n, int C, int K, int kv,
                    int rows_per_split) {
  __shared__ __align__(16) float Xs[BJ][TM];
  __shared__ __align__(16) float Ds[BJ][TN];
  __shared__ int rows[Src::kSmem];
  const TileCoords t = tile_coords(n, K, rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4] = {};

  for (int j0 = t.j_begin; j0 < t.j_end; j0 += BJ) {
    const int* sp = src.chunk(rows, t.k, j0, t.j_begin, t.j_end);
    if (sp == nullptr) continue;
    for (int e = tid; e < BJ * TM; e += kF32Threads) {
      const int r = e / TM;
      const int c = e % TM;
      float v = 0.f;
      if (sp[r] >= 0 && t.c0 + c < C) {
        v = __ldg(x + static_cast<size_t>(j0 + r) * C + t.c0 + c);
      }
      Xs[r][c] = v;
    }
    for (int e = tid; e < BJ * TN; e += kF32Threads) {
      const int r = e / TN;
      const int col = e % TN;
      const int p = sp[r];
      float v = 0.f;
      if (p >= 0 && t.n0 + col < K) {
        v = __ldg(dout + static_cast<size_t>(p) * K + t.n0 + col);
      }
      Ds[r][col] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < BJ; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ds[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = part + (static_cast<size_t>(blockIdx.z) * kv + t.k) *
                          static_cast<size_t>(C) * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = t.c0 + ty * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t.n0 + tx * 4 + j;
      if (col < K) out[static_cast<size_t>(c) * K + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the compacting, pipelined tensor-core kernel
// ---------------------------------------------------------------------------
namespace wg {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4_trans;
using sm90::mma_bf16;

constexpr int kStages = 4;     // depth of the shared-memory ring
constexpr int kChunk = 512;    // rows whose matches are listed at once
constexpr int kChunkWarps = kChunk / 32;
constexpr int kListCap = 1024;  // the ring list of (j, p) pairs
static_assert((kListCap & (kListCap - 1)) == 0, "a power of two");

// A block's dW tile: BM input channels x BN output channels on WARPS_M x
// WARPS_N warps, each warp MI m16 tiles x NI n8 tiles, BJ listed rows a
// pipeline step.  ops/dg_conv.py's WGRAD_TILES and wgrad_smem_bytes mirror
// the tiles and their shared memory.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int BJ_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int BJ = BJ_;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  // blocks an SM must hold: at most 128 registers a thread
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  // row pitches: an odd number of 16-byte units, so the 8 rows of an
  // ldmatrix hit 8 different bank groups
  static constexpr int kLdx = BM + 8;
  static constexpr int kLdd = BN + 8;
  static constexpr int kRowsPerThread = kChunk / kThreads;
  static_assert(BJ % 16 == 0 && BM % 8 == 0 && BN % 8 == 0, "whole units");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole ldmatrix.x4 tiles");
  static_assert(kChunk % kThreads == 0, "whole rows a thread");
  static_assert(kListCap >= kChunk + BJ, "the list holds a chunk and a step");

  __host__ __device__ static constexpr int stage_bytes() {
    return BJ * (kLdx + kLdd) * 2;
  }
  __host__ __device__ static constexpr int ring_bytes() {
    return kStages * stage_bytes();
  }
  // the ring, then the list [kListCap] of int2, then the chunk's warp
  // counts [kChunkWarps]
  __host__ __device__ static constexpr int smem_bytes() {
    return ring_bytes() + kListCap * 8 + kChunkWarps * 4;
  }
};

// wgrad's tiles, by variant number
using Tile0 = Tile<16, 64, 1, 4, 64>;
using Tile1 = Tile<32, 64, 2, 2, 64>;
using Tile2 = Tile<64, 64, 2, 2, 32>;
using Tile3 = Tile<64, 128, 2, 4, 32>;
using Tile4 = Tile<128, 64, 4, 2, 32>;
using Tile5 = Tile<128, 128, 4, 4, 32>;

// Row sources: match(k, j, j_end, p) sets p[r] to row j[r]'s reversed
// match at offset k, or -1 (also for j[r] >= j_end).
struct TableRows {
  const int* pos_rev;
  int n;

  template <int R>
  __device__ __forceinline__ void match(int k, const int (&j)[R], int j_end,
                                        int (&p)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = j[r] < j_end ? __ldg(pos_rev + static_cast<size_t>(k) * n + j[r])
                          : -1;
    }
  }
};

// The R rows' probes searched together (dg::search_rows), each finding the
// row dg::subm_probe finds.
struct SearchRows {
  const int* keys;
  int n;
  dg::SubmGeom g;
  int sentinel;

  template <int R>
  __device__ __forceinline__ void match(int k, const int (&j)[R], int j_end,
                                        int (&p)[R]) const {
    int probe[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      probe[r] = 0;
      ok[r] = j[r] < j_end &&
              dg::subm_probe_key(__ldg(keys + j[r]), k, g, sentinel, true,
                                 &probe[r]);
    }
    dg::search_rows(keys, n, probe, ok, p);
  }
};

// T: the Tile; VEC: 16-byte gathers of x's rows (C % 8 == 0, x 16-byte
// aligned), else element loads; Src: TableRows or SearchRows.  d_vec: the
// same for dout (K % 8 == 0, dout aligned).  part: f32 partials [S, kv, C,
// K], or with one split (gridDim.z == 1) nothing, dW written to out.
template <class T, bool VEC, class Src>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
dg_wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ dout, Src src,
                     float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                     int n, int C, int K, int kv, int rows_per_split,
                     int d_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int2* list = reinterpret_cast<int2*>(smem + T::ring_bytes());
  int* counts = reinterpret_cast<int*>(list + kListCap);
  constexpr int kStageElems = T::stage_bytes() / 2;
  constexpr int kR = T::kRowsPerThread;
  constexpr int kWarps = T::kThreads / 32;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % T::WARPS_M;
  const int wn = warp / T::WARPS_M;
  const int tiles_n = (K + T::BN - 1) / T::BN;
  const int c0 = (blockIdx.x / tiles_n) * T::BM;
  const int n0 = (blockIdx.x % tiles_n) * T::BN;
  const int k = blockIdx.y;
  const int j_begin = blockIdx.z * rows_per_split;
  const int j_end = min(n, j_begin + rows_per_split);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // the warp's dW rows and columns hold outputs: else its MMAs would all
  // land past C or K
  const bool warp_live = c0 + wm * T::WM < C && n0 + wn * T::WN < K;

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    }
  }

  // The matches of the next chunk's rows, next + r * kThreads + tid,
  // fetched one chunk ahead of their listing.
  int next = j_begin;
  int produced = 0;  // pairs listed so far (block-uniform)
  int pf[kR];
  auto fetch = [&]() {
    int j[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) j[r] = next + r * T::kThreads + tid;
    src.match(k, j, j_end, pf);
  };
  // Lists the chunk's matched pairs at list[produced ...] in ascending j:
  // per warp and row slot a ballot, then a prefix over the chunk's warp
  // counts in (slot, warp) order, which is the order of j.
  auto compact = [&]() {
    unsigned bal[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      bal[r] = __ballot_sync(0xffffffffu, pf[r] >= 0);
      if (lane == 0) counts[r * kWarps + warp] = __popc(bal[r]);
    }
    __syncthreads();  // the counts are written; the list's old pairs read
    int total = 0;
    int pre[kR];
#pragma unroll
    for (int i = 0; i < kChunkWarps; ++i) {
      const int cnt = counts[i];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (i == r * kWarps + warp) pre[r] = total;
      }
      total += cnt;
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (pf[r] >= 0) {
        const int idx = produced + pre[r] + __popc(bal[r] & below);
        list[idx & (kListCap - 1)] =
            make_int2(next + r * T::kThreads + tid, pf[r]);
      }
    }
    produced += total;
    next += kChunk;
    __syncthreads();  // the pairs are listed; the counts read
    fetch();
  };
  // Lists chunks until step t's BJ pairs are listed or the split ends;
  // whether step t has any pair.
  auto ensure = [&](int t) {
    while (produced < (t + 1) * T::BJ && next < j_end) compact();
    return produced > t * T::BJ;
  };

  // The scalar gather's x values of step x_pending, in registers until
  // store_x writes them to its ring stage (the tile's cw channels): one
  // step later where they take at most 8 registers a thread, else at once.
  constexpr int kXPer = VEC ? 1 : T::BJ * T::BM / T::kThreads;
  constexpr bool kDeferX = kXPer <= 8;
  const int cw = min(T::BM, C - c0);
  __nv_bfloat16 xv[kXPer];
  int x_pending = -1;
  auto store_x = [&]() {
    if (VEC || x_pending < 0) return;
    __nv_bfloat16* xs = ring + (x_pending % kStages) * kStageElems;
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * T::kThreads;
      if (e >= T::BJ * cw) break;
      xs[(e / cw) * T::kLdx + e % cw] = xv[i];
    }
    x_pending = -1;
  };

  // Copies step t's chunks into ring stage t % kStages: x's rows j [BJ][BM]
  // from c0 and dout's rows p [BJ][BN] from n0, zeros for rows past the
  // list's end.  Channels past C or K are not copied: they reach only
  // outputs past C or K, which are not stored.
  auto load = [&](int t) {
    __nv_bfloat16* xs = ring + (t % kStages) * kStageElems;
    __nv_bfloat16* ds = xs + T::BJ * T::kLdx;
    const int base = t * T::BJ;
    if (VEC) {
      for (int e = tid; e < T::BJ * (T::BM / 8); e += T::kThreads) {
        const int r = e / (T::BM / 8);
        const int c = (e % (T::BM / 8)) * 8;
        if (c0 + c >= C) continue;
        const bool ok = base + r < produced;
        const int j = ok ? list[(base + r) & (kListCap - 1)].x : 0;
        cp_async16(xs + r * T::kLdx + c,
                   x + static_cast<size_t>(j) * C + c0 + c, ok ? 16 : 0);
      }
    } else {
      // element loads into registers, stored by store_x one step later
      // (kDeferX), so that their latency overlaps the current step's MMAs
#pragma unroll
      for (int i = 0; i < kXPer; ++i) {
        const int e = tid + i * T::kThreads;
        if (e >= T::BJ * cw) break;
        const int r = e / cw;
        const bool ok = base + r < produced;
        xv[i] = ok ? x[static_cast<size_t>(
                           list[(base + r) & (kListCap - 1)].x) *
                           C + c0 + e % cw]
                   : zero;
      }
      x_pending = t;
      if (!kDeferX) store_x();
    }
    if (d_vec) {
      for (int e = tid; e < T::BJ * (T::BN / 8); e += T::kThreads) {
        const int r = e / (T::BN / 8);
        const int col = (e % (T::BN / 8)) * 8;
        if (n0 + col >= K) continue;
        const bool ok = base + r < produced;
        const int p = ok ? list[(base + r) & (kListCap - 1)].y : 0;
        cp_async16(ds + r * T::kLdd + col,
                   dout + static_cast<size_t>(p) * K + n0 + col,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < T::BJ * T::BN; e += T::kThreads) {
        const int r = e / T::BN;
        const int col = e % T::BN;
        if (n0 + col >= K) continue;
        const bool ok = base + r < produced;
        ds[r * T::kLdd + col] =
            ok ? dout[static_cast<size_t>(
                          list[(base + r) & (kListCap - 1)].y) *
                          K + n0 + col]
               : zero;
      }
    }
  };

  // The warp's MMAs of step s: per k16 slice of rows that holds a listed
  // pair, every fragment is loaded before the slice's MMAs, which run with
  // no branch between them.
  auto compute = [&](int s) {
    if (!warp_live) return;
    const __nv_bfloat16* xs = ring + (s % kStages) * kStageElems;
    const __nv_bfloat16* ds = xs + T::BJ * T::kLdx;
#pragma unroll
    for (int ks = 0; ks < T::BJ / 16; ++ks) {
      if (s * T::BJ + ks * 16 >= produced) break;  // padding from here on
      unsigned a[T::MI][4];
      unsigned b[T::NI / 2][4];
      // A = x^T (c x j): xs is [j][c], so ldmatrix.trans; matrix q of the
      // x4 is rows j + (q / 2) * 8, channels + (q % 2) * 8
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        ldsm_x4_trans(a[mi],
                      xs + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                               T::kLdx +
                          wm * T::WM + mi * 16 + ((lane >> 3) & 1) * 8);
      }
      // B = dout (j x kk), ds is [j][kk]: matrix q is rows j + (q % 2) * 8,
      // columns + (q / 2) * 8
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        ldsm_x4_trans(b[nj], ds + (ks * 16 + (lane & 15)) * T::kLdd +
                                 wn * T::WN + nj * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                   b[ni / 2][(ni % 2) * 2 + 1]);
        }
      }
    }
  };

  fetch();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    store_x();
    if (ensure(t)) load(t);
    cp_async_commit();
  }
  // step s exists iff produced > s * BJ: ensure(s) has run, so produced is
  // past step s or final.  Step s + kStages - 2's scalar x values (loaded
  // in the previous trip) go to their stage here, after the barrier that
  // frees it and before the one that precedes their MMAs.
  for (int s = 0; produced > s * T::BJ; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's)
    __syncthreads();  // ... everyone's, and step s - 1's stage is free
    store_x();
    if (ensure(s + kStages - 1)) load(s + kStages - 1);
    cp_async_commit();
    compute(s);
  }
  cp_async_wait<0>();

  // Epilogue, from registers: accumulator q of tile (mi, ni) is dW row
  // c0 + wm * WM + mi * 16 + lane / 4 (+ 8 for q >= 2), columns n0 + wn *
  // WN + ni * 8 + (lane % 4) * 2 + (q % 2).
  const bool pairs = K % 2 == 0;
  const size_t tile0 = static_cast<size_t>(k) * C * K;
  float* pp = gridDim.z > 1
                  ? part + static_cast<size_t>(blockIdx.z) * kv * C * K + tile0
                  : nullptr;
  __nv_bfloat16* po = out + tile0;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm * T::WM + mi * 16 + lane / 4 + h * 8;
      if (c >= C) continue;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = n0 + wn * T::WN + ni * 8 + (lane % 4) * 2;
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        const size_t o = static_cast<size_t>(c) * K + col;
        if (pairs && col + 1 < K) {
          if (pp != nullptr) {
            *reinterpret_cast<float2*>(pp + o) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(po + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (col < K) {
            if (pp != nullptr) pp[o] = v0; else po[o] = __float2bfloat16(v0);
          }
          if (col + 1 < K) {
            if (pp != nullptr) {
              pp[o + 1] = v1;
            } else {
              po[o + 1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
  }
}

}  // namespace wg

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// out[i] = sum over s = 0, 1, ..., splits-1 of part[s][i], in that order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
dg_wgrad_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                       int splits, size_t total) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads +
                  threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kReduceThreads) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += part[q * total + i];
    store_out(out + i, s);
  }
}

int rows_per_split(int n, int splits) {
  const int r = (n + splits - 1) / splits;
  return (r + BJ - 1) / BJ * BJ;
}

template <typename T>
int reduce_launch(const float* part, T* out, int splits, size_t total,
                  cudaStream_t stream) {
  const size_t want = (total + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dg_wgrad_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(
      part, out, splits, total);
  return static_cast<int>(cudaGetLastError());
}

template <class Src>
int launch_f32(const void* x, const void* dout, Src src, void* part,
               void* out, int n, int C, int K, int kv, int splits,
               cudaStream_t s) {
  float* p = static_cast<float*>(part);
  const dim3 grid(((C + TM - 1) / TM) * ((K + TN - 1) / TN), kv, splits);
  dg_wgrad_f32_kernel<Src><<<grid, kF32Threads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dout), src, p,
      n, C, K, kv, rows_per_split(n, splits));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce_launch(static_cast<const float*>(p), static_cast<float*>(out),
                       splits, static_cast<size_t>(kv) * C * K, s);
}

template <class T, bool VEC, class Src>
int launch_variant(const void* x, const void* dout, Src src, void* part,
                   void* out, int n, int C, int K, int kv, int splits,
                   int d_vec, cudaStream_t s) {
  auto* kern = wg::dg_wgrad_bf16_kernel<T, VEC, Src>;
  constexpr int smem = T::smem_bytes();
  // above 48 KB only by this opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(((C + T::BM - 1) / T::BM) * ((K + T::BN - 1) / T::BN), kv,
                  splits);
  auto* o = static_cast<__nv_bfloat16*>(out);
  kern<<<grid, T::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dout), src,
      static_cast<float*>(part), o, n, C, K, kv, rows_per_split(n, splits),
      d_vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  return reduce_launch(static_cast<const float*>(part), o, splits,
                       static_cast<size_t>(kv) * C * K, s);
}

template <class T, class Src>
int launch_tile(const void* x, const void* dout, Src src, void* part,
                void* out, int n, int C, int K, int kv, int splits, int vec,
                int d_vec, cudaStream_t s) {
  return vec ? launch_variant<T, true>(x, dout, src, part, out, n, C, K, kv,
                                       splits, d_vec, s)
             : launch_variant<T, false>(x, dout, src, part, out, n, C, K, kv,
                                        splits, d_vec, s);
}

template <class Src>
int launch_bf16(const void* x, const void* dout, Src src, void* part,
                void* out, int n, int C, int K, int kv, int splits, int tile,
                int vec, int d_vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch_tile<wg::Tile0>(x, dout, src, part, out, n, C, K, kv,
                                    splits, vec, d_vec, s);
    case 1:
      return launch_tile<wg::Tile1>(x, dout, src, part, out, n, C, K, kv,
                                    splits, vec, d_vec, s);
    case 2:
      return launch_tile<wg::Tile2>(x, dout, src, part, out, n, C, K, kv,
                                    splits, vec, d_vec, s);
    case 3:
      return launch_tile<wg::Tile3>(x, dout, src, part, out, n, C, K, kv,
                                    splits, vec, d_vec, s);
    case 4:
      return launch_tile<wg::Tile4>(x, dout, src, part, out, n, C, K, kv,
                                    splits, vec, d_vec, s);
    case 5:
      return launch_tile<wg::Tile5>(x, dout, src, part, out, n, C, K, kv,
                                    splits, vec, d_vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// part: f32 scratch [splits, kv, C, K]; out: [kv, C, K] in the input dtype.
extern "C" int dg_wgrad_f32_launch(const void* x, const void* dout,
                                   const void* pos_rev, void* part, void* out,
                                   int n, int C, int K, int kv, int splits,
                                   void* stream) {
  return launch_f32(x, dout, TableChunks{static_cast<const int*>(pos_rev), n},
                    part, out, n, C, K, kv, splits,
                    static_cast<cudaStream_t>(stream));
}

// tile: the variant (wg::Tile0..5, ops/dg_conv.py::wgrad_variant); vec /
// d_vec: 16-byte gathers of x / dout; part is not read with one split.
extern "C" int dg_wgrad_bf16_launch(const void* x, const void* dout,
                                    const void* pos_rev, void* part,
                                    void* out, int n, int C, int K, int kv,
                                    int splits, int tile, int vec, int d_vec,
                                    void* stream) {
  return launch_bf16(x, dout,
                     wg::TableRows{static_cast<const int*>(pos_rev), n}, part,
                     out, n, C, K, kv, splits, tile, vec, d_vec, stream);
}

// Search mode: keys [n] ascending with the sentinel tail, geom (host
// memory) as dg_pos_launch's; the probes are the reversed ones.
extern "C" int dg_wgrad_search_f32_launch(const void* x, const void* dout,
                                          const void* keys, void* part,
                                          void* out, int n, int C, int K,
                                          int kv, int splits,
                                          const int* geom, int sentinel,
                                          void* stream) {
  return launch_f32(x, dout,
                    SearchChunks<kF32Threads>{static_cast<const int*>(keys),
                                              n, dg::subm_geom(geom),
                                              sentinel},
                    part, out, n, C, K, kv, splits,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int dg_wgrad_search_bf16_launch(const void* x, const void* dout,
                                           const void* keys, void* part,
                                           void* out, int n, int C, int K,
                                           int kv, int splits,
                                           const int* geom, int sentinel,
                                           int tile, int vec, int d_vec,
                                           void* stream) {
  return launch_bf16(x, dout,
                     wg::SearchRows{static_cast<const int*>(keys), n,
                                    dg::subm_geom(geom), sentinel},
                     part, out, n, C, K, kv, splits, tile, vec, d_vec,
                     stream);
}
