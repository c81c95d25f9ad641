// B2 `dg_fwd`: gather-GEMM forward of a submanifold conv through a cached
// match table ("posmode"), and B3's input gradient through the same kernel.
//
// Replaces: spconv_tpu/ops/pallas/dg_conv.py::_dg_fwd_kernel in packmodes
//   "f32" and "pack2" with posmode=True (launched by _dg_conv_call, public
//   entry dg_subm_conv); on the reversed table with W[k]^T it is also the
//   din half of _dg_bwd_kernel (the wrapper dg_dgrad), and so of
//   sorted_conv.py::_sk_fwd_kernel and _sk_bwd_kernel, which compute the
//   same functions through a one-hot key join.  The TPU kernel DMAs
//   window-planned, lane-chunked, transposed feature tables (bf16 channel
//   pairs packed in int32 lanes), lane-gathers the matched columns and runs
//   one deep GEMM per 128-row tile.  Those layouts exist for Mosaic; here
//   the matched rows are gathered straight from the row-major [N, C]
//   features.
//
// Computes: out[i, :] = sum_k x[pos[k, i], :] @ W[k], x [N, C] and
//   W [kv, C, K] in f32 or bf16, pos [kv, N] int32 (-1 = no match).  The sum
//   is kept in f32 and rounded once to the input dtype.  A row with no match
//   (every invalid row) ends as 0.  The bf16 kernel also reads W[k] as its
//   transpose (`trans`: W stored [kv, K, C]), so dgrad passes the weight as
//   it is; the f32 dgrad's wrapper transposes it.
//
// The f32 kernel (a block owns a 64 x 64 output tile; per offset and
//   32-channel step it gathers the matched rows into shared memory, zeros
//   where pos is -1 or past C, and multiplies with f32 FMAs) runs only the
//   f32 parity checks.
//
// The bf16 kernel, redesigned for Hopper.  Its first design was the f32
//   kernel's loop with 16x16x16 WMMA: 64 x 64 tiles, a gather of one 2-byte
//   element per thread and loop trip behind a shared-memory read of the row
//   index, two barriers per 32-channel step and nothing in flight during the
//   MMAs, every row gathered (and in search mode searched) again by each of
//   the K / 64 column tiles, 64-wide tiles at K = 16 or 32, MMAs on every
//   row of a tile with any match, and an f32 staging tile in the epilogue.
//   On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) it took 7.55 ms
//   per BenchNet request on the subm path (104x its bound), dgrad 7.72 ms a
//   step, the search mode 9.40 ms (forward) and 9.67 ms (dgrad).
//
// Bound on the H100: the matched work is 2 * C * K flops per matched (row,
//   offset) pair (~56 GFLOP a BenchNet request, 0.06 ms at the bf16 peak),
//   but a warp multiplies whole 16-row MMA tiles: ~2.1 issued rows per
//   matched pair on the synthetic scan, so the MMAs that run are ~2x the
//   matched work.  The bytes are the gathered rows (each matched row's
//   C-chunk once per offset, ~0.5 GB a request, from L2: every layer's x
//   fits the 50 MB L2), W[k] once per block and live offset (as many bytes
//   again at BM = 64), and the output once.  Once the gathers overlap the
//   MMAs, what is left is the MMAs on unmatched rows, the W[k] re-reads and
//   the latency of a block's steps in series at the small late stages.
//
// Design, one part per cause:
//   - Gathers in flight: each matched row's chunk is copied with 16-byte
//     cp.async.cg (8 bf16 a thread; unmatched rows and channels past C are
//     zero-filled by a source size of 0) into a ring of kStages shared-
//     memory stages over the block's steps, W[k]'s chunk beside it, so
//     kStages - 1 steps' copies are in flight while the current step
//     multiplies.  One barrier per step.
//   - One gather per row for all of K: a block owns BM rows and, for
//     K <= 256, every output column (BN = K rounded up to a tile width), so
//     each matched row is gathered, and in search mode searched, once per
//     offset.  Column tiles remain for K > 256 and where N is too small to
//     give the card a wave of blocks.  The tile is a variant chosen by the
//     wrapper (ops/dg_conv.py::b2_variant) from (N, C, K).
//   - Narrow K: BN is 16, 32, 64, 128 or 256, so a K = 16 or 32 layer runs
//     a 16- or 32-wide tile; a warp whose columns all lie past K skips its
//     MMAs.
//   - Narrow C: a step is BK = 32 or 64 input channels (64 where the tile
//     is narrow, so a step carries more MMAs per barrier).  With C <= 16 a
//     step packs BK / 16 offsets, one per k16 slice, so a 3^3 conv on 3 to
//     16 channels takes 7 steps of 64 channels, not 27 mostly empty ones;
//     slices past C or past the live offsets are neither copied nor
//     multiplied.
//   - Tensor cores from ldmatrix: mma.sync.m16n8k16 bf16 -> f32, A from
//     ldmatrix and B from ldmatrix.trans ([C, K] weights) or ldmatrix (the
//     transposed weights of dgrad, the `TRANS` flag), from rows pitched 8
//     elements past BK or BN, conflict-free.  A k16 slice's fragments are
//     all loaded before its MMAs, which run with no branch between them.
//     The block's rows of a group of up to 32 offsets are staged at once,
//     with one bit per 16 rows and offset saying whether any matches:
//     offsets that match nowhere in the block take no step, and a warp
//     skips the MMAs of its 16-row tiles that match nothing at a slice's
//     offset.
//   - Epilogue: the accumulators are rounded to bf16 in registers, staged in
//     a bf16 tile in the ring and stored 16 bytes a thread.
//   - C % 8 != 0 or a feature pointer off 16 bytes: the scalar-gather
//     variant (`VEC` false) loads the A chunk element by element into the
//     same ring; a weight whose rows are not 16-byte vectors is loaded the
//     same way inside any variant.
//   - Determinism: no atomics, no split of offsets over blocks; every output
//     sums its k16 slices in ascending offset and channel order, and a
//     skipped offset or 16-row tile adds nothing a zero-filled one would
//     not.
//
// Search mode (`dg_fwd_search_*_launch`, S1 and, with `reverse` and W[k]^T,
//   S2): the same kernels with the tile's rows from an in-block search of
//   the sorted keys instead of the table (dg_search.cuh), replacing
//   _dg_fwd_kernel and the din half of _dg_bwd_kernel with posmode=False
//   (launched at dg_conv.py:1020 from _dg_conv :1639, and at :1598 from
//   _dg_conv_bwd :1661).  The mainloop, the tile shapes and the order of
//   the f32 sums are the table mode's, and the search finds exactly B1's
//   rows, so the output is bit-equal to B1 followed by the table mode.
//   Bound as the table mode, plus the searches: kv * BM probes of ~17
//   dependent L2 loads per block (once per row at the bf16 kernel's
//   full-width tiles).  It saves B1's launch and the [kv, N] table's write
//   and read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dg_search.cuh"
#include "sm90_mma.cuh"

namespace {

// the f32 kernel's tile
constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // input channels per step

constexpr int kF32Threads = 256;   // 16 x 16 threads, 4 x 4 outputs each

// Src: where the tile's rows come from (dg::TableTile or dg::SearchTile).
template <class Src>
__global__ void __launch_bounds__(kF32Threads)
dg_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  Src src, float* __restrict__ out, int n, int C, int K,
                  int kv) {
  __shared__ float As[BK][BM + 1];  // transposed gather tile, padded
  __shared__ float Bs[BK][BN];
  __shared__ int rows[Src::kSmem];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4] = {};

  for (int k = 0; k < kv; ++k) {
    const int* sp = src.tile(rows, k, row0);
    if (sp == nullptr) continue;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int e = tid; e < BM * BK; e += kF32Threads) {
        const int r = e / BK;
        const int c = e % BK;
        const int pr = sp[r];
        float v = 0.f;
        if (pr >= 0 && c0 + c < C) {
          v = __ldg(x + static_cast<size_t>(pr) * C + c0 + c);
        }
        As[c][r] = v;
      }
      for (int e = tid; e < BK * BN; e += kF32Threads) {
        const int c = e / BN;
        const int col = e % BN;
        float v = 0.f;
        if (c0 + c < C && col0 + col < K) {
          v = __ldg(w + (static_cast<size_t>(k) * C + c0 + c) * K + col0 +
                    col);
        }
        Bs[c][col] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        float a[4];
        float b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[c][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[c][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < K) out[static_cast<size_t>(r) * K + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the pipelined, full-width tensor-core kernel
// ---------------------------------------------------------------------------
namespace b2 {

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 4;     // depth of the shared-memory ring
constexpr int kGroup = dg::kSearchGroup;  // offsets whose rows are staged
static_assert(kGroup == 32, "one lane per offset of a group");

// A block's output tile: BM rows x BN columns on WARPS_M x WARPS_N warps,
// each warp MI m16 tiles x NI n8 tiles, BK input channels a pipeline step.
// ops/dg_conv.py's B2_TILES and b2_smem_bytes mirror the tiles and their
// shared memory.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int BK_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int BK = BK_;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  // pitches of a channel-contiguous row (BK + 8) and of a column-contiguous
  // one (BN + 8): an odd number of 16-byte units, so the 8 rows of an
  // ldmatrix hit 8 different bank groups
  static constexpr int kLdk = BK + 8;
  static constexpr int kLdn = BN + 8;
  static_assert(BK % 32 == 0, "whole k16 steps, 16-byte copies");
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole ldmatrix.x4 tiles");
  static_assert(BM % 32 == 0 && BM / 16 <= 32,
                "one live bit per 16 rows, two per warp ballot");

  // the ring's stage: the A chunk [BM][kLdk], then the B chunk, [BN][kLdk]
  // with the transposed weights, [BK][kLdn] without
  __host__ __device__ static constexpr int a_bytes() { return BM * kLdk * 2; }
  __host__ __device__ static constexpr int b_bytes(bool trans) {
    return trans ? BN * kLdk * 2 : BK * kLdn * 2;
  }
  __host__ __device__ static constexpr int stage_bytes(bool trans) {
    return a_bytes() + b_bytes(trans);
  }
  __host__ __device__ static constexpr int ring_bytes(bool trans) {
    return kStages * stage_bytes(trans);
  }
  // the ring, then rows [kGroup][BM], live bits [kGroup], the live
  // offsets [kGroup] and their count
  __host__ __device__ static constexpr int smem_bytes(bool trans) {
    return ring_bytes(trans) + (kGroup * BM + 2 * kGroup + 1) * 4;
  }
};

// B2's tiles, by variant number
using Tile0 = Tile<128, 16, 8, 1, 64>;
using Tile1 = Tile<128, 32, 8, 1, 64>;
using Tile2 = Tile<64, 64, 4, 2, 64>;
using Tile3 = Tile<64, 128, 2, 4, 32>;
using Tile4 = Tile<64, 256, 2, 4, 32>;

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::mma_bf16;

// T: the Tile; TRANS: W stored [kv, K, C] (dgrad's W[k]^T) instead of
// [kv, C, K]; VEC: 16-byte gathers of x's rows (C % 8 == 0, x 16-byte
// aligned), else element loads; PACKED: C <= 16, one offset per k16 slice
// of a step; Src: where the rows come from (dg::TableTile<BM> or
// dg::SearchTile<BM>).
template <class T, bool TRANS, bool VEC, bool PACKED, class Src>
__global__ void __launch_bounds__(kThreads, 2)
dg_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w, Src src,
                   __nv_bfloat16* __restrict__ out, int n, int C, int K,
                   int kv) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* rows = reinterpret_cast<int*>(smem + T::ring_bytes(TRANS));
  unsigned* live = reinterpret_cast<unsigned*>(rows + kGroup * T::BM);
  int* list = reinterpret_cast<int*>(live + kGroup);
  int* count = list + kGroup;
  constexpr int kStageElems = T::stage_bytes(TRANS) / 2;
  constexpr int kAElems = T::a_bytes() / 2;
  static_assert(T::BM * T::kLdn * 2 <= T::ring_bytes(TRANS),
                "the epilogue's staging tile fits the ring");

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // warps along M vary fastest: the warps of one column stripe sit on
  // different SM sub-partitions
  const int wm = warp % T::WARPS_M;
  const int wn = warp / T::WARPS_M;
  const int row0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  // A step multiplies BK input channels: with C > 16 a BK-channel chunk of
  // one offset (the offset's chunks ascending), with C <= 16 (PACKED) one
  // offset in each k16 slice, all of its channels, BK / 16 offsets a step.
  // Either way the k16 slices of an output's sum come in ascending offset
  // and channel order.
  const int nchunks = PACKED ? 1 : (C + T::BK - 1) / T::BK;
  constexpr int kSlices = T::BK / 16;
  // W[k]'s rows (K long, or C with TRANS) as 16-byte vectors
  const bool w_vec = (TRANS ? C : K) % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // the warp's columns hold output columns: else its MMAs would all multiply
  // the zero columns past K
  const bool warp_cols = n0 + wn * T::WN < K;
  int cnt = 0;  // live offsets of the current group

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
  }

  // Copies step s's A and B chunks into ring stage s % kStages: A [BM][BK]
  // from the matched rows, B [BK][BN] (or [BN][BK]) from W[k]; zeros for
  // unmatched rows, channels past C and columns past K.  A step of one
  // offset reads list once; a packed step looks up each k16 slice's offset.
  auto load = [&](int s, int k0) {
    __nv_bfloat16* as = ring + (s % kStages) * kStageElems;
    __nv_bfloat16* bs = as + kAElems;
    if (!PACKED) {
      const int kk = list[s / nchunks];
      const int c0 = (s % nchunks) * T::BK;
      const int* sp = rows + kk * T::BM;
      if (VEC) {
        for (int e = tid; e < T::BM * (T::BK / 8); e += kThreads) {
          const int r = e / (T::BK / 8);
          const int c = (e % (T::BK / 8)) * 8;
          const int p = sp[r];
          const bool ok = p >= 0 && c0 + c < C;
          cp_async16(as + r * T::kLdk + c,
                     ok ? x + static_cast<size_t>(p) * C + c0 + c : x,
                     ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < T::BM * T::BK; e += kThreads) {
          const int r = e / T::BK;
          const int c = e % T::BK;
          const int p = sp[r];
          as[r * T::kLdk + c] = p >= 0 && c0 + c < C
                                    ? x[static_cast<size_t>(p) * C + c0 + c]
                                    : zero;
        }
      }
      const __nv_bfloat16* wk = w + static_cast<size_t>(k0 + kk) * C * K;
      if (TRANS) {  // wk [K][C] -> bs [BN][kLdk]
        if (w_vec) {
          for (int e = tid; e < T::BN * (T::BK / 8); e += kThreads) {
            const int r = e / (T::BK / 8);
            const int c = (e % (T::BK / 8)) * 8;
            const bool ok = n0 + r < K && c0 + c < C;
            cp_async16(bs + r * T::kLdk + c,
                       ok ? wk + static_cast<size_t>(n0 + r) * C + c0 + c : w,
                       ok ? 16 : 0);
          }
        } else {
          for (int e = tid; e < T::BN * T::BK; e += kThreads) {
            const int r = e / T::BK;
            const int c = e % T::BK;
            bs[r * T::kLdk + c] =
                n0 + r < K && c0 + c < C
                    ? wk[static_cast<size_t>(n0 + r) * C + c0 + c]
                    : zero;
          }
        }
      } else {  // wk [C][K] -> bs [BK][kLdn]
        if (w_vec) {
          for (int e = tid; e < T::BK * (T::BN / 8); e += kThreads) {
            const int r = e / (T::BN / 8);
            const int col = (e % (T::BN / 8)) * 8;
            const bool ok = c0 + r < C && n0 + col < K;
            cp_async16(bs + r * T::kLdn + col,
                       ok ? wk + static_cast<size_t>(c0 + r) * K + n0 + col
                          : w,
                       ok ? 16 : 0);
          }
        } else {
          for (int e = tid; e < T::BK * T::BN; e += kThreads) {
            const int r = e / T::BN;
            const int col = e % T::BN;
            bs[r * T::kLdn + col] =
                c0 + r < C && n0 + col < K
                    ? wk[static_cast<size_t>(c0 + r) * K + n0 + col]
                    : zero;
          }
        }
      }
      return;
    }
    // packed (C <= 16): k16 slice j holds live offset s * kSlices + j, its
    // channels 0..C-1 and zeros to 16; a slice past the live offsets is
    // not copied (compute skips it)
    const int l0 = s * kSlices;
    if (VEC) {
      for (int e = tid; e < T::BM * (T::BK / 8); e += kThreads) {
        const int r = e / (T::BK / 8);
        const int col = (e % (T::BK / 8)) * 8;
        const int li = l0 + col / 16;
        if (li >= cnt) continue;
        const int c = col % 16;
        const int p = rows[list[li] * T::BM + r];
        const bool ok = p >= 0 && c < C;
        cp_async16(as + r * T::kLdk + col,
                   ok ? x + static_cast<size_t>(p) * C + c : x, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < T::BM * T::BK; e += kThreads) {
        const int r = e / T::BK;
        const int col = e % T::BK;
        const int li = l0 + col / 16;
        if (li >= cnt) continue;
        const int c = col % 16;
        const int p = rows[list[li] * T::BM + r];
        as[r * T::kLdk + col] =
            p >= 0 && c < C ? x[static_cast<size_t>(p) * C + c] : zero;
      }
    }
    if (TRANS) {  // W[k] [K][C] -> bs [BN][kLdk]
      for (int e = tid; e < T::BN * T::BK / (w_vec ? 8 : 1); e += kThreads) {
        const int r = w_vec ? e / (T::BK / 8) : e / T::BK;
        const int col = w_vec ? (e % (T::BK / 8)) * 8 : e % T::BK;
        const int li = l0 + col / 16;
        if (li >= cnt) continue;
        const int c = col % 16;
        const bool ok = n0 + r < K && c < C;
        const __nv_bfloat16* src_w =
            w + (static_cast<size_t>(k0 + list[li]) * K + n0 + r) * C + c;
        if (w_vec) {
          cp_async16(bs + r * T::kLdk + col, ok ? src_w : w, ok ? 16 : 0);
        } else {
          bs[r * T::kLdk + col] = ok ? *src_w : zero;
        }
      }
    } else {  // W[k] [C][K] -> bs [BK][kLdn]
      for (int e = tid; e < T::BK * T::BN / (w_vec ? 8 : 1); e += kThreads) {
        const int r = w_vec ? e / (T::BN / 8) : e / T::BN;
        const int col = w_vec ? (e % (T::BN / 8)) * 8 : e % T::BN;
        const int li = l0 + r / 16;
        if (li >= cnt) continue;
        const int c = r % 16;
        const bool ok = c < C && n0 + col < K;
        const __nv_bfloat16* src_w =
            w + (static_cast<size_t>(k0 + list[li]) * C + c) * K + n0 + col;
        if (w_vec) {
          cp_async16(bs + r * T::kLdn + col, ok ? src_w : w, ok ? 16 : 0);
        } else {
          bs[r * T::kLdn + col] = ok ? *src_w : zero;
        }
      }
    }
  };

  // The warp's MMAs of step s, on ring stage s % kStages.  The masks of
  // the step's k16 slices are read first; then every fragment of a slice
  // is loaded before its first MMA, and the MMAs of a live 16-row tile run
  // with no branch between them, so that ptxas overlaps the ldmatrix
  // latencies with the tensor-core work.
  auto compute = [&](int s) {
    if (!warp_cols) return;
    const __nv_bfloat16* as = ring + (s % kStages) * kStageElems;
    const __nv_bfloat16* bs = as + kAElems;
    // bit mi of ms[ks]: the warp's mi-th 16 rows match somewhere at slice
    // ks's offset; 0 for a slice past C or past the live offsets
    constexpr unsigned kMask = (1u << T::MI) - 1u;
    unsigned ms[kSlices];
    if (PACKED) {
#pragma unroll
      for (int ks = 0; ks < kSlices; ++ks) {
        const int li = s * kSlices + ks;
        ms[ks] = li < cnt ? (live[list[li]] >> (wm * T::MI)) & kMask : 0u;
      }
    } else {
      const int c0 = (s % nchunks) * T::BK;
      const unsigned m = (live[list[s / nchunks]] >> (wm * T::MI)) & kMask;
#pragma unroll
      for (int ks = 0; ks < kSlices; ++ks) ms[ks] = c0 + ks * 16 < C ? m : 0u;
    }
#pragma unroll
    for (int ks = 0; ks < kSlices; ++ks) {
      const unsigned m = ms[ks];
      if (m == 0u) continue;
      unsigned a[T::MI][4];
      unsigned b[T::NI / 2][4];
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        const int nl = wn * T::WN + nj * 16;  // the n8 pair's first column
        if (TRANS) {
          ldsm_x4(b[nj], bs + (nl + (lane >> 4) * 8 + (lane & 7)) * T::kLdk +
                             ks * 16 + ((lane >> 3) & 1) * 8);
        } else {
          ldsm_x4_trans(b[nj], bs + (ks * 16 + (lane & 15)) * T::kLdn + nl +
                                   (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        ldsm_x4(a[mi], as + (wm * T::WM + mi * 16 + (lane & 15)) * T::kLdk +
                           ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        if (!(m >> mi & 1u)) continue;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                   b[ni / 2][(ni % 2) * 2 + 1]);
        }
      }
    }
  };

  for (int k0 = 0; k0 < kv; k0 += kGroup) {
    // the group's rows, live bits and live offsets (dg_search.cuh)
    cnt = dg::stage_group<T::BM>(src, rows, live, list, count, k0,
                                 min(kGroup, kv - k0), row0);
    const int steps =
        PACKED ? (cnt + kSlices - 1) / kSlices : cnt * nchunks;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load(s, k0);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();  // step s has landed (this thread's)
      __syncthreads();  // ... everyone's, and step s - 1's stage is free
      if (s + kStages - 1 < steps) load(s + kStages - 1, k0);
      cp_async_commit();
      compute(s);
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every warp's last MMAs have read the ring

  // Epilogue: bf16 in registers, staged [BM][kLdn] in the ring, stored 16
  // bytes a thread.
  __nv_bfloat16* os = ring;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int r = wm * T::WM + mi * 16 + lane / 4;
      const int col = wn * T::WN + ni * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(os + r * T::kLdn + col) =
          __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<__nv_bfloat162*>(os + (r + 8) * T::kLdn + col) =
          __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  __syncthreads();
  const bool o_vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int e = tid; e < T::BM * (T::BN / 8); e += kThreads) {
    const int r = e / (T::BN / 8);
    const int col = (e % (T::BN / 8)) * 8;
    if (row0 + r >= n || n0 + col >= K) continue;
    const __nv_bfloat16* o = os + r * T::kLdn + col;
    __nv_bfloat16* dst = out + static_cast<size_t>(row0 + r) * K + n0 + col;
    if (o_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int j = 0; j < 8 && n0 + col + j < K; ++j) dst[j] = o[j];
    }
  }
}

template <class T, bool TRANS, bool VEC, bool PACKED, class Src>
int launch_variant(const void* x, const void* w, Src src, void* out, int n,
                   int C, int K, int kv, cudaStream_t s) {
  auto* kern = dg_fwd_bf16_kernel<T, TRANS, VEC, PACKED, Src>;
  constexpr int smem = T::smem_bytes(TRANS);
  // above 48 KB only by this opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n + T::BM - 1) / T::BM, (K + T::BN - 1) / T::BN);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), src,
      static_cast<__nv_bfloat16*>(out), n, C, K, kv);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of tile T for (trans, vec, C <= 16)
template <class T, bool TRANS, class Src>
int launch_trans(const void* x, const void* w, Src src, void* out, int n,
                 int C, int K, int kv, int vec, cudaStream_t s) {
  if (C <= 16) {
    return vec ? launch_variant<T, TRANS, true, true>(x, w, src, out, n, C,
                                                      K, kv, s)
               : launch_variant<T, TRANS, false, true>(x, w, src, out, n, C,
                                                       K, kv, s);
  }
  return vec ? launch_variant<T, TRANS, true, false>(x, w, src, out, n, C, K,
                                                     kv, s)
             : launch_variant<T, TRANS, false, false>(x, w, src, out, n, C,
                                                      K, kv, s);
}

template <class T, class Args>
int launch_tile(const void* x, const void* w, const Args& args, void* out,
                int n, int C, int K, int kv, int vec, int trans,
                cudaStream_t s) {
  auto src = args.template make<T::BM>();
  return trans ? launch_trans<T, true>(x, w, src, out, n, C, K, kv, vec, s)
               : launch_trans<T, false>(x, w, src, out, n, C, K, kv, vec, s);
}

template <class Args>
int launch(const void* x, const void* w, const Args& args, void* out, int n,
           int C, int K, int kv, int tile, int vec, int trans, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch_tile<Tile0>(x, w, args, out, n, C, K, kv, vec, trans, s);
    case 1:
      return launch_tile<Tile1>(x, w, args, out, n, C, K, kv, vec, trans, s);
    case 2:
      return launch_tile<Tile2>(x, w, args, out, n, C, K, kv, vec, trans, s);
    case 3:
      return launch_tile<Tile3>(x, w, args, out, n, C, K, kv, vec, trans, s);
    case 4:
      return launch_tile<Tile4>(x, w, args, out, n, C, K, kv, vec, trans, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace b2

dim3 tile_grid(int n, int K) { return dim3((n + BM - 1) / BM, (K + BN - 1) / BN); }

template <class Src>
int launch_f32(const void* x, const void* w, Src src, void* out, int n,
               int C, int K, int kv, void* stream) {
  dg_fwd_f32_kernel<Src><<<tile_grid(n, K), kF32Threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), src,
      static_cast<float*>(out), n, C, K, kv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dg_fwd_f32_launch(const void* x, const void* w, const void* pos,
                                 void* out, int n, int C, int K, int kv,
                                 void* stream) {
  return launch_f32(x, w, dg::TableTile<BM>{static_cast<const int*>(pos), n},
                    out, n, C, K, kv, stream);
}

// tile: the variant (b2::Tile0..4, ops/dg_conv.py::b2_variant); vec: the
// 16-byte gather; trans: w is [kv, K, C] (W[k]^T, dgrad's weight as it is).
// C <= 16 takes the tile's PACKED instantiation.
extern "C" int dg_fwd_bf16_launch(const void* x, const void* w,
                                  const void* pos, void* out, int n, int C,
                                  int K, int kv, int tile, int vec, int trans,
                                  void* stream) {
  return b2::launch(x, w, dg::TableArgs{static_cast<const int*>(pos), n},
                    out, n, C, K, kv, tile, vec, trans, stream);
}

// Search mode: keys [n] ascending with the sentinel tail, geom (host
// memory) as dg_pos_launch's; reverse != 0 negates every displacement (the
// input gradient's probes, on W[k]^T).
extern "C" int dg_fwd_search_f32_launch(const void* x, const void* w,
                                        const void* keys, void* out, int n,
                                        int C, int K, int kv,
                                        const int* geom, int sentinel,
                                        int reverse, void* stream) {
  return launch_f32(x, w,
                    dg::SearchTile<BM>{static_cast<const int*>(keys), n, kv,
                                       dg::subm_geom(geom), sentinel,
                                       reverse},
                    out, n, C, K, kv, stream);
}

extern "C" int dg_fwd_search_bf16_launch(const void* x, const void* w,
                                         const void* keys, void* out, int n,
                                         int C, int K, int kv,
                                         const int* geom, int sentinel,
                                         int reverse, int tile, int vec,
                                         int trans, void* stream) {
  return b2::launch(x, w,
                    dg::SearchArgs{static_cast<const int*>(keys), n, kv,
                                   dg::subm_geom(geom), sentinel, reverse},
                    out, n, C, K, kv, tile, vec, trans, stream);
}
