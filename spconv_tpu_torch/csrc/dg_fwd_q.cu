// B7 `dg_fwd_q`: int8 gather-GEMM through a cached match table, with the
// fused scale / bias / residual / ReLU / requant epilogue.
//
// Replaces: spconv_tpu/ops/pallas/dg_conv.py::_dg_fwd_kernel in packmode
//   "q4" (launched by _dg_conv_call_q; public entries dg_subm_conv_q and
//   dg_regular_conv_q, called from quantization/quantize.py), and so also
//   sorted_conv.py::_sk_fwd_kernel_q (B8), which computes the subm function
//   through a one-hot key join.  The TPU kernel quad-packs four int8
//   channels per int32 lane, DMAs window-planned lane-chunked tables and
//   writes a transposed [k_sub, R*128] tile; those layouts exist for Mosaic.
//   Here the matched rows are gathered straight from the row-major [N, C]
//   int8 features, as B2 (dg_fwd.cu) does for bf16.
//
// Computes: acc[i, :] = sum_k x[pos[k, i], :] @ W[k] in int32 (exact in any
//   order), then per output channel j, step by step as the TPU kernel's
//   epilogue (dg_conv.py:683-693):
//     y = f32(acc) * scale[j];  y += bias[j];
//     y += f32(add[i, j]) * add_scale;
//     y = max(y, 0) (relu);  out = int8(clip(round_half_even(y), -127, 127)).
//   x [N_src, C] int8, W read as W[k]^T from wt [kv, K, C] int8 (the
//   wrapper's, or the module's folded copy), pos [kv, N_dst] int32 (-1 = no
//   match), scale and bias [K] f32, add [N_dst, K] int8 (subm only).  Every
//   float op is rounded on its own (__fmul_rn / __fadd_rn, so nvcc cannot
//   contract a*b+c into an FMA), and the int32 -> f32 conversion rounds to
//   nearest (|acc| can exceed 2^24): the result is bit-equal to the plain
//   version and the TPU kernel.  A row with no match gets the epilogue of
//   acc = 0, as on the TPU; the module zeroes inactive rows.
//
// Bound on the H100: at CenterPoint's widths (C, K = 16..128, ~5-9 of 27
//   offsets matched per row) the work is ~2 * C * K ops per matched pair,
//   far below the int8 tensor-core ridge, so the bytes bound it: the int8
//   features (read once per matching offset, from L2), the [kv, N] int32
//   table and the int8 output.
//
// Its first design was the pre-Hopper B2 loop in int8: a fixed 64 x 64
//   tile, one-byte gathers and weight loads behind a shared read of the
//   row index, two barriers per (offset, 64-channel step) and nothing in
//   flight during the 16x16x16 s8 WMMAs, every row of a live offset
//   multiplied, C = 5 padded to a 16-channel plane at every offset, and an
//   int32 staging tile with per-element global reads of scale, bias and
//   add.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) it took 7.37
//   ms per int8 CenterPoint request on the subm path (83x its bound).
//
// Design, B2's applied to int8, one part per cause:
//   - Gathers in flight: each matched row's chunk is copied with 16-byte
//     cp.async.cg (16 channels; a source size of 0 zero-fills unmatched
//     rows and channels past C) into a ring of kStages shared-memory stages,
//     W[k]^T's chunk beside it, so kStages - 1 steps' copies are in flight
//     while the current step multiplies.  One barrier per step.
//   - Tensor cores from ldmatrix: mma.sync.m16n8k32 s8 -> s32.  A (the
//     gathered rows, channels contiguous) and B (W[k]^T, channels
//     contiguous: ldmatrix.trans moves 16-bit elements and cannot transpose
//     int8, so the weight is read as [kv, K, C]) both come from plain
//     ldmatrix.x4, rows pitched 16 bytes past BK: an odd number of 16-byte
//     units, conflict-free.  A k32 slice's fragments are all loaded before
//     its MMAs.
//   - One gather per row for all of K: a block owns BM rows and, for
//     K <= 128, every output column (BN = 16, 32, 64 or 128, the narrowest
//     that covers K), so each matched row is gathered, and in search mode
//     searched, once per offset.  Column tiles remain past 128 and where N
//     is too small to give the card a wave of blocks.  The tile is a
//     variant chosen by the wrapper (ops/dg_conv.py::b7_variant).  A step
//     is BK = 128 input channels (64 for the 128-wide tile): the bytes of
//     B2's BK = 64 (32).
//   - Skipping: the block's rows of a group of up to 32 offsets are staged
//     at once (dg::stage_group; the table's rows with 4-byte cp.async, all
//     in flight), with one live bit per 16 rows: an offset that matches
//     nowhere in the block takes no step, and a warp skips the MMAs of its
//     16-row tiles that match nothing at a slice's offsets.
//   - Narrow C: with C <= BK / 2 (PACKED) a step holds several offsets,
//     each in a slot of C rounded up to 16 (C <= 16) or 32 channels, zero
//     weights past C: with C <= 16 a k32 slice holds two offsets, so a 3^3
//     conv on 5 channels takes 14 k32 slices, not 27; with C = 32 or 64 a
//     step of 128 channels holds 4 or 2 offsets, so a block takes 4 or 2
//     times fewer steps (barriers, waits) for the same slices.
//   - C % 16 != 0 or a feature pointer off 16 bytes: the scalar-gather
//     variant (`VEC` false) loads each 16-byte chunk of a row as up to 16
//     byte loads, all in flight, and stores it at once, zeros past C, into
//     the same ring.  A weight whose rows are not 16-byte vectors is loaded
//     byte by byte inside any variant.
//   - Epilogue from registers: each thread reads the scale and bias of its
//     columns once, its outputs' residuals from a [BM, BN] int8 tile that
//     the block loads 16 bytes a thread into the ring, writes the int8
//     results over them, and the block stores the tile 16 bytes a thread.
//   - Determinism: integer sums are exact in any order; no atomics.
//
// Search mode (`dg_fwd_q_search_launch`, S4): the same kernel with the
//   block's rows from an in-block search of the sorted keys instead of the
//   table (dg_search.cuh), replacing packmode q4 with posmode=False
//   (launched at dg_conv.py:1152 from dg_subm_conv_q :1162 with pos=None).
//   The mainloop and the epilogue are the table mode's and the search finds
//   exactly B1's rows, so the output is bit-equal to B1 followed by the
//   table mode.
//
// Instantiations: 4 tiles x VEC x PACKED x table / search = 32.

#include <cuda_runtime.h>

#include <cstdint>

#include "dg_search.cuh"
#include "sm90_mma.cuh"

namespace {
namespace b7 {

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 4;     // depth of the shared-memory ring
constexpr int kGroup = dg::kSearchGroup;  // offsets whose rows are staged
static_assert(kGroup == 32, "one lane per offset of a group");

// A block's output tile: BM rows x BN columns on WARPS_M x WARPS_N warps,
// each warp MI m16 tiles x NI n8 tiles, BK input channels (bytes) a
// pipeline step.  ops/dg_conv.py's B7_TILES and b7_smem_bytes mirror the
// tiles and their shared memory.
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
  // bytes of a staged row: the A chunk's and the B chunk's (BK + 16), the
  // epilogue tile's (BN + 16); odd numbers of 16-byte units, so the 8 rows
  // of an ldmatrix hit 8 different bank groups
  static constexpr int kLd = BK + 16;
  static constexpr int kLdo = BN + 16;
  static_assert(BK % 64 == 0, "whole k32 slices of packed offset pairs");
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole ldmatrix.x4 tiles");

  // the ring's stage: the A chunk [BM][kLd], then W[k]^T's [BN][kLd]
  __host__ __device__ static constexpr int a_bytes() { return BM * kLd; }
  __host__ __device__ static constexpr int stage_bytes() {
    return (BM + BN) * kLd;
  }
  __host__ __device__ static constexpr int ring_bytes() {
    return kStages * stage_bytes();
  }
  // the ring, then rows [kGroup][BM], live bits [kGroup], the live
  // offsets [kGroup] and their count
  __host__ __device__ static constexpr int smem_bytes() {
    return ring_bytes() + (kGroup * BM + 2 * kGroup + 1) * 4;
  }
};

// B7's tiles, by variant number
using Tile0 = Tile<128, 16, 8, 1, 128>;
using Tile1 = Tile<128, 32, 8, 1, 128>;
using Tile2 = Tile<64, 64, 4, 2, 128>;
using Tile3 = Tile<64, 128, 2, 4, 64>;

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4;
using sm90::mma_s8;

// T: the Tile; VEC: 16-byte gathers of x's rows (C % 16 == 0, x 16-byte
// aligned), else byte loads; PACKED: C <= BK / 2, several offsets a step;
// Src: where the rows come from (dg::TableTile<BM> or dg::SearchTile<BM>).
template <class T, bool VEC, bool PACKED, class Src>
__global__ void __launch_bounds__(kThreads, 2)
dg_fwd_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                Src src, const float* __restrict__ scale,
                const float* __restrict__ bias,
                const int8_t* __restrict__ add, float add_scale, int relu,
                int8_t* __restrict__ out, int n, int C, int K, int kv) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int* rows = reinterpret_cast<int*>(smem + T::ring_bytes());
  unsigned* live = reinterpret_cast<unsigned*>(rows + kGroup * T::BM);
  int* list = reinterpret_cast<int*>(live + kGroup);
  int* count = list + kGroup;
  static_assert(T::BM * T::kLdo <= T::ring_bytes(),
                "the epilogue's tile fits the ring");

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // warps along M vary fastest: the warps of one column stripe sit on
  // different SM sub-partitions
  const int wm = warp % T::WARPS_M;
  const int wn = warp / T::WARPS_M;
  const int row0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  // A step multiplies BK input channels.  With C > BK / 2: a BK-channel
  // chunk of one offset (the offset's chunks ascending).  With C <= BK / 2
  // (PACKED): several offsets, each in its own slot of sw channels (C
  // rounded up to 16 for C <= 16, else to 32; zero weights past C), BK / sw
  // offsets a step; a k32 slice then holds two offsets (sw = 16) or a part
  // of one.  Integer sums: the order of the slices does not matter.
  const int nchunks = PACKED ? 1 : (C + T::BK - 1) / T::BK;
  const int sw_log2 = C <= 16 ? 4 : C <= 32 ? 5 : 6;  // PACKED: C <= 64
  const int sw = 1 << sw_log2;
  const int slots = PACKED ? T::BK >> sw_log2 : 1;  // offsets a step
  constexpr int kSlices = T::BK / 32;  // k32 slices a step
  constexpr int kChunks = T::BK / 16;  // 16-byte chunks of a staged row
  // W[k]^T's rows (C long) as 16-byte vectors
  const bool w_vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  // the warp's columns hold output columns: else its MMAs would all multiply
  // the zero columns past K
  const bool warp_cols = n0 + wn * T::WN < K;
  int cnt = 0;  // live offsets of the current group

  int acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;
    }
  }

  // Step s's first live offset, as an index l0 into list, and (C > BK / 2)
  // its first channel c0.
  auto step_base = [&](int s, int* l0, int* c0) {
    *l0 = PACKED ? s * slots : s / nchunks;
    *c0 = PACKED ? 0 : s % nchunks * T::BK;
  };
  // Where the 16 bytes at channel q * 16 of a staged row of the step from
  // (l0, c0) come from: the live offset's index li into list (cnt or
  // more: none) and the offset's channel c.
  auto chunk = [&](int l0, int c0, int q, int* li, int* c) {
    *li = PACKED ? l0 + (q * 16 >> sw_log2) : l0;
    *c = PACKED ? q * 16 & (sw - 1) : c0 + q * 16;
  };

  // Copies step s's A and B chunks into ring stage s % kStages: A [BM][BK]
  // from the matched rows, B [BN][BK] from W[k]^T; zeros for unmatched rows,
  // and in B for channels past C, columns past K and packed slots past the
  // live offsets (the A chunk is left as it is there).
  auto load = [&](int s, int k0) {
    int8_t* as = ring + (s % kStages) * T::stage_bytes();
    int8_t* bs = as + T::a_bytes();
    int l0;
    int c0;
    step_base(s, &l0, &c0);
    constexpr int kA = (T::BM * kChunks + kThreads - 1) / kThreads;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      if (e >= T::BM * kChunks) break;
      const int r = e / kChunks;
      const int q = e % kChunks;
      int li;
      int c;
      chunk(l0, c0, q, &li, &c);
      if (li >= cnt) continue;
      const int p = rows[list[li] * T::BM + r];
      int8_t* dst = as + r * T::kLd + q * 16;
      if (VEC) {
        const bool ok = p >= 0 && c < C;
        cp_async16(dst, ok ? x + static_cast<size_t>(p) * C + c : x,
                   ok ? 16 : 0);
      } else {
        // byte loads, all in flight, into one 16-byte store
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (p >= 0 && c < C) {
          const int8_t* src = x + static_cast<size_t>(p) * C + c;
          const int m = min(16, C - c);
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (b < m) {
              v[b / 4] |= static_cast<unsigned>(
                              static_cast<uint8_t>(__ldg(src + b)))
                          << (8 * (b % 4));
            }
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (w_vec) {  // W[k]^T [K][C] -> bs [BN][kLd]
      for (int e = tid; e < T::BN * kChunks; e += kThreads) {
        const int r = e / kChunks;
        const int q = e % kChunks;
        int li;
        int c;
        chunk(l0, c0, q, &li, &c);
        const bool ok = li < cnt && n0 + r < K && c < C;
        cp_async16(bs + r * T::kLd + q * 16,
                   ok ? wt + (static_cast<size_t>(k0 + list[li]) * K + n0 +
                              r) * C + c
                      : wt,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < T::BN * T::BK; e += kThreads) {
        const int r = e / T::BK;
        const int col = e % T::BK;
        int li;
        int c;
        chunk(l0, c0, col / 16, &li, &c);
        c += col % 16;
        bs[r * T::kLd + col] =
            li < cnt && n0 + r < K && c < C
                ? wt[(static_cast<size_t>(k0 + list[li]) * K + n0 + r) * C +
                     c]
                : int8_t{0};
      }
    }
  };

  // The warp's MMAs of step s, on ring stage s % kStages.  The masks of
  // the step's k32 slices are read first; then every fragment of a slice
  // is loaded before its first MMA, and the MMAs of a live 16-row tile run
  // with no branch between them.
  auto compute = [&](int s) {
    if (!warp_cols) return;
    const int8_t* as = ring + (s % kStages) * T::stage_bytes();
    const int8_t* bs = as + T::a_bytes();
    // bit mi of ms[ks]: the warp's mi-th 16 rows match somewhere at slice
    // ks's offsets; 0 for a slice past C or past the live offsets
    constexpr unsigned kMask = (1u << T::MI) - 1u;
    unsigned ms[kSlices];
    int l0;
    int c0;
    step_base(s, &l0, &c0);
#pragma unroll
    for (int ks = 0; ks < kSlices; ++ks) {
      int li;
      int c;
      chunk(l0, c0, 2 * ks, &li, &c);
      unsigned m = li < cnt && c < C ? live[list[li]] : 0u;
      // sw = 16: the slice's second half holds the next offset
      if (PACKED && sw == 16 && li + 1 < cnt) m |= live[list[li + 1]];
      ms[ks] = (m >> (wm * T::MI)) & kMask;
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
        ldsm_x4(b[nj], bs + (nl + (lane >> 4) * 8 + (lane & 7)) * T::kLd +
                           ks * 32 + ((lane >> 3) & 1) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        ldsm_x4(a[mi], as + (wm * T::WM + mi * 16 + (lane & 15)) * T::kLd +
                           ks * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        if (!(m >> mi & 1u)) continue;
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) {
          mma_s8(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                 b[ni / 2][(ni % 2) * 2 + 1]);
        }
      }
    }
  };

  for (int k0 = 0; k0 < kv; k0 += kGroup) {
    // the group's rows, live bits and live offsets (dg_search.cuh)
    cnt = dg::stage_group<T::BM>(src, rows, live, list, count, k0,
                                 min(kGroup, kv - k0), row0);
    const int steps = PACKED ? (cnt + slots - 1) / slots : cnt * nchunks;
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

  // Epilogue: the block's [BM][BN] int8 tile os in the ring, the residual
  // loaded into it 16 bytes a thread, each output's float steps from
  // registers, written over its residual, the tile stored 16 bytes a
  // thread.
  int8_t* os = ring;
  const bool o_vec =
      K % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (add != nullptr) {
    const bool a_vec =
        K % 16 == 0 && (reinterpret_cast<uintptr_t>(add) & 15) == 0;
    for (int e = tid; e < T::BM * (T::BN / 16); e += kThreads) {
      const int r = e / (T::BN / 16);
      const int col = (e % (T::BN / 16)) * 16;
      if (row0 + r >= n || n0 + col >= K) continue;
      const int8_t* a = add + static_cast<size_t>(row0 + r) * K + n0 + col;
      int8_t* o = os + r * T::kLdo + col;
      if (a_vec) {
        *reinterpret_cast<uint4*>(o) = __ldg(reinterpret_cast<const uint4*>(a));
      } else {
        for (int q = 0; q < 16 && n0 + col + q < K; ++q) o[q] = a[q];
      }
    }
    __syncthreads();
  }
  if (warp_cols) {
    // the scale and bias of the thread's output columns (0 past K), read
    // once for all of its rows
    float sc[T::NI][2];
    float bi[T::NI][2];
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = n0 + wn * T::WN + ni * 8 + (lane % 4) * 2 + q;
        sc[ni][q] = j < K ? scale[j] : 0.f;
        bi[ni][q] = j < K && bias != nullptr ? bias[j] : 0.f;
      }
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows lane / 4 and lane / 4 + 8
          const int r = wm * T::WM + mi * 16 + lane / 4 + h * 8;
          const int col = wn * T::WN + ni * 8 + (lane % 4) * 2;
          char2* o = reinterpret_cast<char2*>(os + r * T::kLdo + col);
          const char2 res = add != nullptr ? *o : make_char2(0, 0);
          int8_t v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float y = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + q]),
                                sc[ni][q]);
            if (bias != nullptr) y = __fadd_rn(y, bi[ni][q]);
            if (add != nullptr) {
              y = __fadd_rn(y, __fmul_rn(static_cast<float>(q ? res.y : res.x),
                                         add_scale));
            }
            if (relu) y = fmaxf(y, 0.f);
            y = fminf(fmaxf(rintf(y), -127.f), 127.f);
            v[q] = static_cast<int8_t>(static_cast<int>(y));
          }
          *o = make_char2(v[0], v[1]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < T::BM * (T::BN / 16); e += kThreads) {
    const int r = e / (T::BN / 16);
    const int col = (e % (T::BN / 16)) * 16;
    if (row0 + r >= n || n0 + col >= K) continue;
    const int8_t* o = os + r * T::kLdo + col;
    int8_t* dst = out + static_cast<size_t>(row0 + r) * K + n0 + col;
    if (o_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int q = 0; q < 16 && n0 + col + q < K; ++q) dst[q] = o[q];
    }
  }
}

struct Epilogue {
  const float* scale;
  const float* bias;
  const int8_t* add;
  float add_scale;
  int relu;
};

template <class T, bool VEC, bool PACKED, class Src>
int launch_variant(const void* x, const void* wt, Src src, const Epilogue& ep,
                   void* out, int n, int C, int K, int kv, cudaStream_t s) {
  auto* kern = dg_fwd_q_kernel<T, VEC, PACKED, Src>;
  constexpr int smem = T::smem_bytes();
  // above 48 KB only by this opt-in, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n + T::BM - 1) / T::BM, (K + T::BN - 1) / T::BN);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), src,
      ep.scale, ep.bias, ep.add, ep.add_scale, ep.relu,
      static_cast<int8_t*>(out), n, C, K, kv);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of tile T for (vec, C <= BK / 2)
template <class T, class Args>
int launch_tile(const void* x, const void* wt, const Args& args,
                const Epilogue& ep, void* out, int n, int C, int K, int kv,
                int vec, cudaStream_t s) {
  auto src = args.template make<T::BM>();
  if (C <= T::BK / 2) {
    return vec ? launch_variant<T, true, true>(x, wt, src, ep, out, n, C, K,
                                               kv, s)
               : launch_variant<T, false, true>(x, wt, src, ep, out, n, C, K,
                                                kv, s);
  }
  return vec ? launch_variant<T, true, false>(x, wt, src, ep, out, n, C, K,
                                              kv, s)
             : launch_variant<T, false, false>(x, wt, src, ep, out, n, C, K,
                                               kv, s);
}

template <class Args>
int launch(const void* x, const void* wt, const Args& args,
           const Epilogue& ep, void* out, int n, int C, int K, int kv,
           int tile, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch_tile<Tile0>(x, wt, args, ep, out, n, C, K, kv, vec, s);
    case 1:
      return launch_tile<Tile1>(x, wt, args, ep, out, n, C, K, kv, vec, s);
    case 2:
      return launch_tile<Tile2>(x, wt, args, ep, out, n, C, K, kv, vec, s);
    case 3:
      return launch_tile<Tile3>(x, wt, args, ep, out, n, C, K, kv, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace b7
}  // namespace

// wt: the weight as W[k]^T, [kv, K, C]; bias and add may be null (no bias,
// no residual); tile: the variant (b7::Tile0..3, ops/dg_conv.py::
// b7_variant); vec: the 16-byte gather.  C <= BK / 2 takes the tile's
// PACKED instantiation.
extern "C" int dg_fwd_q_launch(const void* x, const void* wt, const void* pos,
                               const void* scale, const void* bias,
                               const void* add, float add_scale, int relu,
                               void* out, int n, int C, int K, int kv,
                               int tile, int vec, void* stream) {
  return b7::launch(
      x, wt, dg::TableArgs{static_cast<const int*>(pos), n},
      b7::Epilogue{static_cast<const float*>(scale),
                   static_cast<const float*>(bias),
                   static_cast<const int8_t*>(add), add_scale, relu},
      out, n, C, K, kv, tile, vec, stream);
}

// Search mode: keys [n] ascending with the sentinel tail, geom (host
// memory) as dg_pos_launch's.
extern "C" int dg_fwd_q_search_launch(const void* x, const void* wt,
                                      const void* keys, const void* scale,
                                      const void* bias, const void* add,
                                      float add_scale, int relu, void* out,
                                      int n, int C, int K, int kv,
                                      const int* geom, int sentinel,
                                      int tile, int vec, void* stream) {
  return b7::launch(
      x, wt,
      dg::SearchArgs{static_cast<const int*>(keys), n, kv,
                     dg::subm_geom(geom), sentinel, 0},
      b7::Epilogue{static_cast<const float*>(scale),
                   static_cast<const float*>(bias),
                   static_cast<const int8_t*>(add), add_scale, relu},
      out, n, C, K, kv, tile, vec, stream);
}
