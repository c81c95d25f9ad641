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
//   int8 features, as B2 (dg_fwd.cu) does for f32/bf16.
//
// Computes: acc[i, :] = sum_k x[pos[k, i], :] @ W[k] in int32 (exact in any
//   order), then per output channel j, step by step as the TPU kernel's
//   epilogue (dg_conv.py:683-693):
//     y = f32(acc) * scale[j];  y += bias[j];
//     y += f32(add[i, j]) * add_scale;
//     y = max(y, 0) (relu);  out = int8(clip(round_half_even(y), -127, 127)).
//   x [N_src, C] int8, W [kv, C, K] int8, pos [kv, N_dst] int32 (-1 = no
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
//   features (read once per matching offset), the [kv, N] int32 table and
//   the int8 output.
//
// Design (simple first; wgmma, TMA, pipelining and narrow tiles for C = 5/16
//   are later work): a block owns a 64 x 64 output tile, as B2's.  Per
//   offset k it loads the tile's 64 match rows and skips the offset when
//   none matches; per step of up to 64 input channels it gathers the
//   matched int8 rows into shared memory (zeros where pos is -1 and past C,
//   so C = 5 is padded to 16), loads W[k]'s chunk, and multiplies on the
//   tensor cores with 16x16x16 s8 WMMA fragments and int32 accumulators.
//   Shared tiles are stored as planes of 16 channels ([plane][row][16]), so
//   every fragment starts 256-bit aligned and its ldm is 16 bytes.  Only the
//   planes that hold channels are loaded and multiplied, and a warp whose 32
//   columns lie past K skips its MMAs.  The epilogue reads the int32 tile
//   back from shared memory.
//
// Search mode (`dg_fwd_q_search_launch`, S4): the same kernel with the
//   tile's rows from an in-block search of the sorted keys instead of the
//   table (dg_search.cuh), replacing packmode q4 with posmode=False
//   (launched at dg_conv.py:1152 from dg_subm_conv_q :1162 with pos=None).
//   The mainloop and the epilogue are the table mode's and the search finds
//   exactly B1's rows, so the output is bit-equal to B1 followed by the
//   table mode.

#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "dg_search.cuh"

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output channels per block
constexpr int KP = 16;        // channels per plane: the MMA's depth
constexpr int NP = 4;         // planes per step: 64 input channels
constexpr int BK = KP * NP;
constexpr int LDC = BN + 4;   // int32 tile pitch: a multiple of 4 ints
constexpr int kThreads = 128; // 2 x 2 warps, 32 x 32 outputs each

// Src: where the tile's rows come from (dg::TableTile or dg::SearchTile).
template <class Src>
__global__ void __launch_bounds__(kThreads)
dg_fwd_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                Src src, const float* __restrict__ scale,
                const float* __restrict__ bias,
                const int8_t* __restrict__ add, float add_scale, int relu,
                int8_t* __restrict__ out, int n, int C, int K, int kv) {
  using namespace nvcuda;
  __shared__ __align__(32) signed char As[NP][BM][KP];  // plane, row, chan
  __shared__ __align__(32) signed char Bs[NP][BN][KP];  // plane, col, chan
  __shared__ __align__(32) int Cs[BM][LDC];
  __shared__ int rows[Src::kSmem];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2;  // warp's 32-row half of the tile
  const int wc = warp % 2;  // warp's 32-column half of the tile
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const bool warp_live = col0 + wc * 32 < K;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  }

  for (int k = 0; k < kv; ++k) {
    const int* sp = src.tile(rows, k, row0);
    if (sp == nullptr) continue;
    for (int c0 = 0; c0 < C; c0 += BK) {
      const int planes = min(NP, (C - c0 + KP - 1) / KP);
      const int width = planes * KP;
      for (int e = tid; e < BM * width; e += kThreads) {
        const int r = e / width;
        const int c = e % width;
        const int pr = sp[r];
        signed char v = 0;
        if (pr >= 0 && c0 + c < C) {
          v = x[static_cast<size_t>(pr) * C + c0 + c];
        }
        As[c / KP][r][c % KP] = v;
      }
      for (int e = tid; e < width * BN; e += kThreads) {
        const int c = e / BN;
        const int col = e % BN;
        signed char v = 0;
        if (c0 + c < C && col0 + col < K) {
          v = w[(static_cast<size_t>(k) * C + c0 + c) * K + col0 + col];
        }
        Bs[c / KP][col][c % KP] = v;
      }
      __syncthreads();
      if (warp_live) {
        for (int p = 0; p < planes; ++p) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major>
              a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::col_major>
              b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(a[i], &As[p][wr * 32 + i * 16][0], KP);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(b[j], &Bs[p][wc * 32 + j * 16][0], KP);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cs[wr * 32 + i * 16][wc * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN;
    const int col = e % BN;
    const int row = row0 + r;
    const int j = col0 + col;
    if (row >= n || j >= K) continue;
    const size_t o = static_cast<size_t>(row) * K + j;
    float y = __fmul_rn(__int2float_rn(Cs[r][col]), scale[j]);
    if (bias != nullptr) y = __fadd_rn(y, bias[j]);
    if (add != nullptr) {
      y = __fadd_rn(y, __fmul_rn(static_cast<float>(add[o]), add_scale));
    }
    if (relu) y = fmaxf(y, 0.f);
    y = fminf(fmaxf(rintf(y), -127.f), 127.f);
    out[o] = static_cast<int8_t>(static_cast<int>(y));
  }
}

template <class Src>
int launch(const void* x, const void* w, Src src, const void* scale,
           const void* bias, const void* add, float add_scale, int relu,
           void* out, int n, int C, int K, int kv, void* stream) {
  const dim3 grid((n + BM - 1) / BM, (K + BN - 1) / BN);
  dg_fwd_q_kernel<Src><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), src,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const int8_t*>(add), add_scale, relu,
      static_cast<int8_t*>(out), n, C, K, kv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bias and add may be null (no bias, no residual)
extern "C" int dg_fwd_q_launch(const void* x, const void* w, const void* pos,
                               const void* scale, const void* bias,
                               const void* add, float add_scale, int relu,
                               void* out, int n, int C, int K, int kv,
                               void* stream) {
  return launch(x, w, dg::TableTile<BM>{static_cast<const int*>(pos), n},
                scale, bias, add, add_scale, relu, out, n, C, K, kv, stream);
}

// Search mode: keys [n] ascending with the sentinel tail, geom (host
// memory) as dg_pos_launch's.
extern "C" int dg_fwd_q_search_launch(const void* x, const void* w,
                                      const void* keys, const void* scale,
                                      const void* bias, const void* add,
                                      float add_scale, int relu, void* out,
                                      int n, int C, int K, int kv,
                                      const int* geom, int sentinel,
                                      void* stream) {
  return launch(x, w,
                dg::SearchTile<BM>{static_cast<const int*>(keys), n, kv,
                                   dg::subm_geom(geom), sentinel, 0},
                scale, bias, add, add_scale, relu, out, n, C, K, kv, stream);
}
