// B2 `dg_fwd`: gather-GEMM forward of a submanifold conv through a cached
// match table ("posmode").
//
// Replaces: spconv_tpu/ops/pallas/dg_conv.py::_dg_fwd_kernel in packmodes
//   "f32" and "pack2" with posmode=True (launched by _dg_conv_call, public
//   entry dg_subm_conv).  The TPU kernel DMAs window-planned, lane-chunked,
//   transposed feature tables (bf16 channel pairs packed in int32 lanes),
//   lane-gathers the matched columns and runs one deep GEMM per 128-row tile.
//   Those layouts exist for Mosaic; here the matched rows are gathered
//   straight from the row-major [N, C] features.
//
// Computes: out[i, :] = sum_k x[pos[k, i], :] @ W[k], x [N, C] and
//   W [kv, C, K] in f32 or bf16, pos [kv, N] int32 (-1 = no match).  The sum
//   is kept in f32 and rounded once to the input dtype.  A row with no match
//   (every invalid row) ends as 0.
//
// Bound on the H100: at the benchmark net's widths (C, K = 64..256, ~9 of 27
//   offsets matched per row) a tile reads its gathered rows from L2/HBM
//   (~kv * BM * C * 2 bytes for bf16) and does 2 * kv * BM * BN * C flops, so
//   it sits above the bf16 ridge only if the multiply runs on the tensor
//   cores; the f32 variant is bound by FMA throughput.  The gather itself is
//   irregular: each matched row is one 2*C- or 4*C-byte segment.
//
// Design (simple first; wgmma, TMA and pipelining are later work): a block
//   owns a BM x BN tile of outputs.  It loops over offsets k and chunks of
//   BK input channels; per step it gathers the BM matched rows into shared
//   memory (zeros where pos is -1 or past C, which also covers C = 3), loads
//   the W[k] chunk, and multiplies: f32 FMAs from registers (f32), or
//   16x16x16 bf16 tensor-core MMAs (WMMA) with f32 accumulators (bf16).  An
//   offset whose whole row tile misses is skipped, which also makes the
//   all-invalid tail of a padded buffer cheap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // input channels per step

constexpr int kF32Threads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBf16Threads = 128;  // 2 x 2 warps, 32 x 32 outputs each

// Loads this block's match rows for offset k into sp; returns whether any
// row of the tile matches (block-wide, so the whole block skips together).
__device__ __forceinline__ bool load_tile_pos(const int* __restrict__ pos,
                                              int* sp, int k, int n,
                                              int row0) {
  int p = -1;
  if (threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    if (r < n) p = pos[static_cast<size_t>(k) * n + r];
    sp[threadIdx.x] = p;
  }
  return __syncthreads_or(p >= 0);
}

__global__ void __launch_bounds__(kF32Threads)
dg_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ pos, float* __restrict__ out, int n,
                  int C, int K, int kv) {
  __shared__ float As[BK][BM + 1];  // transposed gather tile, padded
  __shared__ float Bs[BK][BN];
  __shared__ int sp[BM];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4] = {};

  for (int k = 0; k < kv; ++k) {
    if (!load_tile_pos(pos, sp, k, n, row0)) continue;
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

__global__ void __launch_bounds__(kBf16Threads)
dg_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ out, int n, int C, int K,
                   int kv) {
  using namespace nvcuda;
  constexpr int LDA = BK + 8;  // row pitches: multiples of 8 elements and
  constexpr int LDB = BN + 8;  // of 32 bytes at every 16-row fragment
  constexpr int LDC = BN + 4;
  __shared__ __align__(32) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK][LDB];
  __shared__ __align__(32) float Cs[BM][LDC];
  __shared__ int sp[BM];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2;  // warp's 32-row half of the tile
  const int wc = warp % 2;  // warp's 32-column half of the tile
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int k = 0; k < kv; ++k) {
    if (!load_tile_pos(pos, sp, k, n, row0)) continue;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int e = tid; e < BM * BK; e += kBf16Threads) {
        const int r = e / BK;
        const int c = e % BK;
        const int pr = sp[r];
        __nv_bfloat16 v = zero;
        if (pr >= 0 && c0 + c < C) v = x[static_cast<size_t>(pr) * C + c0 + c];
        As[r][c] = v;
      }
      for (int e = tid; e < BK * BN; e += kBf16Threads) {
        const int c = e / BN;
        const int col = e % BN;
        __nv_bfloat16 v = zero;
        if (c0 + c < C && col0 + col < K) {
          v = w[(static_cast<size_t>(k) * C + c0 + c) * K + col0 + col];
        }
        Bs[c][col] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(a[i], &As[wr * 32 + i * 16][kk], LDA);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(b[j], &Bs[kk][wc * 32 + j * 16], LDB);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
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
  for (int e = tid; e < BM * BN; e += kBf16Threads) {
    const int r = e / BN;
    const int col = e % BN;
    if (row0 + r < n && col0 + col < K) {
      out[static_cast<size_t>(row0 + r) * K + col0 + col] =
          __float2bfloat16(Cs[r][col]);
    }
  }
}

dim3 tile_grid(int n, int K) { return dim3((n + BM - 1) / BM, (K + BN - 1) / BN); }

}  // namespace

extern "C" int dg_fwd_f32_launch(const void* x, const void* w, const void* pos,
                                 void* out, int n, int C, int K, int kv,
                                 void* stream) {
  dg_fwd_f32_kernel<<<tile_grid(n, K), kF32Threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(pos), static_cast<float*>(out), n, C, K, kv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dg_fwd_bf16_launch(const void* x, const void* w,
                                  const void* pos, void* out, int n, int C,
                                  int K, int kv, void* stream) {
  dg_fwd_bf16_kernel<<<tile_grid(n, K), kBf16Threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), n, C, K, kv);
  return static_cast<int>(cudaGetLastError());
}
