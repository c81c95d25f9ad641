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
//     (probe_dg.py::kt): a transpose through a padded shared tile.
//   - gather: `probe_gather_launch` (probe_dg.py::k, ::ki, ::ks):
//     out[r, l] = x[r, idx[r, l]] (f32 or int32), or a row broadcast times
//     a scale.
//   - search: `probe_join_launch` (probe_int8.py::probe_matmul.kern,
//     probe_cast.py::k_2d, k_3d, k_2d_bcast): the one-hot join
//     out[t] = sum_w [probe[t] == keys[w]] * table[w], as an equal-range
//     binary search in the sorted keys and a sum of the matched rows in
//     ascending w (int8 -> int32 or f32); `probe_rank_launch`
//     (probe_dg.py::kr): a lower bound per row, broadcast over its lanes.
//   - gemm: `probe_gemm_launch` (probe_int8.py::probe_plain_matmul.kern,
//     probe_dg.py::kg): a dense product on the tensor cores with 16x16x16
//     WMMA (mma.sync) fragments, s8 x s8 -> s32 as B7 multiplies, and bf16
//     (cast from f32 while loading) -> f32 as B2 multiplies.
//
// Bound on the H100: every probe moves a few KB to a few hundred KB and
//   does at most ~14 MFLOP, so on the card each is bound by the launch and
//   one trip to memory (a few microseconds), not by bytes or operations.
//
// Design: the simplest kernel for each function.  The copy and gather
//   kernels move 16 bytes a thread where the row allows (the wrapper checks
//   width and alignment; else one element a thread).  The transpose reads
//   and writes whole 32-element rows of a [32][33] shared tile, so neither
//   side is strided and the tile has no bank conflicts.  A join or rank
//   block searches once (one thread), then its threads sum or write the
//   columns.  The GEMMs are B2's and B7's 64 x 64 tiles without the row
//   gather: bf16 tiles row-major with padded pitches, s8 tiles as planes of
//   16 channels, so every fragment starts 32-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>

namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// ---------------------------------------------------------------------------
// copy: out[r, :] = x[start[0] * scale + off + r, :] for r < rows, widened
// to Tout; rows outside [0, n) of x give 0
// ---------------------------------------------------------------------------

template <typename Tin, typename Tout, int V>
__global__ void copy_rows_kernel(const Tin* __restrict__ x, int n, int width,
                                 const int* __restrict__ start, int scale,
                                 int off, int rows, Tout* __restrict__ out) {
  const long long s = static_cast<long long>(start[0]) * scale + off;
  const int vw = width / V;
  const int total = rows * vw;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int r = e / vw;
    const int c = (e % vw) * V;
    const long long src = s + r;
    Vec<Tout, V> o;
    if (src >= 0 && src < n) {
      const Vec<Tin, V> in =
          *reinterpret_cast<const Vec<Tin, V>*>(x + src * width + c);
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = static_cast<Tout>(in.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = static_cast<Tout>(0);
    }
    *reinterpret_cast<Vec<Tout, V>*>(out + static_cast<size_t>(r) * width +
                                     c) = o;
  }
}

template <typename Tin, typename Tout, int V>
int copy_rows(const void* x, int n, int width, const void* start, int scale,
              int off, int rows, void* out, cudaStream_t s) {
  constexpr int kThreads = 256;
  const int total = rows * (width / V);
  const int blocks =
      total > 0 ? std::min((total + kThreads - 1) / kThreads, 1024) : 0;
  if (blocks > 0) {
    copy_rows_kernel<Tin, Tout, V><<<blocks, kThreads, 0, s>>>(
        static_cast<const Tin*>(x), n, width, static_cast<const int*>(start),
        scale, off, rows, static_cast<Tout*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int TT = 32;  // transpose tile

__global__ void transpose_kernel(const float* __restrict__ a, int m, int n,
                                 float* __restrict__ out) {
  __shared__ float tile[TT][TT + 1];
  const int c0 = blockIdx.x * TT;  // columns of a
  const int r0 = blockIdx.y * TT;  // rows of a
  for (int j = threadIdx.y; j < TT; j += blockDim.y) {
    const int r = r0 + j;
    const int c = c0 + threadIdx.x;
    if (r < m && c < n) {
      tile[j][threadIdx.x] = a[static_cast<size_t>(r) * n + c];
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < TT; j += blockDim.y) {
    const int r = c0 + j;  // row of out = column of a
    const int c = r0 + threadIdx.x;
    if (r < n && c < m) {
      out[static_cast<size_t>(r) * m + c] = tile[threadIdx.x][j];
    }
  }
}

// ---------------------------------------------------------------------------
// gather: out[r, l] = x[row >= 0 ? row : r, idx ? idx[r, l] : l] (* scale
// for f32), 4-byte elements; an index outside [0, width) gives 0
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lane(const uint32_t* srow, int width,
                                        int i) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(width) ? srow[i]
                                                                 : 0u;
}

__device__ __forceinline__ uint32_t scaled(uint32_t v, bool is_float,
                                          float scale) {
  return is_float ? __float_as_uint(__uint_as_float(v) * scale) : v;
}

// one block per output row; the source row is staged in shared memory with
// 16-byte loads, the indices read and the outputs written 4 lanes at a time
__global__ void gather_kernel(const uint32_t* __restrict__ x, int width,
                              const int* __restrict__ idx, int row,
                              float scale, int is_float,
                              uint32_t* __restrict__ out) {
  extern __shared__ uint32_t srow[];
  const int r = blockIdx.x;
  const int src = row >= 0 ? row : r;
  const int w4 = width / 4;
  const uint4* xs =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(src) * width);
  for (int e = threadIdx.x; e < w4; e += blockDim.x) {
    reinterpret_cast<uint4*>(srow)[e] = xs[e];
  }
  __syncthreads();
  const int4* is =
      idx == nullptr
          ? nullptr
          : reinterpret_cast<const int4*>(idx +
                                          static_cast<size_t>(r) * width);
  uint4* os = reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * width);
  for (int e = threadIdx.x; e < w4; e += blockDim.x) {
    const int4 ix =
        is == nullptr ? make_int4(4 * e, 4 * e + 1, 4 * e + 2, 4 * e + 3)
                      : is[e];
    os[e] = make_uint4(scaled(lane(srow, width, ix.x), is_float, scale),
                       scaled(lane(srow, width, ix.y), is_float, scale),
                       scaled(lane(srow, width, ix.z), is_float, scale),
                       scaled(lane(srow, width, ix.w), is_float, scale));
  }
}

// ---------------------------------------------------------------------------
// search: the one-hot join and the rank, through binary searches of keys
// sorted ascending
// ---------------------------------------------------------------------------

__device__ __forceinline__ int first_not_below(const int* keys, int n, int p) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int first_above(const int* keys, int lo, int n,
                                           int p) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// one block per probe: thread 0 finds the equal range [lo, hi) of the
// probe's key, then each thread sums its columns of the matched rows in
// ascending order (the plain version's)
template <typename Tin, typename Tacc>
__global__ void join_kernel(const int* __restrict__ probes,
                            const int* __restrict__ keys, int w_n,
                            const Tin* __restrict__ table, int c,
                            Tacc* __restrict__ out) {
  __shared__ int range[2];
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    const int p = probes[t];
    const int lo = first_not_below(keys, w_n, p);
    range[0] = lo;
    range[1] = first_above(keys, lo, w_n, p);
  }
  __syncthreads();
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    Tacc acc = 0;
    for (int w = range[0]; w < range[1]; ++w) {
      acc += static_cast<Tacc>(table[static_cast<size_t>(w) * c + col]);
    }
    out[static_cast<size_t>(t) * c + col] = acc;
  }
}

// one block per row: the rank of the row's first lane among the keys,
// written to every lane
__global__ void rank_kernel(const int* __restrict__ keys, int w_n,
                            const int* __restrict__ probes, int lanes,
                            int* __restrict__ out) {
  __shared__ int rank;
  const int r = blockIdx.x;
  if (threadIdx.x == 0) {
    rank = first_not_below(keys, w_n, probes[static_cast<size_t>(r) * lanes]);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    out[static_cast<size_t>(r) * lanes + l] = rank;
  }
}

// ---------------------------------------------------------------------------
// gemm: out [m, n] = a [m, k] @ b [k, n], row-major, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int kGemmThreads = 128;  // 2 x 2 warps, 32 x 32 outputs each
constexpr int LDC = BN + 4;

// bf16 products of f32 inputs rounded to bf16 while loading (as the probe's
// kernel casts its blocks), f32 sums
__global__ void __launch_bounds__(kGemmThreads)
gemm_bf16_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 int m, int k, int n, float* __restrict__ out) {
  using namespace nvcuda;
  constexpr int BK = 32;
  constexpr int LDA = BK + 8;  // pitches: multiples of 8 elements and of 32
  constexpr int LDB = BN + 8;  // bytes at every 16-row fragment
  __shared__ __align__(32) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK][LDB];
  __shared__ __align__(32) float Cs[BM][LDC];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2;
  const int wc = warp % 2;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  for (int c0 = 0; c0 < k; c0 += BK) {
    for (int e = tid; e < BM * BK; e += kGemmThreads) {
      const int r = e / BK;
      const int c = e % BK;
      float v = 0.f;
      if (row0 + r < m && c0 + c < k) {
        v = a[static_cast<size_t>(row0 + r) * k + c0 + c];
      }
      As[r][c] = __float2bfloat16(v);
    }
    for (int e = tid; e < BK * BN; e += kGemmThreads) {
      const int c = e / BN;
      const int col = e % BN;
      float v = 0.f;
      if (c0 + c < k && col0 + col < n) {
        v = b[static_cast<size_t>(c0 + c) * n + col0 + col];
      }
      Bs[c][col] = __float2bfloat16(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], &As[wr * 32 + i * 16][kk], LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb[j], &Bs[kk][wc * 32 + j * 16], LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
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
  for (int e = tid; e < BM * BN; e += kGemmThreads) {
    const int r = e / BN;
    const int col = e % BN;
    if (row0 + r < m && col0 + col < n) {
      out[static_cast<size_t>(row0 + r) * n + col0 + col] = Cs[r][col];
    }
  }
}

// s8 x s8 -> s32 (exact in any order), tiles as planes of 16 channels
__global__ void __launch_bounds__(kGemmThreads)
gemm_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               int m, int k, int n, int* __restrict__ out) {
  using namespace nvcuda;
  constexpr int KP = 16;  // channels per plane: the MMA's depth
  constexpr int NP = 4;   // planes per step
  constexpr int BK = KP * NP;
  __shared__ __align__(32) signed char As[NP][BM][KP];  // plane, row, chan
  __shared__ __align__(32) signed char Bs[NP][BN][KP];  // plane, col, chan
  __shared__ __align__(32) int Cs[BM][LDC];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2;
  const int wc = warp % 2;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  }
  for (int c0 = 0; c0 < k; c0 += BK) {
    for (int e = tid; e < BM * BK; e += kGemmThreads) {
      const int r = e / BK;
      const int c = e % BK;
      signed char v = 0;
      if (row0 + r < m && c0 + c < k) {
        v = a[static_cast<size_t>(row0 + r) * k + c0 + c];
      }
      As[c / KP][r][c % KP] = v;
    }
    for (int e = tid; e < BK * BN; e += kGemmThreads) {
      const int c = e / BN;
      const int col = e % BN;
      signed char v = 0;
      if (c0 + c < k && col0 + col < n) {
        v = b[static_cast<size_t>(c0 + c) * n + col0 + col];
      }
      Bs[c / KP][col][c % KP] = v;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], &As[p][wr * 32 + i * 16][0], KP);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb[j], &Bs[p][wc * 32 + j * 16][0], KP);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
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
  for (int e = tid; e < BM * BN; e += kGemmThreads) {
    const int r = e / BN;
    const int col = e % BN;
    if (row0 + r < m && col0 + col < n) {
      out[static_cast<size_t>(row0 + r) * n + col0 + col] = Cs[r][col];
    }
  }
}

}  // namespace

// kind: 0 = int8 -> int32, 1 = 2-byte elements, 2 = 4-byte elements; vec:
// 16-byte loads (width a multiple of their elements, x and out aligned).
// start is one int32 on the device.
extern "C" int probe_copy_launch(const void* x, int n, int width, int kind,
                                 const void* start, int scale, int off,
                                 int rows, int vec, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind * 2 + (vec != 0)) {
    case 0:
      return copy_rows<int8_t, int32_t, 1>(x, n, width, start, scale, off,
                                           rows, out, s);
    case 1:
      return copy_rows<int8_t, int32_t, 16>(x, n, width, start, scale, off,
                                            rows, out, s);
    case 2:
      return copy_rows<uint16_t, uint16_t, 1>(x, n, width, start, scale, off,
                                              rows, out, s);
    case 3:
      return copy_rows<uint16_t, uint16_t, 8>(x, n, width, start, scale, off,
                                              rows, out, s);
    case 4:
      return copy_rows<uint32_t, uint32_t, 1>(x, n, width, start, scale, off,
                                              rows, out, s);
    case 5:
      return copy_rows<uint32_t, uint32_t, 4>(x, n, width, start, scale, off,
                                              rows, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a [m, n] f32 -> out [n, m]
extern "C" int probe_transpose_launch(const void* a, int m, int n, void* out,
                                      void* stream) {
  const dim3 grid((n + TT - 1) / TT, (m + TT - 1) / TT);
  transpose_kernel<<<grid, dim3(TT, 8), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), m, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [*, width] 4-byte elements (width a multiple of 4, 16-byte aligned),
// idx [rows, width] int32 or null, row < 0 for "each row its own"; out
// [rows, width]
extern "C" int probe_gather_launch(const void* x, int width, const void* idx,
                                   int row, float scale, int is_float,
                                   int rows, void* out, void* stream) {
  gather_kernel<<<rows, 32, width * sizeof(uint32_t),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), width, static_cast<const int*>(idx),
      row, scale, is_float, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// probes [t_n] and keys [w_n] (ascending) int32, table [w_n, c] int8
// (is_int8, out int32) or f32 (out f32); out [t_n, c]
extern "C" int probe_join_launch(const void* probes, int t_n, const void* keys,
                                 int w_n, const void* table, int c,
                                 int is_int8, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8) {
    join_kernel<int8_t, int32_t><<<t_n, 128, 0, s>>>(
        static_cast<const int*>(probes), static_cast<const int*>(keys), w_n,
        static_cast<const int8_t*>(table), c, static_cast<int32_t*>(out));
  } else {
    join_kernel<float, float><<<t_n, 128, 0, s>>>(
        static_cast<const int*>(probes), static_cast<const int*>(keys), w_n,
        static_cast<const float*>(table), c, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// keys [w_n] ascending, probes and out [rows, lanes] int32
extern "C" int probe_rank_launch(const void* keys, int w_n, const void* probes,
                                 int rows, int lanes, void* out,
                                 void* stream) {
  rank_kernel<<<rows, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), w_n, static_cast<const int*>(probes),
      lanes, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// is_int8: a [m, k], b [k, n] int8 -> out int32; else f32 inputs, bf16
// products, f32 out
extern "C" int probe_gemm_launch(const void* a, const void* b, int m, int k,
                                 int n, int is_int8, void* out,
                                 void* stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8) {
    gemm_s8_kernel<<<grid, kGemmThreads, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), m, k, n,
        static_cast<int*>(out));
  } else {
    gemm_bf16_kernel<<<grid, kGemmThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), m, k, n,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
