// B3 `dg_wgrad`: the weight gradient of a submanifold conv through the
// reversed match table.
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
//   and dout [N, K] in f32 or bf16, pos_rev [kv, N] int32 (-1 = no match),
//   sums in f32, rounded once to the input dtype.
//
// Bound on the H100: the dout gather.  A matched (row, offset) costs
//   2 * C * K flops against 2 * K (bf16) gathered bytes plus the dense x row;
//   at C = K = 64..256 that is above the bf16 ridge only when the tile reuses
//   each gathered row for all 64 of its channels, which the 64 x 64 tile
//   does.  Unpipelined, each chunk waits on its gather.
//
// Design (simple first; wgmma, TMA and pipelining are later work): grid =
//   (C-tiles x K-tiles of 64 x 64, kv offsets, S row splits).  A block walks
//   its split in chunks of 32 rows: it loads the chunk's reversed matches,
//   skips the chunk if all 32 are -1 (~9.3 of 27 offsets match per voxel),
//   else loads the dense x rows and gathers the dout rows into shared memory
//   (zero where -1 or past C/K, which also covers C = 3), and accumulates
//   x_chunk^T * dout_chunk: f32 FMAs from registers (f32) or 16x16x16 bf16
//   WMMA with f32 accumulators (bf16).  Its tile goes to the f32 scratch
//   part[S, kv, C, K]; the reduce kernel sums over S.
//
// Search mode (`dg_wgrad_search_*_launch`, S3): the same kernels with each
//   chunk's reversed matches from an in-block search of the sorted keys
//   (dg_search.cuh's subm probe) instead of the table, replacing the dW half
//   of _dg_bwd_kernel with posmode=False (launched at dg_conv.py:1598 from
//   _dg_conv_bwd :1661).  The block searches one row per thread, blockDim /
//   32 chunks at once, for its one offset, and flags each chunk that matches
//   anywhere (one warp = one chunk).  Chunks, their order, the skip
//   decisions and the fixed-order reduce are the table mode's, so dW is
//   bit-equal to B1's reversed table followed by the table mode.  Every
//   (C-tile, K-tile) block of an offset repeats the searches of its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "dg_search.cuh"

namespace {

constexpr int TM = 64;  // input channels c per tile (rows of dW[k])
constexpr int TN = 64;  // output channels kk per tile (columns of dW[k])
constexpr int BJ = 32;  // rows j per chunk

constexpr int kF32Threads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBf16Threads = 128;  // 2 x 2 warps, 32 x 32 outputs each
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

// Row sources of a block's chunks.  chunk(sm, k, j0, j_begin, j_end)
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

template <class Src>
__global__ void __launch_bounds__(kBf16Threads)
dg_wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ dout, Src src,
                     float* __restrict__ part, int n, int C, int K, int kv,
                     int rows_per_split) {
  using namespace nvcuda;
  constexpr int LDX = TM + 8;  // row pitches: multiples of 8 elements and
  constexpr int LDD = TN + 8;  // of 32 bytes at every 16-row fragment
  constexpr int LDC = TN + 4;
  __shared__ __align__(32) __nv_bfloat16 Xs[BJ][LDX];
  __shared__ __align__(32) __nv_bfloat16 Ds[BJ][LDD];
  __shared__ __align__(32) float Cs[TM][LDC];
  __shared__ int rows[Src::kSmem];
  const TileCoords t = tile_coords(n, K, rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2;  // warp's 32-channel half of the c axis
  const int wc = warp % 2;  // warp's 32-channel half of the kk axis
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int j0 = t.j_begin; j0 < t.j_end; j0 += BJ) {
    const int* sp = src.chunk(rows, t.k, j0, t.j_begin, t.j_end);
    if (sp == nullptr) continue;
    for (int e = tid; e < BJ * TM; e += kBf16Threads) {
      const int r = e / TM;
      const int c = e % TM;
      __nv_bfloat16 v = zero;
      if (sp[r] >= 0 && t.c0 + c < C) {
        v = x[static_cast<size_t>(j0 + r) * C + t.c0 + c];
      }
      Xs[r][c] = v;
    }
    for (int e = tid; e < BJ * TN; e += kBf16Threads) {
      const int r = e / TN;
      const int col = e % TN;
      const int p = sp[r];
      __nv_bfloat16 v = zero;
      if (p >= 0 && t.n0 + col < K) {
        v = dout[static_cast<size_t>(p) * K + t.n0 + col];
      }
      Ds[r][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < BJ; jj += 16) {
      // A = x_chunk^T (c x j): Xs is [j][c] row-major, i.e. A column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], &Xs[jj][wr * 32 + i * 16], LDX);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b[j], &Ds[jj][wc * 32 + j * 16], LDD);
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cs[wr * 32 + i * 16][wc * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  float* out = part + (static_cast<size_t>(blockIdx.z) * kv + t.k) *
                          static_cast<size_t>(C) * K;
  for (int e = tid; e < TM * TN; e += kBf16Threads) {
    const int r = e / TN;
    const int col = e % TN;
    if (t.c0 + r < C && t.n0 + col < K) {
      out[static_cast<size_t>(t.c0 + r) * K + t.n0 + col] = Cs[r][col];
    }
  }
}

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

dim3 wgrad_grid(int C, int K, int kv, int splits) {
  return dim3(((C + TM - 1) / TM) * ((K + TN - 1) / TN), kv, splits);
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

template <class Src, class T>
int launch(const T* x, const T* dout, Src src, void* part, void* out, int n,
           int C, int K, int kv, int splits, cudaStream_t s) {
  float* p = static_cast<float*>(part);
  if constexpr (sizeof(T) == 4) {
    dg_wgrad_f32_kernel<Src><<<wgrad_grid(C, K, kv, splits), kF32Threads, 0,
                               s>>>(x, dout, src, p, n, C, K, kv,
                                    rows_per_split(n, splits));
  } else {
    dg_wgrad_bf16_kernel<Src><<<wgrad_grid(C, K, kv, splits), kBf16Threads,
                                0, s>>>(x, dout, src, p, n, C, K, kv,
                                        rows_per_split(n, splits));
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce_launch(static_cast<const float*>(p), static_cast<T*>(out),
                       splits, static_cast<size_t>(kv) * C * K, s);
}

template <class T>
int launch_table(const void* x, const void* dout, const void* pos_rev,
                 void* part, void* out, int n, int C, int K, int kv,
                 int splits, void* stream) {
  return launch(static_cast<const T*>(x), static_cast<const T*>(dout),
                TableChunks{static_cast<const int*>(pos_rev), n}, part, out,
                n, C, K, kv, splits, static_cast<cudaStream_t>(stream));
}

template <class T, int kThreads>
int launch_search(const void* x, const void* dout, const void* keys,
                  void* part, void* out, int n, int C, int K, int kv,
                  int splits, const int* geom, int sentinel, void* stream) {
  return launch(static_cast<const T*>(x), static_cast<const T*>(dout),
                SearchChunks<kThreads>{static_cast<const int*>(keys), n,
                                       dg::subm_geom(geom), sentinel},
                part, out, n, C, K, kv, splits,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

// part: f32 scratch [splits, kv, C, K]; out: [kv, C, K] in the input dtype.
extern "C" int dg_wgrad_f32_launch(const void* x, const void* dout,
                                   const void* pos_rev, void* part, void* out,
                                   int n, int C, int K, int kv, int splits,
                                   void* stream) {
  return launch_table<float>(x, dout, pos_rev, part, out, n, C, K, kv, splits,
                             stream);
}

extern "C" int dg_wgrad_bf16_launch(const void* x, const void* dout,
                                    const void* pos_rev, void* part,
                                    void* out, int n, int C, int K, int kv,
                                    int splits, void* stream) {
  return launch_table<__nv_bfloat16>(x, dout, pos_rev, part, out, n, C, K,
                                     kv, splits, stream);
}

// Search mode: keys [n] ascending with the sentinel tail, geom (host
// memory) as dg_pos_launch's; the probes are the reversed ones.
extern "C" int dg_wgrad_search_f32_launch(const void* x, const void* dout,
                                          const void* keys, void* part,
                                          void* out, int n, int C, int K,
                                          int kv, int splits,
                                          const int* geom, int sentinel,
                                          void* stream) {
  return launch_search<float, kF32Threads>(x, dout, keys, part, out, n, C, K,
                                           kv, splits, geom, sentinel,
                                           stream);
}

extern "C" int dg_wgrad_search_bf16_launch(const void* x, const void* dout,
                                           const void* keys, void* part,
                                           void* out, int n, int C, int K,
                                           int kv, int splits,
                                           const int* geom, int sentinel,
                                           void* stream) {
  return launch_search<__nv_bfloat16, kBf16Threads>(
      x, dout, keys, part, out, n, C, K, kv, splits, geom, sentinel, stream);
}
