// BatchNorm1d's training path on Hopper: the masked batch statistics, the
// normalisation and its closed-form backward, over the rows of a sparse
// tensor's [N, C] features (ops/batch_norm.py wraps them).
//
// Replaces: no TPU kernel.  The JAX package's BatchNorm1d
//   (spconv_tpu/modules/modules.py) is plain jnp that XLA fuses; the port
//   ran it as ~25 eager torch ops a forward and as many autograd nodes
//   backward, each over the whole [N, C] buffer in f32 or f64, and that was
//   half of a CenterPoint training step on the card.  These kernels do the
//   same arithmetic in four passes.
//
// Computes, over the active rows (indices[:, 0] >= 0, or every row of a
//   plain [N, C] tensor), per channel, with features in bf16, fp16 or f32:
//   - bn_stats: the count, sum x and sum x^2 (x^2 rounded in f32, as the
//     plain version squares), summed in f64, packed [cnt, s[C], ss[C]]
//     (the vector SyncBN all-reduces), and a uint8 row mask read from the
//     indices once, for the other three passes;
//   - bn_norm: mean = s / n and the biased var = ss / n - mean^2 in f64
//     (n = max(cnt, 1), var at least 0), cast to f32; rstd = 1 / sqrt(var +
//     eps) in f32; y = ((x - mean) * rstd) * gamma + beta, each step
//     rounded in f32 (no contraction), cast to the features' dtype; 0 on
//     inactive rows.  Block 0 writes mean and rstd for the backward;
//   - bn_bwd_reduce: sum dy and sum dy * xhat (xhat = (x - mean) * rstd
//     recomputed in f32 from the saved x), summed in f64 (the product of
//     two f32 values is exact there), and both cast to f32 (dbeta, dgamma);
//   - bn_bwd_dx: dx = (gamma * rstd) * ((dy - sum dy / n) - xhat * (sum dy
//     xhat / n)) in f32, cast to the features' dtype; 0 on inactive rows.
//   The sums take a fixed order (a thread's rows, a tree over the block's
//   rows, the blocks' partials in block order), with no atomics: the
//   results repeat bit for bit.
//
// Bound on the H100: bytes.  The statistics read x once (b bytes an
//   element), the normalisation reads x and writes y (2b), the backward
//   reads dy and x twice and writes dx (5b), plus a mask byte a row a pass
//   and the indices' 16 bytes a row once; the arithmetic is a few f32 and
//   f64 operations an element.  At CenterPoint's widths (16-128 bf16
//   channels) that is 16 bytes an element and ~0.1 FLOP a byte.
//
// Design: a thread owns one vector of a row (16 bytes where C * b and the
//   pointers allow, else 8, 4 or 2 bytes; one template on the element type
//   and the vector) and keeps it across the rows it visits, so its
//   channels, their mean, rstd, gamma and sums stay in registers; a block
//   covers whole rows (256 // vectors-a-row of them a step, neighbouring
//   threads on neighbouring addresses) and strides over the rows in
//   steps of the grid, four rows a thread at a time so that their loads
//   are in flight together (at most 128 registers a thread, two blocks an
//   SM: the f64 sums take 4 registers a channel).  Rows wider than 256
//   vectors split their channels over blockIdx.y.  The two reductions add
//   a thread's rows in f64 in registers, then a pairwise tree over the
//   block's rows in shared memory, then one partial a block, summed by a
//   second small kernel in a fixed order (32 sums of every 32nd block a
//   column, then pairwise; launched by the same entry point).  The host
//   plan (ops/batch_norm.py::bn_plan) sets the vector from C and the
//   pointers' alignment, and the grid to two blocks an SM (at most 256
//   threads a block): two beat four and eight by 3-10 % in each kernel at
//   the CenterPoint step's shapes, with four rows a thread in flight.
//
// On the H100 (a CenterPoint training step, 21 BNs, 0.79G active bf16
//   elements): 6.3 ms of kernels a step against 3.95 ms by bytes and the
//   plain torch ops' 109.6 ms, forward and backward.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block's threads at most
constexpr int kUnroll = 4;     // rows a thread loads before it uses them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// E elements loaded or stored as one access of E * sizeof(T) bytes
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

// where a thread sits: its row in the block's step (ry, of rows), its
// vector (v, of the row's vecs; -1 for a thread past the row's end when
// the channels split over blockIdx.y)
struct Lane {
  int ry, rows, v;
};

template <int E>
__device__ __forceinline__ Lane lane(int c) {
  const int vecs = c / E;
  const int tpr = blockDim.x < vecs ? blockDim.x : vecs;  // threads a row
  Lane l;
  l.rows = blockDim.x / tpr;
  l.ry = threadIdx.x / tpr;
  l.v = blockIdx.y * tpr + threadIdx.x % tpr;
  if (l.ry >= l.rows || l.v >= vecs) l.v = -1;
  return l;
}

__device__ __forceinline__ bool row_active(const uint8_t* mask, int64_t r) {
  return mask == nullptr || mask[r] != 0;
}

// mean and rstd of channel ch from the packed f64 statistics, as the plain
// version derives them
__device__ __forceinline__ void moments(const double* stats, int c, int ch,
                                        float eps, float* mean, float* rstd) {
  const double n = stats[0] < 1.0 ? 1.0 : stats[0];
  const double m = stats[1 + ch] / n;
  double var = __dsub_rn(stats[1 + c + ch] / n, __dmul_rn(m, m));
  var = var < 0.0 ? 0.0 : var;
  *mean = static_cast<float>(m);
  *rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(static_cast<float>(var), eps)));
}

// Sums over the block's rows, in a fixed pairwise order, of each thread's
// K accumulators; afterwards the threads of row 0 hold the block's sums.
template <int K>
__device__ void block_sum(double (&acc)[K], const Lane& l, double* buf) {
  for (int off = 1; off < l.rows; off <<= 1) {
    __syncthreads();
    if ((l.ry & (2 * off - 1)) == off) {
#pragma unroll
      for (int k = 0; k < K; ++k) buf[k * kThreads + threadIdx.x] = acc[k];
    }
    __syncthreads();
    if ((l.ry & (2 * off - 1)) == 0 && l.ry + off < l.rows) {
      const int src = threadIdx.x + off * (blockDim.x / l.rows);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += buf[k * kThreads + src];
    }
  }
}

// The two reductions.  STATS: [cnt, sum x, sum x^2] of x, the mask written
// from the indices' first column (ind, row stride ind_stride) where given;
// else [sum dy, sum dy * xhat].  part is [gridDim.x][width], width 2C + 1
// (STATS) or 2C.
template <typename T, int E, bool STATS>
__global__ void __launch_bounds__(kThreads, 2)
    bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const int32_t* __restrict__ ind, int ind_stride,
                     uint8_t* mask, const float* __restrict__ mean,
                     const float* __restrict__ rstd, int64_t n, int c,
                     double* __restrict__ part) {
  constexpr int K = 2 * E + (STATS ? 1 : 0);
  __shared__ double buf[K * kThreads];
  const Lane l = lane<E>(c);
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  float mu[E], rs[E];
  if (!STATS && l.v >= 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      mu[e] = mean[l.v * E + e];
      rs[e] = rstd[l.v * E + e];
    }
  }
  if (l.v >= 0) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * l.rows;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * l.rows + l.ry;
         r0 < n; r0 += kUnroll * step) {
      Vec<T, E> xv[kUnroll], gv[kUnroll];
      bool act[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * step;
        act[u] = r < n;
        if (act[u] && STATS && ind != nullptr) {
          act[u] = ind[r * ind_stride] >= 0;
          if (l.v == 0 && blockIdx.y == 0) mask[r] = act[u] ? 1 : 0;
        } else if (act[u] && !STATS) {
          act[u] = row_active(mask, r);
        }
        if (act[u]) {
          const int64_t at = r * c + l.v * E;
          xv[u] = *reinterpret_cast<const Vec<T, E>*>(x + at);
          if (!STATS) gv[u] = *reinterpret_cast<const Vec<T, E>*>(dy + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!act[u]) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float f = to_f32(xv[u].v[e]);
          if (STATS) {
            acc[e] += static_cast<double>(f);
            acc[E + e] += static_cast<double>(__fmul_rn(f, f));
          } else {
            const float g = to_f32(gv[u].v[e]);
            const float xh = __fmul_rn(__fsub_rn(f, mu[e]), rs[e]);
            acc[e] += static_cast<double>(g);
            acc[E + e] += static_cast<double>(g) * static_cast<double>(xh);
          }
        }
        if (STATS) acc[2 * E] += 1.0;
      }
    }
  }
  block_sum<K>(acc, l, buf);
  if (l.ry == 0 && l.v >= 0) {
    const int width = 2 * c + (STATS ? 1 : 0);
    double* p = part + static_cast<int64_t>(blockIdx.x) * width;
    const int s0 = STATS ? 1 : 0;
    if (STATS && l.v == 0) p[0] = acc[2 * E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      p[s0 + l.v * E + e] = acc[e];
      p[s0 + c + l.v * E + e] = acc[E + e];
    }
  }
}

// out64[j] (and out32[j] where given) = sum over the blocks of
// part[b][j] in a fixed order: a block takes kSumCols columns, its
// kSumGroups rows of threads each sum blocks b = g, g + kSumGroups, ... in
// order (kSumUnroll loads in flight), then row 0 adds the groups pairwise.
constexpr int kSumCols = 32, kSumGroups = 32, kSumUnroll = 4;

__global__ void __launch_bounds__(kSumCols * kSumGroups)
    bn_sum_partials_kernel(const double* __restrict__ part, int blocks,
                           int width, double* __restrict__ out64,
                           float* __restrict__ out32) {
  __shared__ double sums[kSumGroups][kSumCols];
  const int j = blockIdx.x * kSumCols + threadIdx.x;
  double a = 0.0;
  if (j < width) {
    int b = threadIdx.y;
    for (; b + (kSumUnroll - 1) * kSumGroups < blocks;
         b += kSumUnroll * kSumGroups) {
      double v[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        v[u] = part[static_cast<int64_t>(b + u * kSumGroups) * width + j];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) a += v[u];
    }
    for (; b < blocks; b += kSumGroups)
      a += part[static_cast<int64_t>(b) * width + j];
  }
  sums[threadIdx.y][threadIdx.x] = a;
  for (int off = kSumGroups / 2; off > 0; off >>= 1) {
    __syncthreads();
    if (threadIdx.y < off)
      sums[threadIdx.y][threadIdx.x] += sums[threadIdx.y + off][threadIdx.x];
  }
  if (threadIdx.y == 0 && j < width) {
    out64[j] = sums[0][threadIdx.x];
    if (out32 != nullptr) out32[j] = static_cast<float>(sums[0][threadIdx.x]);
  }
}

// y from x with the statistics' mean and rstd (and gamma, beta where
// given); 0 on inactive rows.  Block (0, y) writes its channels' mean and
// rstd.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2)
    bn_norm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   const double* __restrict__ stats,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float eps, int64_t n, int c, T* __restrict__ y,
                   float* __restrict__ mean_out,
                   float* __restrict__ rstd_out) {
  const Lane l = lane<E>(c);
  if (l.v < 0) return;
  float mu[E], rs[E], g[E], be[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int ch = l.v * E + e;
    moments(stats, c, ch, eps, &mu[e], &rs[e]);
    g[e] = w != nullptr ? w[ch] : 1.0f;
    be[e] = b != nullptr ? b[ch] : 0.0f;
    if (blockIdx.x == 0 && l.ry == 0) {
      mean_out[ch] = mu[e];
      rstd_out[ch] = rs[e];
    }
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * l.rows;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * l.rows + l.ry; r0 < n;
       r0 += kUnroll * step) {
    Vec<T, E> xv[kUnroll];
    bool act[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      act[u] = r < n && row_active(mask, r);
      if (act[u])
        xv[u] = *reinterpret_cast<const Vec<T, E>*>(x + r * c + l.v * E);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r >= n) break;
      Vec<T, E> out;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float t = 0.0f;
        if (act[u]) {
          t = __fmul_rn(__fsub_rn(to_f32(xv[u].v[e]), mu[e]), rs[e]);
          if (w != nullptr) t = __fadd_rn(__fmul_rn(t, g[e]), be[e]);
        }
        out.v[e] = from_f32<T>(t);
      }
      *reinterpret_cast<Vec<T, E>*>(y + r * c + l.v * E) = out;
    }
  }
}

// dx from dy, x, the mean and rstd, gamma (where given), the all-rank sums
// [sum dy, sum dy * xhat] and the count; 0 on inactive rows
template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2)
    bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ w,
                     const double* __restrict__ sums,
                     const double* __restrict__ stats, int64_t n, int c,
                     T* __restrict__ dx) {
  const Lane l = lane<E>(c);
  if (l.v < 0) return;
  const double cnt = stats[0] < 1.0 ? 1.0 : stats[0];
  float mu[E], rs[E], k[E], a[E], bq[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int ch = l.v * E + e;
    mu[e] = mean[ch];
    rs[e] = rstd[ch];
    k[e] = w != nullptr ? __fmul_rn(w[ch], rs[e]) : rs[e];
    a[e] = static_cast<float>(sums[ch] / cnt);
    bq[e] = static_cast<float>(sums[c + ch] / cnt);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * l.rows;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * l.rows + l.ry; r0 < n;
       r0 += kUnroll * step) {
    Vec<T, E> xv[kUnroll], gv[kUnroll];
    bool act[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      act[u] = r < n && row_active(mask, r);
      if (act[u]) {
        const int64_t at = r * c + l.v * E;
        xv[u] = *reinterpret_cast<const Vec<T, E>*>(x + at);
        gv[u] = *reinterpret_cast<const Vec<T, E>*>(dy + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r >= n) break;
      Vec<T, E> out;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float t = 0.0f;
        if (act[u]) {
          const float xh =
              __fmul_rn(__fsub_rn(to_f32(xv[u].v[e]), mu[e]), rs[e]);
          t = __fmul_rn(k[e], __fsub_rn(__fsub_rn(to_f32(gv[u].v[e]), a[e]),
                                        __fmul_rn(xh, bq[e])));
        }
        out.v[e] = from_f32<T>(t);
      }
      *reinterpret_cast<Vec<T, E>*>(dx + r * c + l.v * E) = out;
    }
  }
}

// the entry points' shared arguments: the host plan (ops/batch_norm.py::
// BNPlan) and the element type (0 f32, 1 bf16, 2 fp16)
struct Plan {
  int dtype, vec, threads, grid, groups;
};

template <typename T, int E>
int reduce_launch(bool stats, const void* x, const void* dy, const void* ind,
                  int ind_stride, void* mask, const void* mean,
                  const void* rstd, int64_t n, int c, const Plan& p,
                  void* part, void* out64, void* out32, cudaStream_t s) {
  const dim3 grid(p.grid, p.groups);
  if (stats)
    bn_reduce_kernel<T, E, true><<<grid, p.threads, 0, s>>>(
        static_cast<const T*>(x), nullptr,
        static_cast<const int32_t*>(ind), ind_stride,
        static_cast<uint8_t*>(mask), nullptr, nullptr, n, c,
        static_cast<double*>(part));
  else
    bn_reduce_kernel<T, E, false><<<grid, p.threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), nullptr, 0,
        static_cast<uint8_t*>(mask), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), n, c, static_cast<double*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int width = 2 * c + (stats ? 1 : 0);
  bn_sum_partials_kernel<<<(width + kSumCols - 1) / kSumCols,
                           dim3(kSumCols, kSumGroups), 0, s>>>(
      static_cast<const double*>(part), p.grid, width,
      static_cast<double*>(out64), static_cast<float*>(out32));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int norm_launch(const void* x, const void* mask, const void* stats,
                const void* w, const void* b, float eps, int64_t n, int c,
                const Plan& p, void* y, void* mean, void* rstd,
                cudaStream_t s) {
  bn_norm_kernel<T, E><<<dim3(p.grid, p.groups), p.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const double*>(stats), static_cast<const float*>(w),
      static_cast<const float*>(b), eps, n, c, static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int dx_launch(const void* dy, const void* x, const void* mask,
              const void* mean, const void* rstd, const void* w,
              const void* sums, const void* stats, int64_t n, int c,
              const Plan& p, void* dx, cudaStream_t s) {
  bn_bwd_dx_kernel<T, E><<<dim3(p.grid, p.groups), p.threads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(w),
      static_cast<const double*>(sums), static_cast<const double*>(stats), n,
      c, static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

// returns FN<T, E>(...) for the plan's element type and vector
#define BN_DISPATCH(FN, p, ...)                                  \
  switch ((p).dtype * 16 + (p).vec) {                            \
    case 0 * 16 + 1: return FN<float, 1>(__VA_ARGS__);           \
    case 0 * 16 + 2: return FN<float, 2>(__VA_ARGS__);           \
    case 0 * 16 + 4: return FN<float, 4>(__VA_ARGS__);           \
    case 1 * 16 + 1: return FN<__nv_bfloat16, 1>(__VA_ARGS__);   \
    case 1 * 16 + 2: return FN<__nv_bfloat16, 2>(__VA_ARGS__);   \
    case 1 * 16 + 4: return FN<__nv_bfloat16, 4>(__VA_ARGS__);   \
    case 1 * 16 + 8: return FN<__nv_bfloat16, 8>(__VA_ARGS__);   \
    case 2 * 16 + 1: return FN<__half, 1>(__VA_ARGS__);          \
    case 2 * 16 + 2: return FN<__half, 2>(__VA_ARGS__);          \
    case 2 * 16 + 4: return FN<__half, 4>(__VA_ARGS__);          \
    case 2 * 16 + 8: return FN<__half, 8>(__VA_ARGS__);          \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

}  // namespace

// x [n, c] -> stats [2c + 1] f64 (part: [grid][2c + 1] f64 scratch); with
// ind (int32, row stride ind_stride) also mask [n] uint8
extern "C" int bn_stats_launch(const void* x, const void* ind, int ind_stride,
                               void* mask, long long n, int c, int dtype,
                               int vec, int threads, int grid, int groups,
                               void* part, void* stats, void* stream) {
  const Plan p{dtype, vec, threads, grid, groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(reduce_launch, p, true, x, nullptr, ind, ind_stride, mask,
              nullptr, nullptr, n, c, p, part, stats, nullptr, s);
}

// x [n, c], mask [n] or null, stats [2c + 1] -> y [n, c], mean, rstd [c]
extern "C" int bn_norm_launch(const void* x, const void* mask,
                              const void* stats, const void* w, const void* b,
                              float eps, long long n, int c, int dtype,
                              int vec, int threads, int grid, int groups,
                              void* y, void* mean, void* rstd, void* stream) {
  const Plan p{dtype, vec, threads, grid, groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(norm_launch, p, x, mask, stats, w, b, eps, n, c, p, y, mean,
              rstd, s);
}

// dy, x [n, c] -> sums [2c] f64 and sums32 [2c] f32 (part: [grid][2c])
extern "C" int bn_bwd_reduce_launch(const void* dy, const void* x,
                                    const void* mask, const void* mean,
                                    const void* rstd, long long n, int c,
                                    int dtype, int vec, int threads, int grid,
                                    int groups, void* part, void* sums,
                                    void* sums32, void* stream) {
  const Plan p{dtype, vec, threads, grid, groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(reduce_launch, p, false, x, dy, nullptr, 0,
              const_cast<void*>(mask), mean, rstd, n, c, p, part, sums,
              sums32, s);
}

// dy, x [n, c] -> dx [n, c]
extern "C" int bn_bwd_dx_launch(const void* dy, const void* x,
                                const void* mask, const void* mean,
                                const void* rstd, const void* w,
                                const void* sums, const void* stats,
                                long long n, int c, int dtype, int vec,
                                int threads, int grid, int groups, void* dx,
                                void* stream) {
  const Plan p{dtype, vec, threads, grid, groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(dx_launch, p, dy, x, mask, mean, rstd, w, sums, stats, n, c, p,
              dx, s);
}
