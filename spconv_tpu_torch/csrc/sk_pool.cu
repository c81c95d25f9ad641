// B6 `sk_pool`: the 2x/stride-2 max or mean pool on key-sorted input,
// with no rulebook: each parent row finds its children in the sorted input
// keys itself.
//
// Replaces: spconv_tpu/ops/pallas/sorted_pool.py::_sk_pool_kernel (:92,
//   launched at :309 by sk_pool2 :226, wrapped by sk_pool2_ad :320).  The
//   TPU kernel joins a tile of parents against DMA'd windows of shifted
//   key copies with one-hot MXU products, carries a presence lane beside
//   the features to mask absent children, and double-buffers two plane
//   groups of windows.  Those are Mosaic workarounds: here every child key
//   is binary-searched in the whole key array (N int32, under 0.5 MB for a
//   125k-voxel scan, resident in L2) and the matched rows are read
//   straight from the row-major [N, C] features.
//
// Computes: for parent row m of out_keys [M] (sentinel-padded, keys on the
//   output grid) and each of its 2^ndim children (ndim 1-4, offsets with
//   the leading axis most significant, so in ascending key order), decode
//   the parent's coordinates, form the child 2 * c + off on every axis
//   (absent past an odd edge, checked before linearizing) and search it in
//   in_keys [N] (ascending, sentinel tail).  Over the present children,
//   per channel, in child order, in f32:
//   - max: a NaN-propagating max from -inf, then 0 where it is not finite
//     (a NaN, +-inf, or no child);
//   - mean: the sum over max(count, 1) (an IEEE division: no fast math).
//   One rounding to the feature dtype (f32 or bf16).  Sentinel parents are
//   0.
//
// Bound on the H100: bytes.  The features of the present children are read
//   once (at most N * C * b bytes), the output written once (M * C * b), and
//   both key arrays read (4 * (N + M)); the arithmetic is a compare or an
//   add per element.  The searches are ~log2(N) = 17 dependent L2 loads
//   each, one per (parent, child), so at small M their latency shows.
//
// Design (simple first): a block owns a tile of 64 parents.  Phase 1: one
//   thread per (parent, child) searches, writing the child's row or -1 to
//   shared memory (64 * 16 ints at ndim 4).  Phase 2: threads stride over
//   (parent, channel), neighbouring threads on neighbouring channels of one
//   row, so each child row is read coalesced; each reduces its parent's
//   children from the shared rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNdim = 4;
constexpr int kTile = 64;      // parents per block
constexpr int kThreads = 256;

struct PoolGeom {
  int ndim;
  int out_dims[kMaxNdim];
  int in_dims[kMaxNdim];
};

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sk_pool_kernel(const T* __restrict__ feat, const int* __restrict__ in_keys,
               int n, const int* __restrict__ out_keys, int m, int C,
               PoolGeom g, int sent_out, int mean, T* __restrict__ out) {
  __shared__ int rows[kTile << kMaxNdim];
  const int kv = 1 << g.ndim;
  const int p0 = blockIdx.x * kTile;
  const int tile = min(kTile, m - p0);

  for (int t = threadIdx.x; t < tile * kv; t += blockDim.x) {
    const int p = t / kv;
    const int j = t - p * kv;
    const int key = out_keys[p0 + p];
    int row = -1;
    if (key != sent_out) {
      int coord[kMaxNdim];
      int rem = key;
#pragma unroll
      for (int a = kMaxNdim - 1; a >= 0; --a) {
        if (a < g.ndim) {
          coord[a] = rem % g.out_dims[a];
          rem /= g.out_dims[a];
        }
      }
      // rem is now the batch index
      int child = rem;
      bool ok = true;
#pragma unroll
      for (int a = 0; a < kMaxNdim; ++a) {
        if (a < g.ndim) {
          const int c = 2 * coord[a] + ((j >> (g.ndim - 1 - a)) & 1);
          ok = ok && c < g.in_dims[a];
          // an absent child stops growing the key: it is never searched,
          // and the key stays below the input grid's sentinel (no overflow)
          child = child * g.in_dims[a] + (ok ? c : 0);
        }
      }
      if (ok) row = search_row(in_keys, n, child);
    }
    rows[t] = row;
  }
  __syncthreads();

  const float neg_inf = __int_as_float(0xff800000);
  for (int e = threadIdx.x; e < tile * C; e += blockDim.x) {
    const int p = e / C;
    const int c = e - p * C;
    float acc = mean ? 0.f : neg_inf;
    int cnt = 0;
    for (int j = 0; j < kv; ++j) {
      const int r = rows[p * kv + j];
      if (r < 0) continue;
      const float v = to_f32(feat[static_cast<size_t>(r) * C + c]);
      if (mean) {
        acc += v;
      } else if (v > acc || v != v) {
        acc = v;  // once acc is NaN no compare is true, so it stays NaN
      }
      ++cnt;
    }
    const float res = mean ? acc / static_cast<float>(max(cnt, 1))
                           : (isfinite(acc) ? acc : 0.f);
    from_f32(out + static_cast<size_t>(p0 + p) * C + c, res);
  }
}

}  // namespace

// geom (host memory): ndim, out_dims[4], in_dims[4].  bf16 != 0 reads and
// writes __nv_bfloat16, else float; mean != 0 averages, else max.  The
// wrapper checks that both grids fit int32 keys.
extern "C" int sk_pool_launch(const void* feat, int bf16, const void* in_keys,
                              int n, const void* out_keys, int m, int C,
                              const int* geom, int sent_out, int mean,
                              void* out, void* stream) {
  PoolGeom g;
  g.ndim = geom[0];
  for (int a = 0; a < kMaxNdim; ++a) {
    g.out_dims[a] = geom[1 + a];
    g.in_dims[a] = geom[1 + kMaxNdim + a];
  }
  const int blocks = (m + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    sk_pool_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat),
        static_cast<const int*>(in_keys), n,
        static_cast<const int*>(out_keys), m, C, g, sent_out, mean,
        static_cast<__nv_bfloat16*>(out));
  } else {
    sk_pool_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(feat), static_cast<const int*>(in_keys),
        n, static_cast<const int*>(out_keys), m, C, g, sent_out, mean,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
