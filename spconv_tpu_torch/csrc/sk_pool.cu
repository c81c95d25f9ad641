// B6 `sk_pool`: the 2x/stride-2 max or mean pool on key-sorted input,
// with no rulebook: each parent row finds its children in the sorted input
// keys itself.
//
// Replaces: spconv_tpu/ops/pallas/sorted_pool.py::_sk_pool_kernel (:92,
//   launched at :309 by sk_pool2 :226, wrapped by sk_pool2_ad :320).  The
//   TPU kernel joins a tile of parents against DMA'd windows of shifted
//   key copies with one-hot MXU products, carries a presence lane beside
//   the features to mask absent children, and double-buffers two plane
//   groups of windows.  Those are Mosaic workarounds: here the children are
//   found by a windowed search of the sorted keys and the matched rows are
//   read straight from the row-major [N, C] features.
//
// Computes: for parent row m of out_keys [M] (sentinel-padded, keys on the
//   output grid) and each of its 2^ndim children (ndim 1-4, offsets with
//   the leading axis most significant, so in ascending key order), the
//   child 2 * c + off on every axis (absent past an odd edge, checked
//   before linearizing), searched in in_keys [N] (ascending, sentinel
//   tail).  Over the present children, per channel, in child order, in
//   f32:
//   - max: a NaN-propagating max from -inf, then 0 where it is not finite
//     (a NaN, +-inf, or no child);
//   - mean: the sum over max(count, 1) (an IEEE division: no fast math).
//   One rounding to the feature dtype (f32 or bf16).  Sentinel parents are
//   0.
//
// Bound on the H100: bytes.  The features of the present children are read
//   once (at most N * C * b bytes), the output written once (M * C * b), and
//   both key arrays read (4 * (N + M)); the arithmetic is a compare or an
//   add per element.
//
// Design: a block owns a tile of parents.  Its children are B1's affine
//   table with kernel 2, stride 2 (dg_search.cuh's WindowRows, shared with
//   dg_pos.cu): the two children along the fastest axis are adjacent keys,
//   so a parent costs one lower bound in a shared-memory window per pair of
//   children (4 at 3-D) and one compare for the second of the pair; the
//   windows share a pool of 2,048 keys.  Then a
//   group of lanes per parent, each lane on 16-byte chunks (8 bf16 or 4 f32
//   channels), issues every present child's load of a chunk before it
//   reduces them in child order in f32, rounds once and stores 16 bytes; a
//   scalar variant takes C that is not a multiple of a chunk or a feature
//   pointer that is not 16-byte aligned.  The host plan
//   (ops/sorted_pool.py::b6_plan) sets the lanes a parent from C and the
//   parents a block from (M, C, dtype), so that the small late pools still
//   launch two blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dg_search.cuh"

namespace {

using dg::kMaxNdim;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A 16-byte chunk's channels as f32, and back with one rounding each.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kE = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // little-endian: the low half is the even channel
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// One element's reduction step, in child order.
__device__ __forceinline__ void pool_step(float& acc, float v, bool mean) {
  if (mean) {
    acc += v;
  } else if (v > acc || v != v) {
    acc = v;  // once acc is NaN no compare is true, so it stays NaN
  }
}

__device__ __forceinline__ float finish(float acc, int cnt, bool mean) {
  return mean ? acc / static_cast<float>(max(cnt, 1))
              : (isfinite(acc) ? acc : 0.f);
}

template <int NDIM, typename T, bool VEC>
__global__ void __launch_bounds__(256, 2)
sk_pool_kernel(const T* __restrict__ feat, const int* __restrict__ in_keys,
               int n, const int* __restrict__ out_keys, int m, int C,
               dg::WinGeom g, int sent_out, int mean, int tile, int pool,
               int lanes, T* __restrict__ out) {
  constexpr int kKids = 1 << NDIM;
  // loads in flight: a chunk's children, eight at a time (four channels
  // on the scalar path, where each is one value)
  constexpr int kBatch = kKids < 8 ? kKids : 8;
  constexpr int kScalar = kKids < 4 ? kKids : 4;
  extern __shared__ int sm[];
  const dg::WindowRows<NDIM, false> w{out_keys, m, in_keys, n, g, sent_out,
                                      0, 0, tile, 1 << max(NDIM - 2, 0),
                                      pool, nullptr};
  const int p0 = blockIdx.x * tile;
  w.load_rows(sm, p0);
  w.search(sm, 0, w.groups(), p0);
  const int* kids = w.out(sm);  // [kKids][tile]

  const float neg_inf = __int_as_float(0xff800000);
  const int lane = threadIdx.x % lanes;
  const int here = min(tile, m - p0);
  for (int p = threadIdx.x / lanes; p < here; p += blockDim.x / lanes) {
    int row[kKids];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kKids; ++j) {
      row[j] = kids[j * tile + p];
      cnt += row[j] >= 0 ? 1 : 0;
    }
    T* dst = out + static_cast<size_t>(p0 + p) * C;
    if (VEC) {
      using CK = Chunk<T>;
      for (int ch = lane; ch < C / CK::kE; ch += lanes) {
        float acc[CK::kE];
#pragma unroll
        for (int e = 0; e < CK::kE; ++e) acc[e] = mean ? 0.f : neg_inf;
#pragma unroll
        for (int j0 = 0; j0 < kKids; j0 += kBatch) {
          uint4 v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (row[j0 + u] >= 0) {
              v[u] = __ldg(reinterpret_cast<const uint4*>(
                  feat + static_cast<size_t>(row[j0 + u]) * C) + ch);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (row[j0 + u] >= 0) {
              float f[CK::kE];
              CK::unpack(v[u], f);
#pragma unroll
              for (int e = 0; e < CK::kE; ++e) pool_step(acc[e], f[e], mean);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < CK::kE; ++e) acc[e] = finish(acc[e], cnt, mean);
        reinterpret_cast<uint4*>(dst)[ch] = CK::pack(acc);
      }
    } else {
      for (int c = lane; c < C; c += lanes) {
        float acc = mean ? 0.f : neg_inf;
#pragma unroll
        for (int j0 = 0; j0 < kKids; j0 += kScalar) {
          float v[kScalar];
#pragma unroll
          for (int u = 0; u < kScalar; ++u) {
            if (row[j0 + u] >= 0) {
              v[u] = to_f32(feat[static_cast<size_t>(row[j0 + u]) * C + c]);
            }
          }
#pragma unroll
          for (int u = 0; u < kScalar; ++u) {
            if (row[j0 + u] >= 0) pool_step(acc, v[u], mean);
          }
        }
        from_f32(dst + c, finish(acc, cnt, mean));
      }
    }
  }
}

template <int NDIM, typename T>
cudaError_t launch(const void* feat, const int* in_keys, int n,
                   const int* out_keys, int m, int C, const dg::WinGeom& g,
                   int sent_out, int mean, int tile, int pool, int lanes,
                   int threads, int vec, int smem, void* out,
                   cudaStream_t s) {
  const int blocks = (m + tile - 1) / tile;
  auto kernel = vec ? sk_pool_kernel<NDIM, T, true>
                    : sk_pool_kernel<NDIM, T, false>;
  kernel<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(feat), in_keys, n, out_keys, m, C, g, sent_out,
      mean, tile, pool, lanes, static_cast<T*>(out));
  return cudaGetLastError();
}

template <int NDIM>
cudaError_t launch_nd(const void* feat, int bf16, const int* in_keys, int n,
                      const int* out_keys, int m, int C,
                      const dg::WinGeom& g, int sent_out, int mean, int tile,
                      int pool, int lanes, int threads, int vec, int smem,
                      void* out, cudaStream_t s) {
  return bf16 ? launch<NDIM, __nv_bfloat16>(feat, in_keys, n, out_keys, m, C,
                                            g, sent_out, mean, tile, pool,
                                            lanes, threads, vec, smem, out, s)
              : launch<NDIM, float>(feat, in_keys, n, out_keys, m, C, g,
                                    sent_out, mean, tile, pool, lanes,
                                    threads, vec, smem, out, s);
}

}  // namespace

// geom (host memory): ndim, out_dims[4], in_dims[4].  bf16 != 0 reads and
// writes __nv_bfloat16, else float; mean != 0 averages, else max.  The
// plan (ops/sorted_pool.py::b6_plan): tile parents a block, pool keys of
// the children's windows, lanes a parent, threads a block, vec the 16-byte chunks (C a
// multiple of a chunk, feat and out 16-byte aligned), smem bytes of
// dynamic shared memory.  The wrapper checks that both grids fit int32
// keys.
extern "C" int sk_pool_launch(const void* feat, int bf16, const void* in_keys,
                              int n, const void* out_keys, int m, int C,
                              const int* geom, int sent_out, int mean,
                              int tile, int pool, int lanes, int threads,
                              int vec, int smem, void* out, void* stream) {
  // the children: B1's affine map with kernel 2, stride 2, no padding
  dg::WinGeom g;
  g.ndim = geom[0];
  for (int a = 0; a < kMaxNdim; ++a) {
    g.row_dims[a] = geom[1 + a];
    g.tab_dims[a] = geom[1 + kMaxNdim + a];
    g.stride[a] = 2;
    g.ksize[a] = 2;
    g.dil[a] = 1;
    g.pad[a] = 0;
    g.shift[a] = 1;
  }
  const int* ik = static_cast<const int*>(in_keys);
  const int* ok = static_cast<const int*>(out_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g.ndim) {
    case 1:
      return launch_nd<1>(feat, bf16, ik, n, ok, m, C, g, sent_out, mean,
                          tile, pool, lanes, threads, vec, smem, out, s);
    case 2:
      return launch_nd<2>(feat, bf16, ik, n, ok, m, C, g, sent_out, mean,
                          tile, pool, lanes, threads, vec, smem, out, s);
    case 3:
      return launch_nd<3>(feat, bf16, ik, n, ok, m, C, g, sent_out, mean,
                          tile, pool, lanes, threads, vec, smem, out, s);
    case 4:
      return launch_nd<4>(feat, bf16, ik, n, ok, m, C, g, sent_out, mean,
                          tile, pool, lanes, threads, vec, smem, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
