// Host plans of the port's kernels in C++: the launch each kernel takes
// from its shapes, as ops/dg_conv.py and ops/sorted_pool.py compute it in
// Python, field for field.  Header-only, with no CUDA and no torch include,
// so that the C++ ops (torch_ops_cuda.cpp) launch exactly what the Python
// wrappers launch and a test harness can hold the two side by side
// (tests/test_torch_cpp_plans.py).
//
//   window_smem, b1_plan, b1_window_plan   ops/dg_conv.py (B1's table)
//   full_width_tile, b2_variant           ops/dg_conv.py (B2's bf16 tile)
//   b7_variant                            ops/dg_conv.py (B7's int8 tile)
//   b6_plan                               ops/sorted_pool.py (B6's pool)
//   table_geom_ints, search_geom_ints,
//   pool_geom_ints                        TableGeom.ints, _search_args and
//                                         launch_b6's geometry
//   grid_sentinel                         ops/coords.py
//
// Python's ceiling division -(-a // b) and int.bit_length() are written
// out for non-negative operands (ceil_div, bit_length); bit_length(0) is 0,
// where __builtin_clz(0) is undefined.  Sizes that can pass 2^31 (rows
// times offsets, grid volumes) are int64.
#pragma once

#include <algorithm>
#include <array>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace spconv_plans {

constexpr int kMaxNdim = 4;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline int bit_length(uint32_t x) {
  return x == 0 ? 0 : 32 - __builtin_clz(x);
}

inline int64_t prod(const std::vector<int>& v) {
  int64_t p = 1;
  for (int x : v) p *= x;
  return p;
}

// ---- ops/coords.py --------------------------------------------------------

constexpr int64_t kKey32Limit = (int64_t{1} << 31) - 1;
constexpr int64_t kLoLimit = int64_t{1} << 30;

// a * b for non-negative operands, held at INT64_MAX where it would pass it
inline int64_t sat_mul(int64_t a, int64_t b) {
  return b != 0 && a > INT64_MAX / b ? INT64_MAX : a * b;
}

// The invalid-row key, batch * volume; throws where the JAX package's
// two-word keys run out (coords._check_key_capacity), which is before the
// key passes 2^61.
inline int64_t grid_sentinel(const std::vector<int>& dims, int64_t batch) {
  int64_t vol = batch;
  for (int s : dims) vol = sat_mul(vol, s);
  if (vol >= kKey32Limit) {
    int64_t lo = 1;
    int cut = static_cast<int>(dims.size());
    while (cut > 0 && lo * dims[cut - 1] < kLoLimit) {
      lo *= dims[cut - 1];
      --cut;
    }
    int64_t hi = batch;
    for (int a = 0; a < cut; ++a) hi = sat_mul(hi, dims[a]);
    if (hi >= kKey32Limit) {
      throw std::invalid_argument(
          "grid exceeds two-word int32 key capacity (~2^61 sites)");
    }
  }
  return vol;
}

// ---- B1: ops/dg_conv.py ---------------------------------------------------

constexpr int kB1Tiles[] = {128, 64, 32};  // B1_TILES, largest first
constexpr int kB1Pool = 4096;              // B1_POOL
constexpr int64_t kB1Direct = int64_t{1} << 17;  // B1_DIRECT
constexpr int kB1Threads = 256;
constexpr int kB1Classes = 64;
constexpr int kSmemPass = 48 << 10;  // _SMEM_PASS
constexpr int kSmemMax = 232448;     // SMEM_MAX

struct B1Plan {
  int tile;    // rows a block; 0: the direct path
  int groups;  // offset groups a pass holds
  int passes;
  int pool;    // keys of windows a pass holds in shared memory
  bool sort;   // divide with stride > 1: rows walked by residue class
  int smem;    // dynamic shared memory, bytes
  int64_t grid;
};

// Bytes of dg::WindowRows' shared memory (dg_conv.py::window_smem).
inline int64_t window_smem(int64_t tile, int64_t ndim, int64_t groups,
                           int64_t pool, int64_t per_group,
                           bool staged = true) {
  return 4 * (tile * (5 + ndim) + kB1Classes + 1 + 4 * groups +
              groups * tile + pool +
              (staged ? groups * per_group * tile : 0));
}

// The windowed launch of B1 over n_rows rows (dg_conv.py::b1_window_plan).
inline B1Plan b1_window_plan(int64_t n_rows, const std::vector<int>& ksize,
                             const std::vector<int>& stride, bool divide,
                             int sms) {
  const int ndim = static_cast<int>(ksize.size());
  const int per_group = ksize[ndim - 1] * (ndim >= 2 ? ksize[ndim - 2] : 1);
  const int groups = static_cast<int>(prod(ksize)) / per_group;
  const int64_t classes = stride.empty() ? 1 : prod(stride);
  const bool sort = divide && 1 < classes && classes <= kB1Classes;
  std::vector<int> tiles;
  for (int t : kB1Tiles) {
    if (t == kB1Tiles[2] || ceil_div(n_rows, t) >= 2 * int64_t{sms}) {
      tiles.push_back(t);
    }
  }
  int tile = tiles[0];
  int fit = groups;
  if (sort) {
    bool found = false;
    for (int t : tiles) {
      tile = t;
      fit = 0;
      for (int g = groups; g >= 1; --g) {
        if (window_smem(t, ndim, g, kB1Pool, per_group) <= kSmemPass) {
          fit = g;
          break;
        }
      }
      if (fit) {
        found = true;
        break;
      }
    }
    if (!found) fit = 1;  // the last tile, one group, opted in
  }
  const int64_t smem =
      window_smem(tile, ndim, fit, kB1Pool, per_group, sort);
  if (smem > kSmemMax) {
    throw std::invalid_argument(
        "B1 kernel: a line of " + std::to_string(per_group) +
        " offsets does not fit in shared memory");
  }
  return B1Plan{tile, fit, static_cast<int>(ceil_div(groups, fit)), kB1Pool,
                sort, static_cast<int>(smem), ceil_div(n_rows, tile)};
}

// The launch of B1 over n_rows rows (dg_conv.py::b1_plan): the direct path
// where the table has at most kB1Direct probes, else the windowed one.
inline B1Plan b1_plan(int64_t n_rows, const std::vector<int>& ksize,
                      const std::vector<int>& stride, bool divide, int sms) {
  const int64_t probes = n_rows * prod(ksize);
  if (probes <= kB1Direct) {
    return B1Plan{0, 0, 0, 0, false, 0, ceil_div(probes, kB1Threads)};
  }
  return b1_window_plan(n_rows, ksize, stride, divide, sms);
}

// ---- B2 and B7: ops/dg_conv.py --------------------------------------------

struct Tile3 {
  int bm, bn, bk;
};
constexpr Tile3 kB2Tiles[] = {
    {128, 16, 64}, {128, 32, 64}, {64, 64, 64}, {64, 128, 32}, {64, 256, 32}};
constexpr Tile3 kB7Tiles[] = {
    {128, 16, 128}, {128, 32, 128}, {64, 64, 128}, {64, 128, 64}};
constexpr int64_t kB2Wave = 132;
constexpr int kB2MinSplitBn = 64;

struct Variant {
  int tile;
  int bm, bn;
  int64_t grid_rows, grid_cols;
  bool vec;
  bool packed;  // B7 only
};

// (tile, grid) of a gather-GEMM of n rows and k_out columns on `tiles`
// (dg_conv.py::_full_width_tile): the narrowest tile whose BN covers k_out,
// made narrower, down to 64 columns, while the grid is under one wave.
template <size_t N>
inline Variant full_width_tile(const Tile3 (&tiles)[N], int64_t n,
                               int64_t k_out) {
  int tile = static_cast<int>(N) - 1;
  for (size_t i = 0; i < N; ++i) {
    if (tiles[i].bn >= k_out) {
      tile = static_cast<int>(i);
      break;
    }
  }
  auto rows = [&](int t) { return ceil_div(n, tiles[t].bm); };
  auto cols = [&](int t) { return ceil_div(k_out, tiles[t].bn); };
  while (tiles[tile].bn > kB2MinSplitBn && rows(tile) * cols(tile) < kB2Wave) {
    --tile;
  }
  return Variant{tile, tiles[tile].bm, tiles[tile].bn, rows(tile),
                 cols(tile), false, false};
}

// B2's bf16 variant (dg_conv.py::b2_variant).
inline Variant b2_variant(int64_t n, int64_t c, int64_t k_out, bool aligned) {
  Variant v = full_width_tile(kB2Tiles, n, k_out);
  v.vec = c % 8 == 0 && aligned;
  return v;
}

// B7's int8 variant (dg_conv.py::b7_variant).
inline Variant b7_variant(int64_t n, int64_t c, int64_t k_out, bool aligned) {
  Variant v = full_width_tile(kB7Tiles, n, k_out);
  v.vec = c % 16 == 0 && aligned;
  v.packed = c <= kB7Tiles[v.tile].bk / 2;
  return v;
}

// ---- B6: ops/sorted_pool.py -----------------------------------------------

constexpr int kB6Tiles[] = {128, 64, 32, 16, 8, 4, 2};  // B6_TILES
constexpr int kB6Pool = 2048;                          // B6_POOL

struct B6Plan {
  int tile;     // parents a block
  int lanes;    // lanes a parent
  int threads;  // a block's
  bool vec;     // 16-byte chunks; else one channel a lane
  int pool;
  int smem;
  int64_t grid;
};

// B6's launch over m parents of c channels of itemsize bytes
// (sorted_pool.py::b6_plan, with tile = 0: the plan's own pick).
inline B6Plan b6_plan(int64_t m, int c, int itemsize, int ndim, bool aligned,
                      int sms) {
  const int chunk = 16 / itemsize;
  const bool vec = c % chunk == 0 && aligned;
  const int units = vec ? c / chunk : c;
  const int lanes = std::min(
      32, 1 << bit_length(static_cast<uint32_t>(std::max(0, units - 1))));
  int tile = kB6Tiles[6];
  for (int t : kB6Tiles) {
    if (ceil_div(m, t) >= sms) {
      tile = t;
      break;
    }
  }
  tile = std::max(tile, std::min(kB6Tiles[0], 256 / lanes));
  const int threads = std::min(256, std::max(32, tile * lanes));
  const int groups = 1 << std::max(ndim - 2, 0);
  const int64_t smem =
      window_smem(tile, ndim, groups, kB6Pool, ndim > 1 ? 4 : 2);
  return B6Plan{tile, lanes, threads, vec, kB6Pool, static_cast<int>(smem),
                ceil_div(m, tile)};
}

// ---- geometry as the kernels read it --------------------------------------

// A B1 table's geometry, dg::win_geom's layout (TableGeom.ints): ndim, then
// row dims, table dims, stride, ksize, dilation (each padded with 1s to
// kMaxNdim) and padding (padded with 0s).
inline std::array<int, 1 + 6 * kMaxNdim> table_geom_ints(
    const std::vector<int>& row_dims, const std::vector<int>& tab_dims,
    const std::vector<int>& stride, const std::vector<int>& ksize,
    const std::vector<int>& dilation, const std::vector<int>& padding) {
  std::array<int, 1 + 6 * kMaxNdim> g{};
  const int ndim = static_cast<int>(ksize.size());
  g[0] = ndim;
  const std::vector<int>* fields[] = {&row_dims, &tab_dims, &stride,
                                      &ksize, &dilation, &padding};
  for (int f = 0; f < 6; ++f) {
    for (int a = 0; a < kMaxNdim; ++a) {
      g[1 + f * kMaxNdim + a] = a < ndim ? (*fields[f])[a] : (f == 5 ? 0 : 1);
    }
  }
  return g;
}

// The search mode's geometry, dg::subm_geom's layout (_search_args): ndim,
// then the grid, ksize and dilation, each padded with 1s.
inline std::array<int, 1 + 3 * kMaxNdim> search_geom_ints(
    const std::vector<int>& dims, const std::vector<int>& ksize,
    const std::vector<int>& dilation) {
  std::array<int, 1 + 3 * kMaxNdim> g{};
  const int ndim = static_cast<int>(dims.size());
  g[0] = ndim;
  const std::vector<int>* fields[] = {&dims, &ksize, &dilation};
  for (int f = 0; f < 3; ++f) {
    for (int a = 0; a < kMaxNdim; ++a) {
      g[1 + f * kMaxNdim + a] = a < ndim ? (*fields[f])[a] : 1;
    }
  }
  return g;
}

// B6's geometry (launch_b6): ndim, then the output dims and the input dims,
// each padded with 1s.
inline std::array<int, 1 + 2 * kMaxNdim> pool_geom_ints(
    const std::vector<int>& in_dims, const std::vector<int>& out_dims) {
  std::array<int, 1 + 2 * kMaxNdim> g{};
  const int ndim = static_cast<int>(in_dims.size());
  g[0] = ndim;
  for (int a = 0; a < kMaxNdim; ++a) {
    g[1 + a] = a < ndim ? out_dims[a] : 1;
    g[1 + kMaxNdim + a] = a < ndim ? in_dims[a] : 1;
  }
  return g;
}

}  // namespace spconv_plans
