// The port's kernels as torch ops, defined from C++: the library that a
// process with no Python loads to run an exported program (an AOTInductor
// package, spconv_tpu_torch/export.py::package) through the same
// hand-written kernels as the Python package.
//
// TORCH_LIBRARY(spconv_tpu_torch) defines the five ops with the schemas of
// ops/library.py's define_op calls, character for character (ops/dg_conv.py
// and ops/sorted_pool.py), so that a package's proxy-executor nodes, which
// name an op and pass its arguments by schema, find them here.  This file
// holds the CPU kernels: the plain versions of ops/dg_conv.py and
// ops/sorted_pool.py written in ATen, call for call, so that they give the
// Python CPU kernels' bits.  torch_ops_cuda.cpp holds the CUDA kernels,
// which launch the nvcc-built kernels (spconv_tpu_torch/_build.py) on the
// C++ plans of plans.h.
//
//   dg_pos          B1's match table (subm, reversed, affine, divide)
//   dg_gather_gemm  B2: forward and dgrad on a table, S1 and S2 on the keys
//   dg_fwd_q        B7: the int8 forward on a table, S4 on the keys
//   sk_pool         B6: the sorted-key pool
//   dg_wgrad        defined and refused on every device: it is a training
//                   op, and export_inference traces under no_grad, so no
//                   inference program holds it
//
// Every call adds one to its counter's count (spconv_tpu_torch_launch_counts
// below), on the CPU as on the card.
//
// A process that has imported spconv_tpu_torch must never load this
// library: the package defines the same ops from Python, and the second
// definition fails.  Load it into a process of its own (the C++ loader,
// examples/libtorch_loader, or an interpreter that never imports the port).

#include "torch_ops.h"

#include <ATen/ATen.h>
#include <torch/library.h>

#include <cmath>
#include <cstdio>
#include <limits>
#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <vector>

#include "plans.h"

namespace spconv_ops {
namespace {

std::mutex counts_mutex;
std::map<std::string, long long>& counts() {
  static std::map<std::string, long long> c;
  return c;
}

// Keys -> (batch index, per-axis coordinates), int64 (dg_conv.py::_decode).
std::pair<at::Tensor, std::vector<at::Tensor>> decode(const at::Tensor& keys,
                                                      at::IntArrayRef dims) {
  at::Tensor rem = keys.to(at::kLong);
  std::vector<at::Tensor> coords(dims.size());
  for (int a = static_cast<int>(dims.size()) - 1; a >= 0; --a) {
    coords[a] = at::remainder(rem, dims[a]);
    rem = at::div(rem, dims[a], "floor");
  }
  return {rem, coords};
}

// [kv, ndim] kernel offsets, row-major over the kernel dims
// (coords.kernel_offsets).
std::vector<std::vector<int64_t>> kernel_offsets(at::IntArrayRef ksize) {
  std::vector<std::vector<int64_t>> offs{{}};
  for (int64_t k : ksize) {
    std::vector<std::vector<int64_t>> next;
    for (const auto& o : offs) {
      for (int64_t i = 0; i < k; ++i) {
        next.push_back(o);
        next.back().push_back(i);
      }
    }
    offs = next;
  }
  return offs;
}

at::Tensor full_table(int64_t kv, int64_t n, const at::Tensor& like) {
  return at::full({kv, n}, -1, like.options().dtype(at::kInt));
}

// The row of each probe in `k64` where it is there and `ok`, else -1 (a
// probe found has its row below n, so the clamp changes no entry kept).
at::Tensor match(const at::Tensor& k64, const at::Tensor& probe,
                 const at::Tensor& ok) {
  at::Tensor idx = at::clamp_max(at::searchsorted(k64, probe), k64.size(0) - 1);
  at::Tensor found = ok.logical_and(k64.index_select(0, idx).eq(probe));
  return at::where(found, idx, at::Scalar(-1)).to(at::kInt);
}

// dg_conv.py::dg_pos_plain
at::Tensor dg_pos_plain(const at::Tensor& keys, at::IntArrayRef ksize,
                        at::IntArrayRef dilation, at::IntArrayRef dims,
                        int64_t batch, bool reverse) {
  const int64_t sent = sentinel(dims, batch);
  const auto offs = kernel_offsets(ksize);
  const int ndim = static_cast<int>(dims.size());
  std::vector<int64_t> strides(ndim, 1);
  for (int i = ndim - 2; i >= 0; --i) strides[i] = strides[i + 1] * dims[i + 1];
  const int64_t n = keys.size(0);
  const int64_t kv = static_cast<int64_t>(offs.size());
  at::Tensor k64 = keys.to(at::kLong);
  at::Tensor live = keys.ne(sent);
  auto coords = decode(keys, dims).second;
  at::Tensor pos = full_table(kv, n, keys);
  if (n == 0) return pos;
  for (int64_t k = 0; k < kv; ++k) {
    at::Tensor ok = live.clone();
    int64_t delta = 0;
    for (int a = 0; a < ndim; ++a) {
      int64_t d = (offs[k][a] - ksize[a] / 2) * dilation[a];
      if (reverse) d = -d;
      delta += d * strides[a];
      at::Tensor ca = coords[a] + d;
      ok = ok.logical_and(ca.ge(0).logical_and(ca.lt(dims[a])));
    }
    pos.select(0, k).copy_(match(k64, k64 + delta, ok));
  }
  return pos;
}

// dg_conv.py::dg_pos_affine_plain (divide false) and dg_pos_divide_plain
// (divide true): the table over the rows `rows` searched in `table`'s keys.
at::Tensor dg_pos_regular_plain(const at::Tensor& rows, const at::Tensor& table,
                                at::IntArrayRef row_dims,
                                at::IntArrayRef tab_dims,
                                at::IntArrayRef stride, at::IntArrayRef ksize,
                                at::IntArrayRef dilation,
                                at::IntArrayRef padding, bool divide,
                                int64_t batch) {
  const auto offs = kernel_offsets(ksize);
  const int64_t kv = static_cast<int64_t>(offs.size());
  const int64_t sent = sentinel(row_dims, batch);
  const int64_t n_rows = rows.size(0);
  const int64_t n_tab = table.size(0);
  at::Tensor pos = full_table(kv, n_rows, rows);
  if (n_rows == 0 || n_tab == 0) return pos;
  auto [b, coords] = decode(rows, row_dims);
  at::Tensor live = rows.ne(sent);
  at::Tensor k64 = table.to(at::kLong);
  for (int64_t k = 0; k < kv; ++k) {
    at::Tensor ok = live.clone();
    at::Tensor probe = b;
    for (size_t a = 0; a < tab_dims.size(); ++a) {
      const int64_t disp = offs[k][a] * dilation[a] - padding[a];
      const int64_t s = tab_dims[a];
      at::Tensor ca;
      if (divide) {
        at::Tensor t = coords[a] - disp;
        ok = ok.logical_and(
            t.ge(0).logical_and(at::remainder(t, stride[a]).eq(0)));
        ca = at::div(t, stride[a], "floor");
        ok = ok.logical_and(ca.lt(s));
      } else {
        ca = coords[a] * stride[a] + disp;
        ok = ok.logical_and(ca.ge(0).logical_and(ca.lt(s)));
      }
      probe = probe * s + ca;
    }
    pos.select(0, k).copy_(match(k64, probe, ok));
  }
  return pos;
}

// dg_conv.py::dg_fwd_plain, on the weight `w` [kv, C, K] (a view)
at::Tensor dg_fwd_plain(const at::Tensor& x, const at::Tensor& w,
                        const at::Tensor& pos) {
  at::Tensor out = at::zeros({pos.size(1), w.size(2)},
                             x.options().dtype(at::kFloat));
  for (int64_t k = 0; k < w.size(0); ++k) {
    at::Tensor sel = at::nonzero(pos[k].ge(0)).squeeze(1);
    if (sel.numel() == 0) continue;
    at::Tensor src = x.index_select(0, pos[k].index_select(0, sel).to(at::kLong))
                         .to(at::kFloat);
    out.index_add_(0, sel, at::matmul(src, w[k].to(at::kFloat)));
  }
  return out.to(x.scalar_type());
}

// dg_conv.py::dg_fwd_q_plain
at::Tensor dg_fwd_q_plain(const at::Tensor& x, const at::Tensor& w,
                          const at::Tensor& pos, const at::Tensor& scale,
                          const std::optional<at::Tensor>& bias,
                          const std::optional<at::Tensor>& add,
                          double add_scale, bool relu) {
  at::Tensor acc = at::zeros({pos.size(1), w.size(2)},
                             x.options().dtype(at::kDouble));
  for (int64_t k = 0; k < w.size(0); ++k) {
    at::Tensor sel = at::nonzero(pos[k].ge(0)).squeeze(1);
    if (sel.numel() == 0) continue;
    at::Tensor src = x.index_select(0, pos[k].index_select(0, sel).to(at::kLong))
                         .to(at::kDouble);
    acc.index_add_(0, sel, at::matmul(src, w[k].to(at::kDouble)));
  }
  at::Tensor y = acc.to(at::kFloat) * scale;
  if (bias.has_value()) y = y + *bias;
  if (add.has_value()) {
    y = y + add->to(at::kFloat) *
                static_cast<double>(static_cast<float>(add_scale));
  }
  if (relu) y = at::clamp_min(y, 0.0);
  return at::round(y).clamp_(-127.0, 127.0).to(at::kChar);
}

// The op's table: `rows` itself, or in search mode (ksize given) B1's plain
// table of the keys `rows` (dg_conv.py::_table).
at::Tensor table_of(const at::Tensor& rows, at::IntArrayRef ksize,
                    at::IntArrayRef dilation, at::IntArrayRef spatial_shape,
                    int64_t batch, bool reverse) {
  if (ksize.empty()) return rows;
  return dg_pos_plain(rows, ksize, dilation, spatial_shape, batch, reverse);
}

// ---- the CPU kernels ------------------------------------------------------

at::Tensor dg_pos_cpu(const at::Tensor& rows, const at::Tensor& table,
                      at::IntArrayRef row_dims, at::IntArrayRef tab_dims,
                      at::IntArrayRef stride, at::IntArrayRef ksize,
                      at::IntArrayRef dilation, at::IntArrayRef padding,
                      bool divide, bool self_rows, int64_t batch_size,
                      c10::string_view counter) {
  at::Tensor pos =
      self_rows
          ? dg_pos_plain(rows, ksize, dilation, row_dims, batch_size, divide)
          : dg_pos_regular_plain(rows, table, row_dims, tab_dims, stride,
                                 ksize, dilation, padding, divide,
                                 batch_size);
  count_launch(str(counter));
  return pos;
}

at::Tensor dg_gather_gemm_cpu(const at::Tensor& x, const at::Tensor& weight_kv,
                              const at::Tensor& rows, at::IntArrayRef ksize,
                              at::IntArrayRef dilation,
                              at::IntArrayRef spatial_shape,
                              int64_t batch_size, bool trans,
                              std::optional<int64_t> tile,
                              c10::string_view counter) {
  at::Tensor pos =
      table_of(rows, ksize, dilation, spatial_shape, batch_size, trans);
  at::Tensor out =
      dg_fwd_plain(x, trans ? weight_kv.transpose(1, 2) : weight_kv, pos);
  count_launch(str(counter));
  return out;
}

at::Tensor dg_fwd_q_cpu(const at::Tensor& x, const at::Tensor& weight_kv,
                        const at::Tensor& rows, const at::Tensor& scale,
                        const std::optional<at::Tensor>& bias,
                        const std::optional<at::Tensor>& add,
                        double add_scale, c10::string_view act,
                        at::IntArrayRef ksize, at::IntArrayRef dilation,
                        at::IntArrayRef spatial_shape, int64_t batch_size,
                        c10::string_view counter) {
  at::Tensor pos =
      table_of(rows, ksize, dilation, spatial_shape, batch_size, false);
  at::Tensor out = dg_fwd_q_plain(x, weight_kv, pos, scale, bias, add,
                                  add_scale, str(act) == "relu");
  count_launch(str(counter));
  return out;
}

// sorted_pool.py::sk_pool2_plain (and pool2_child_keys)
at::Tensor sk_pool_cpu(const at::Tensor& features, const at::Tensor& in_keys,
                       const at::Tensor& out_keys, at::IntArrayRef in_shape,
                       at::IntArrayRef out_shape, int64_t batch_size,
                       c10::string_view mode) {
  const bool is_max = str(mode) == "max";
  sentinel(in_shape, batch_size);
  at::Tensor live = out_keys.ne(sentinel(out_shape, batch_size));
  auto [b, coords] = decode(out_keys, out_shape);
  const int ndim = static_cast<int>(in_shape.size());
  std::vector<at::Tensor> children;
  for (int j = 0; j < (1 << ndim); ++j) {
    at::Tensor ok = live.clone();
    at::Tensor key = b;
    for (int a = 0; a < ndim; ++a) {
      at::Tensor ca = coords[a] * 2 + ((j >> (ndim - 1 - a)) & 1);
      ok = ok.logical_and(ca.lt(in_shape[a]));
      key = key * in_shape[a] + ca;
    }
    children.push_back(at::where(ok, key, at::Scalar(-1)));
  }
  at::Tensor probes = at::stack(children).to(at::kInt).to(at::kLong);
  const int64_t n = features.size(0);
  const int64_t c = features.size(1);
  const int64_t m = out_keys.size(0);
  auto f32 = features.options().dtype(at::kFloat);
  at::Tensor acc = at::full(
      {m, c}, is_max ? -std::numeric_limits<double>::infinity() : 0.0, f32);
  at::Tensor cnt = at::zeros({m, 1}, f32);
  at::Tensor k64 = in_keys.to(at::kLong);
  for (int64_t j = 0; j < probes.size(0) && n > 0; ++j) {
    at::Tensor p = probes[j];
    at::Tensor idx = at::clamp_max(at::searchsorted(k64, p), n - 1);
    at::Tensor found =
        p.ge(0).logical_and(k64.index_select(0, idx).eq(p)).unsqueeze(1);
    at::Tensor v = features.index_select(0, idx).to(at::kFloat);
    if (is_max) {
      acc = at::maximum(
          acc, at::where(found, v,
                         at::Scalar(-std::numeric_limits<double>::infinity())));
    } else {
      acc = acc + at::where(found, v, at::Scalar(0.0));
      cnt = cnt + found.to(at::kFloat);
    }
  }
  at::Tensor out = is_max ? at::where(at::isfinite(acc), acc, at::Scalar(0.0))
                          : acc / cnt.clamp_min(1.0);
  count_launch("sk_pool");
  return out.to(features.scalar_type());
}

at::Tensor dg_wgrad_refused(const at::Tensor&, const at::Tensor&,
                            const at::Tensor&, at::IntArrayRef,
                            at::IntArrayRef, at::IntArrayRef, int64_t,
                            c10::string_view) {
  TORCH_CHECK(false, kWgradRefused);
}

}  // namespace

const char* const kWgradRefused =
    "spconv_tpu_torch::dg_wgrad is refused by the C++ op library: it is a "
    "training op (the weight gradient), and this library serves inference "
    "programs, which export_inference traces under no_grad and which never "
    "hold it";

void count_launch(const std::string& counter) {
  std::lock_guard<std::mutex> lock(counts_mutex);
  ++counts()[counter];
}

}  // namespace spconv_ops

// The counts since the last reset, as "name=count" pairs separated by
// spaces, in name order, written to buf (NUL-terminated, cut to cap bytes);
// returns the length of the whole text.
extern "C" int spconv_tpu_torch_launch_counts(char* buf, int cap) {
  std::string text;
  {
    std::lock_guard<std::mutex> lock(spconv_ops::counts_mutex);
    for (const auto& [name, n] : spconv_ops::counts()) {
      if (n == 0) continue;
      text += (text.empty() ? "" : " ") + name + "=" + std::to_string(n);
    }
  }
  if (buf != nullptr && cap > 0) {
    std::snprintf(buf, static_cast<size_t>(cap), "%s", text.c_str());
  }
  return static_cast<int>(text.size());
}

extern "C" void spconv_tpu_torch_reset_launch_counts() {
  std::lock_guard<std::mutex> lock(spconv_ops::counts_mutex);
  spconv_ops::counts().clear();
}

TORCH_LIBRARY(spconv_tpu_torch, m) {
  m.def(
      "dg_pos(Tensor rows, Tensor table, int[] row_dims, int[] tab_dims, "
      "int[] stride, int[] ksize, int[] dilation, int[] padding, bool divide, "
      "bool self_rows, int batch_size, str counter) -> Tensor");
  m.def(
      "dg_gather_gemm(Tensor x, Tensor weight_kv, Tensor rows, int[] ksize, "
      "int[] dilation, int[] spatial_shape, int batch_size, bool trans, "
      "int? tile, str counter) -> Tensor");
  m.def(
      "dg_fwd_q(Tensor x, Tensor weight_kv, Tensor rows, Tensor scale, "
      "Tensor? bias, Tensor? add, float add_scale, str act, int[] ksize, "
      "int[] dilation, int[] spatial_shape, int batch_size, str counter) -> "
      "Tensor");
  m.def(
      "dg_wgrad(Tensor x, Tensor dout, Tensor rows, int[] ksize, "
      "int[] dilation, int[] spatial_shape, int batch_size, str counter) -> "
      "Tensor");
  m.def(
      "sk_pool(Tensor features, Tensor in_keys, Tensor out_keys, "
      "int[] in_shape, int[] out_shape, int batch_size, str mode) -> Tensor");
}

TORCH_LIBRARY_IMPL(spconv_tpu_torch, CPU, m) {
  m.impl("dg_pos", SPCONV_KERNEL(spconv_ops::dg_pos_cpu));
  m.impl("dg_gather_gemm", SPCONV_KERNEL(spconv_ops::dg_gather_gemm_cpu));
  m.impl("dg_fwd_q", SPCONV_KERNEL(spconv_ops::dg_fwd_q_cpu));
  m.impl("sk_pool", SPCONV_KERNEL(spconv_ops::sk_pool_cpu));
}

// dg_wgrad: refused on every device
TORCH_LIBRARY_IMPL(spconv_tpu_torch, CompositeExplicitAutograd, m) {
  m.impl("dg_wgrad", SPCONV_KERNEL(spconv_ops::dg_wgrad_refused));
}
