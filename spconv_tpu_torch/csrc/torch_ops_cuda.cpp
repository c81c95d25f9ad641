// The CUDA kernels of the C++ op library (torch_ops.cpp defines the ops):
// C++ copies of the Python package's CUDA kernels, each launching the same
// entry point of the nvcc-built kernel library (spconv_tpu_torch/_build.py,
// the *_launch functions of csrc/*.cu) on the same plan, from plans.h:
//
//   dg_pos          _dg_pos_cuda / _table_cuda / launch_b1 (ops/dg_conv.py)
//   dg_gather_gemm  _dg_gather_gemm_cuda / _gather_gemm_cuda: f32 and bf16,
//                   table and search mode, trans, tile
//   dg_fwd_q        _dg_fwd_q_cuda_op / _dg_fwd_q_cuda, the weight read as
//                   its contiguous [kv, K, C] view
//   sk_pool         _sk_pool2_cuda (ops/sorted_pool.py)
//
// Each takes the SM count from the device's properties and launches on the
// current stream; the 16-byte alignment of the features' pointer picks the
// vector gather as the Python wrappers' does.  A kernel's non-zero return
// raises with its CUDA error string.  Each launch adds one to its counter.
// As torch_ops.cpp: never load this library into a process that imported
// spconv_tpu_torch.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <vector>

#include "plans.h"
#include "torch_ops.h"

// the kernel library's entry points (csrc/*.cu)
extern "C" {
int dg_pos_launch(const void* rows, int n_rows, const void* tab, int n_tab,
                  const int* geom, int row_sent, int divide, int self,
                  int sort, int tile, int gpp, int pool, int smem, void* pos,
                  void* stream);
int dg_fwd_f32_launch(const void* x, const void* w, const void* pos,
                      void* out, int n, int C, int K, int kv, void* stream);
int dg_fwd_bf16_launch(const void* x, const void* w, const void* pos,
                       void* out, int n, int C, int K, int kv, int tile,
                       int vec, int trans, void* stream);
int dg_fwd_search_f32_launch(const void* x, const void* w, const void* keys,
                             void* out, int n, int C, int K, int kv,
                             const int* geom, int sentinel, int reverse,
                             void* stream);
int dg_fwd_search_bf16_launch(const void* x, const void* w, const void* keys,
                              void* out, int n, int C, int K, int kv,
                              const int* geom, int sentinel, int reverse,
                              int tile, int vec, int trans, void* stream);
int dg_fwd_q_launch(const void* x, const void* wt, const void* pos,
                    const void* scale, const void* bias, const void* add,
                    float add_scale, int relu, void* out, int n, int C, int K,
                    int kv, int tile, int vec, void* stream);
int dg_fwd_q_search_launch(const void* x, const void* wt, const void* keys,
                           const void* scale, const void* bias,
                           const void* add, float add_scale, int relu,
                           void* out, int n, int C, int K, int kv,
                           const int* geom, int sentinel, int tile, int vec,
                           void* stream);
int sk_pool_launch(const void* feat, int bf16, const void* in_keys, int n,
                   const void* out_keys, int m, int C, const int* geom,
                   int sent_out, int mean, int tile, int pool, int lanes,
                   int threads, int vec, int smem, void* out, void* stream);
}

namespace spconv_ops {
namespace {

using spconv_plans::kMaxNdim;

// the SMs of the tensor's device, read once a device (dg_conv.py::sm_count)
int sm_count(const at::Tensor& t) {
  static std::mutex mutex;
  static std::map<int, int> sms;
  const int index = t.device().index();
  std::lock_guard<std::mutex> lock(mutex);
  auto it = sms.find(index);
  if (it == sms.end()) {
    int n = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, index);
    TORCH_CHECK(err == cudaSuccess, "cudaDeviceGetAttribute failed: ",
                cudaGetErrorString(err));
    it = sms.emplace(index, n).first;
  }
  return it->second;
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

bool aligned16(const at::Tensor& t) {
  return reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0;
}

const void* ptr(const std::optional<at::Tensor>& t) {
  return t.has_value() ? t->data_ptr() : nullptr;
}

// _raise_on, with the CUDA error's text
void raise_on(int err, const std::string& name) {
  TORCH_CHECK(err == 0, name, " kernel launch failed: cudaError ", err, " (",
              cudaGetErrorString(static_cast<cudaError_t>(err)), ")");
}

// ---- B1: _dg_pos_cuda / _table_cuda / launch_b1 ---------------------------

at::Tensor dg_pos_cuda(const at::Tensor& rows_in, const at::Tensor& table_in,
                       at::IntArrayRef row_dims, at::IntArrayRef tab_dims,
                       at::IntArrayRef stride, at::IntArrayRef ksize,
                       at::IntArrayRef dilation, at::IntArrayRef padding,
                       bool divide, bool self_rows, int64_t batch_size,
                       c10::string_view counter_view) {
  const std::string counter = str(counter_view);
  c10::cuda::CUDAGuard guard(rows_in.device());
  const at::Tensor rows = rows_in.contiguous();
  const at::Tensor table = table_in.contiguous();
  const int64_t sent = sentinel(row_dims, batch_size);
  TORCH_CHECK_NOT_IMPLEMENTED(static_cast<int>(ksize.size()) <= kMaxNdim,
                              "dg_pos kernel takes ndim <= ", kMaxNdim);
  const int64_t kv = spconv_plans::prod(as_ints(ksize));
  const int64_t n = rows.size(0);
  TORCH_CHECK(kv * n < (int64_t{1} << 31), counter, ": kv*N = ", kv * n,
              " exceeds the kernel's int32 table index");
  at::Tensor pos = at::empty({kv, n}, rows.options().dtype(at::kInt));
  if (n == 0) {
    count_launch(counter);
    return pos;
  }
  spconv_plans::B1Plan plan;
  try {
    plan = spconv_plans::b1_plan(n, as_ints(ksize), as_ints(stride), divide,
                                 sm_count(rows));
  } catch (const std::exception& e) {
    TORCH_CHECK(false, e.what());
  }
  const auto geom = spconv_plans::table_geom_ints(
      as_ints(row_dims), as_ints(tab_dims), as_ints(stride), as_ints(ksize),
      as_ints(dilation), as_ints(padding));
  raise_on(dg_pos_launch(rows.data_ptr(), static_cast<int>(n),
                         table.data_ptr(), static_cast<int>(table.size(0)),
                         geom.data(), static_cast<int>(sent), divide,
                         self_rows, plan.sort, plan.tile, plan.groups,
                         plan.pool, plan.smem, pos.data_ptr(),
                         stream_of(rows)),
           counter);
  count_launch(counter);
  return pos;
}

// ---- B2: _dg_gather_gemm_cuda / _gather_gemm_cuda -------------------------

at::Tensor dg_gather_gemm_cuda(const at::Tensor& x_in,
                               const at::Tensor& weight_in,
                               const at::Tensor& rows_in, at::IntArrayRef ksize,
                               at::IntArrayRef dilation,
                               at::IntArrayRef spatial_shape,
                               int64_t batch_size, bool trans,
                               std::optional<int64_t> tile,
                               c10::string_view counter_view) {
  const std::string counter = str(counter_view);
  c10::cuda::CUDAGuard guard(x_in.device());
  const at::Tensor x = x_in.contiguous();
  const at::Tensor rows = rows_in.contiguous();
  at::Tensor weight_kv = weight_in.contiguous();
  const bool search = !ksize.empty();
  std::array<int, 1 + 3 * kMaxNdim> geom{};
  int sent = 0;
  if (search) {
    TORCH_CHECK_NOT_IMPLEMENTED(
        static_cast<int>(spatial_shape.size()) <= kMaxNdim, counter,
        " kernel takes ndim <= ", kMaxNdim);
    geom = spconv_plans::search_geom_ints(as_ints(spatial_shape),
                                          as_ints(ksize), as_ints(dilation));
    sent = static_cast<int>(sentinel(spatial_shape, batch_size));
  }
  const int reverse = trans;  // the search's probes, before f32 drops trans
  const bool f32 = x.scalar_type() == at::kFloat;
  if (trans && f32) {
    weight_kv = weight_kv.transpose(1, 2).contiguous();
    trans = false;
  }
  const int64_t c = x.size(1);
  const int64_t kv = weight_kv.size(0);
  const int64_t k_out = weight_kv.size(trans ? 1 : 2);
  const int64_t n = rows.size(-1);
  at::Tensor out = at::empty({n, k_out}, x.options());
  if (n == 0 || k_out == 0) return out;
  if (c == 0) return out.zero_();
  const int ni = static_cast<int>(n), ci = static_cast<int>(c),
            ki = static_cast<int>(k_out), kvi = static_cast<int>(kv);
  void* stream = stream_of(x);
  int err;
  if (f32) {
    err = search ? dg_fwd_search_f32_launch(
                       x.data_ptr(), weight_kv.data_ptr(), rows.data_ptr(),
                       out.data_ptr(), ni, ci, ki, kvi, geom.data(), sent,
                       reverse, stream)
                 : dg_fwd_f32_launch(x.data_ptr(), weight_kv.data_ptr(),
                                     rows.data_ptr(), out.data_ptr(), ni, ci,
                                     ki, kvi, stream);
  } else {
    TORCH_CHECK(x.scalar_type() == at::kBFloat16, counter,
                " takes float32 or bfloat16, got ", x.scalar_type());
    const spconv_plans::Variant v =
        spconv_plans::b2_variant(n, c, k_out, aligned16(x));
    const int t = tile.has_value() ? static_cast<int>(*tile) : v.tile;
    err = search ? dg_fwd_search_bf16_launch(
                       x.data_ptr(), weight_kv.data_ptr(), rows.data_ptr(),
                       out.data_ptr(), ni, ci, ki, kvi, geom.data(), sent,
                       reverse, t, v.vec, trans, stream)
                 : dg_fwd_bf16_launch(x.data_ptr(), weight_kv.data_ptr(),
                                      rows.data_ptr(), out.data_ptr(), ni, ci,
                                      ki, kvi, t, v.vec, trans, stream);
  }
  raise_on(err, counter);
  count_launch(counter);
  return out;
}

// ---- B7: _dg_fwd_q_cuda_op / _dg_fwd_q_cuda -------------------------------

at::Tensor dg_fwd_q_cuda(const at::Tensor& x_in, const at::Tensor& weight_kv,
                         const at::Tensor& rows_in, const at::Tensor& scale_in,
                         const std::optional<at::Tensor>& bias_in,
                         const std::optional<at::Tensor>& add_in,
                         double add_scale, c10::string_view act,
                         at::IntArrayRef ksize, at::IntArrayRef dilation,
                         at::IntArrayRef spatial_shape, int64_t batch_size,
                         c10::string_view counter_view) {
  const std::string counter = str(counter_view);
  c10::cuda::CUDAGuard guard(x_in.device());
  const at::Tensor x = x_in.contiguous();
  const at::Tensor rows = rows_in.contiguous();
  const at::Tensor scale = scale_in.contiguous();
  std::optional<at::Tensor> bias, add;
  if (bias_in.has_value()) bias = bias_in->contiguous();
  if (add_in.has_value()) add = add_in->contiguous();
  const bool search = !ksize.empty();
  std::array<int, 1 + 3 * kMaxNdim> geom{};
  int sent = 0;
  if (search) {
    TORCH_CHECK_NOT_IMPLEMENTED(
        static_cast<int>(spatial_shape.size()) <= kMaxNdim, counter,
        " kernel takes ndim <= ", kMaxNdim);
    geom = spconv_plans::search_geom_ints(as_ints(spatial_shape),
                                          as_ints(ksize), as_ints(dilation));
    sent = static_cast<int>(sentinel(spatial_shape, batch_size));
  }
  const int64_t c = x.size(1);
  const int64_t kv = weight_kv.size(0);
  const int64_t k_out = weight_kv.size(2);
  const int64_t n = rows.size(-1);
  at::Tensor out = at::empty({n, k_out}, x.options().dtype(at::kChar));
  if (n == 0 || k_out == 0) return out;
  // the kernel reads W[k]^T, [kv, K, C]: the int8 modules hold weight_kv as
  // its transposed view, which is copied only where it is not contiguous
  at::Tensor wt = weight_kv.transpose(1, 2);
  if (!wt.is_contiguous()) wt = wt.contiguous();
  const spconv_plans::Variant v =
      spconv_plans::b7_variant(n, c, k_out, aligned16(x));
  const int relu = str(act) == "relu";
  const int ni = static_cast<int>(n), ci = static_cast<int>(c),
            ki = static_cast<int>(k_out), kvi = static_cast<int>(kv);
  const float s = static_cast<float>(add_scale);
  void* stream = stream_of(x);
  const int err =
      search ? dg_fwd_q_search_launch(x.data_ptr(), wt.data_ptr(),
                                      rows.data_ptr(), scale.data_ptr(),
                                      ptr(bias), ptr(add), s, relu,
                                      out.data_ptr(), ni, ci, ki, kvi,
                                      geom.data(), sent, v.tile, v.vec, stream)
             : dg_fwd_q_launch(x.data_ptr(), wt.data_ptr(), rows.data_ptr(),
                               scale.data_ptr(), ptr(bias), ptr(add), s, relu,
                               out.data_ptr(), ni, ci, ki, kvi, v.tile, v.vec,
                               stream);
  raise_on(err, counter);
  count_launch(counter);
  return out;
}

// ---- B6: _sk_pool2_cuda ---------------------------------------------------

at::Tensor sk_pool_cuda(const at::Tensor& features_in,
                        const at::Tensor& in_keys_in,
                        const at::Tensor& out_keys_in, at::IntArrayRef in_shape,
                        at::IntArrayRef out_shape, int64_t batch_size,
                        c10::string_view mode) {
  c10::cuda::CUDAGuard guard(features_in.device());
  const at::Tensor features = features_in.contiguous();
  const at::Tensor in_keys = in_keys_in.contiguous();
  const at::Tensor out_keys = out_keys_in.contiguous();
  const int64_t sent_out = sentinel(out_shape, batch_size);
  sentinel(in_shape, batch_size);
  const int64_t c = features.size(1);
  const int64_t m = out_keys.size(0);
  at::Tensor out = at::empty({m, c}, features.options());
  if (m == 0 || c == 0) return out;
  const int ndim = static_cast<int>(in_shape.size());
  const spconv_plans::B6Plan plan = spconv_plans::b6_plan(
      m, static_cast<int>(c), static_cast<int>(features.element_size()), ndim,
      aligned16(features), sm_count(features));
  const auto geom =
      spconv_plans::pool_geom_ints(as_ints(in_shape), as_ints(out_shape));
  raise_on(sk_pool_launch(features.data_ptr(),
                          features.scalar_type() == at::kBFloat16,
                          in_keys.data_ptr(),
                          static_cast<int>(features.size(0)),
                          out_keys.data_ptr(), static_cast<int>(m),
                          static_cast<int>(c), geom.data(),
                          static_cast<int>(sent_out), str(mode) == "mean",
                          plan.tile, plan.pool, plan.lanes, plan.threads,
                          plan.vec, plan.smem, out.data_ptr(),
                          stream_of(features)),
           "sk_pool");
  count_launch("sk_pool");
  return out;
}

}  // namespace
}  // namespace spconv_ops

TORCH_LIBRARY_IMPL(spconv_tpu_torch, CUDA, m) {
  m.impl("dg_pos", SPCONV_KERNEL(spconv_ops::dg_pos_cuda));
  m.impl("dg_gather_gemm", SPCONV_KERNEL(spconv_ops::dg_gather_gemm_cuda));
  m.impl("dg_fwd_q", SPCONV_KERNEL(spconv_ops::dg_fwd_q_cuda));
  m.impl("sk_pool", SPCONV_KERNEL(spconv_ops::sk_pool_cuda));
}
