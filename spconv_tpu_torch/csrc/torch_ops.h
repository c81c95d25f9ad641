// What the two files of the C++ op library share (torch_ops.cpp defines the
// ops and their CPU kernels, torch_ops_cuda.cpp their CUDA kernels).
#pragma once

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/library.h>

#include <string>
#include <vector>

#include "plans.h"

namespace spconv_ops {

// Adds one to the count of `counter` (the C++ side of the Python package's
// ops.dg_conv.launch_counts), read through spconv_tpu_torch_launch_counts.
void count_launch(const std::string& counter);

// The message with which dg_wgrad is refused on every device.
extern const char* const kWgradRefused;

inline std::string str(c10::string_view s) {
  return std::string(s.data(), s.size());
}

inline std::vector<int> as_ints(at::IntArrayRef v) {
  return std::vector<int>(v.begin(), v.end());
}

// The grid's sentinel key (plans.h), raising NotImplementedError as
// coords.grid_sentinel does where the keys run out.
inline int64_t sentinel(at::IntArrayRef dims, int64_t batch) {
  try {
    return spconv_plans::grid_sentinel(as_ints(dims), batch);
  } catch (const std::exception& e) {
    TORCH_CHECK_NOT_IMPLEMENTED(false, e.what());
  }
  return 0;
}

// AOTInductor's proxy executor passes an empty int[] argument as None; the
// op's kernels take it as the empty list it was (a table-mode call's
// search geometry).
inline void empty_lists_from_none(const c10::OperatorHandle& op,
                                  torch::jit::Stack* stack) {
  const auto& args = op.schema().arguments();
  const size_t first = stack->size() - args.size();
  for (size_t i = 0; i < args.size(); ++i) {
    c10::IValue& v = (*stack)[first + i];
    if (v.isNone() && args[i].type()->kind() == c10::TypeKind::ListType) {
      v = c10::IValue(std::vector<int64_t>{});
    }
  }
}

template <class Fn, Fn* fn>
void boxed_kernel(const c10::OperatorHandle& op, c10::DispatchKeySet keys,
                  torch::jit::Stack* stack) {
  static const c10::KernelFunction kernel =
      c10::KernelFunction::makeFromUnboxedFunction(
          c10::CompileTimeFunctionPointer<Fn, fn>());
  empty_lists_from_none(op, stack);
  kernel.callBoxed(op, keys, stack);
}

// The kernel `fn` as a boxed kernel that first turns the proxy executor's
// None back into an empty int[].
#define SPCONV_KERNEL(fn)                                      \
  torch::CppFunction::makeFromBoxedFunction<                   \
      &spconv_ops::boxed_kernel<decltype(fn), fn>>()

}  // namespace spconv_ops
