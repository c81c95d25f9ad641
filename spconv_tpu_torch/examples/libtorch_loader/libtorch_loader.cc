// Inference from C++ with no Python: an exported net of spconv_tpu_torch
// served through libtorch and the port's hand-written kernels.
//
// The counterpart of the JAX package's examples/pjrt_loader/pjrt_loader.cc
// (and of the reference's example/libspconv/main.cu, which drives
// libspconv's ops from C++).  spconv_tpu_torch.examples.export_model wrote
// the artifact: the net's whole forward (output discovery, match tables,
// gather-GEMMs, epilogues) as one AOTInductor package with static shapes,
// compiled when it was written, whose kernel calls are nodes naming the
// spconv_tpu_torch ops.  This program:
//
//   1. dlopens the C++ op library (spconv_tpu_torch/csrc/torch_ops*.cpp,
//      built by spconv_tpu_torch._build.build_ops_library), which registers
//      the five spconv_tpu_torch ops: CPU kernels, and on the card the
//      CUDA kernels that launch the nvcc-built kernels;
//   2. opens package.pt2 with torch::inductor::AOTIModelPackageLoader;
//   3. reads manifest.txt and loads the inputs onto the package's device
//      (a CUDA package with no CUDA device is an error, never a CPU run);
//   4. runs `requests` requests (default 1), each timed on the host clock
//      around run() and a device synchronize;
//   5. copies the outputs back and compares every request's with the
//      goldens: integer outputs (s8, s32, s64) exact, f32 within
//      1e-5 * max|ref|, bf16 within 1.6e-2 * max|ref|.
//
// It prints a line per output, the op library's launch counts of one
// request, with requests > 1 the load seconds and each request's ms, then
// LOADER_OK (exit 0) or LOADER_MISMATCH (exit 1); other errors exit 2.
//
// Usage: libtorch_loader <ops_library.so> <artifact_dir> [requests]
// Build: ./build.sh (or spconv_tpu_torch._build.build_loader)

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iterator>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fatal(const std::string& msg) {
  std::fprintf(stderr, "FATAL %s\n", msg.c_str());
  std::exit(2);
}

struct Entry {
  std::string kind;  // input | output
  std::string dtype;
  std::vector<int64_t> dims;
  std::string file;
};

const std::map<std::string, at::ScalarType>& dtypes() {
  static const std::map<std::string, at::ScalarType> m{
      {"f32", at::kFloat}, {"bf16", at::kBFloat16}, {"s8", at::kChar},
      {"s32", at::kInt},   {"s64", at::kLong}};
  return m;
}

std::vector<Entry> read_manifest(const std::string& dir) {
  std::ifstream in(dir + "/manifest.txt");
  if (!in) fatal("no manifest.txt in " + dir);
  std::vector<Entry> out;
  std::string line;
  while (std::getline(in, line)) {
    if (line.empty()) continue;
    std::istringstream ls(line);
    Entry e;
    std::string dims;
    ls >> e.kind >> e.dtype >> dims >> e.file;
    if (!dtypes().count(e.dtype)) fatal("unknown dtype in: " + line);
    std::istringstream ds(dims);
    for (std::string d; std::getline(ds, d, ',');) e.dims.push_back(std::stoll(d));
    out.push_back(e);
  }
  return out;
}

at::Tensor read_tensor(const std::string& dir, const Entry& e) {
  std::ifstream in(dir + "/" + e.file, std::ios::binary);
  if (!in) fatal("cannot open " + e.file);
  std::vector<char> bytes((std::istreambuf_iterator<char>(in)),
                          std::istreambuf_iterator<char>());
  at::Tensor t = at::empty(e.dims, at::TensorOptions().dtype(dtypes().at(e.dtype)));
  if (bytes.size() != static_cast<size_t>(t.nbytes())) {
    fatal(e.file + " holds " + std::to_string(bytes.size()) + " bytes, " +
          std::to_string(t.nbytes()) + " expected");
  }
  std::copy(bytes.begin(), bytes.end(), static_cast<char*>(t.data_ptr()));
  return t;
}

struct Check {
  bool ok = false;
  bool bit_equal = false;
  double max_diff = 0.0, max_ref = 0.0, gate = 0.0;
};

// One output against its golden, by its dtype's gate.
Check compare(const at::Tensor& got, const at::Tensor& ref) {
  Check c;
  if (got.scalar_type() != ref.scalar_type() || got.sizes() != ref.sizes()) {
    return c;
  }
  c.bit_equal = at::equal(got, ref);
  if (got.numel() == 0) {
    c.ok = true;
    return c;
  }
  at::Tensor g = got.to(at::kDouble), r = ref.to(at::kDouble);
  c.max_diff = (g - r).abs().max().item<double>();
  c.max_ref = r.abs().max().item<double>();
  if (!at::isfinite(g - r).all().item<bool>()) c.max_diff = NAN;
  switch (ref.scalar_type()) {
    case at::kFloat: c.gate = 1e-5 * c.max_ref; break;
    case at::kBFloat16: c.gate = 1.6e-2 * c.max_ref; break;
    default: c.gate = 0.0;  // integers: exact
  }
  c.ok = c.bit_equal || c.max_diff <= c.gate;
  return c;
}

std::string dims_text(at::IntArrayRef dims) {
  std::string s;
  for (size_t i = 0; i < dims.size(); ++i) {
    s += (i ? "," : "") + std::to_string(dims[i]);
  }
  return s;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3 || argc > 4) {
    std::fprintf(stderr,
                 "usage: %s <ops_library.so> <artifact_dir> [requests]\n",
                 argv[0]);
    return 2;
  }
  const std::string dir = argv[2];
  const int requests = argc == 4 ? std::atoi(argv[3]) : 1;
  if (requests < 1) fatal("requests must be at least 1");

  // 1. the ops, registered by the library's static initializers
  void* ops = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (ops == nullptr) fatal(std::string("dlopen: ") + dlerror());
  using CountsFn = int (*)(char*, int);
  using ResetFn = void (*)();
  auto counts = reinterpret_cast<CountsFn>(
      dlsym(ops, "spconv_tpu_torch_launch_counts"));
  auto reset = reinterpret_cast<ResetFn>(
      dlsym(ops, "spconv_tpu_torch_reset_launch_counts"));
  if (counts == nullptr || reset == nullptr) {
    fatal(std::string(argv[1]) + " is not the spconv_tpu_torch op library");
  }

  try {
    // 2. the package
    using clock = std::chrono::steady_clock;
    const auto t_load = clock::now();
    torch::inductor::AOTIModelPackageLoader loader(dir + "/package.pt2");
    const std::string device = loader.get_metadata()["AOTI_DEVICE_KEY"];
    const bool cuda = device == "cuda";
    if (cuda && !torch::cuda::is_available()) {
      fatal("package.pt2 is a CUDA package and this process has no CUDA "
            "device");
    }
    if (!cuda && device != "cpu") fatal("package device '" + device + "'");
    const double load_s =
        std::chrono::duration<double>(clock::now() - t_load).count();

    // 3. the inputs and the goldens
    const at::Device dev = cuda ? at::Device(at::kCUDA, 0) : at::Device(at::kCPU);
    std::vector<at::Tensor> inputs, expected;
    std::vector<Entry> outs;
    for (const Entry& e : read_manifest(dir)) {
      if (e.kind == "input") {
        inputs.push_back(read_tensor(dir, e).to(dev));
      } else if (e.kind == "output") {
        expected.push_back(read_tensor(dir, e));
        outs.push_back(e);
      } else {
        fatal("manifest entry of kind '" + e.kind + "'");
      }
    }
    auto sync = [&] {
      if (cuda) torch::cuda::synchronize();
    };

    // 4-5. the requests, each checked
    std::vector<double> ms;
    std::string first_counts;
    bool ok = true;
    for (int r = 0; r < requests; ++r) {
      sync();
      reset();
      const auto t0 = clock::now();
      std::vector<at::Tensor> got = loader.run(inputs);
      sync();
      ms.push_back(
          std::chrono::duration<double, std::milli>(clock::now() - t0).count());
      std::vector<char> buf(counts(nullptr, 0) + 1);
      counts(buf.data(), static_cast<int>(buf.size()));
      const std::string text(buf.data());
      if (r == 0) first_counts = text;
      if (text != first_counts) {
        std::printf("request %d launches %s != the first request's %s\n", r,
                    text.c_str(), first_counts.c_str());
        ok = false;
      }
      if (got.size() != expected.size()) {
        std::printf("request %d: %zu outputs, the manifest has %zu\n", r,
                    got.size(), expected.size());
        ok = false;
        continue;
      }
      for (size_t i = 0; i < got.size(); ++i) {
        const Check c = compare(got[i].cpu(), expected[i]);
        if (r == 0) {
          std::printf(
              "output %zu %s %s max_abs_diff=%.9g max_abs_ref=%.9g "
              "gate=%.9g bitequal=%d %s\n",
              i, outs[i].dtype.c_str(), dims_text(got[i].sizes()).c_str(),
              c.max_diff, c.max_ref, c.gate, c.bit_equal ? 1 : 0,
              c.ok ? "ok" : "MISMATCH");
        } else if (!c.ok || !c.bit_equal) {
          std::printf("request %d output %zu max_abs_diff=%.9g bitequal=%d %s\n",
                      r, i, c.max_diff, c.bit_equal ? 1 : 0,
                      c.ok ? "ok" : "MISMATCH");
        }
        ok = ok && c.ok;
      }
    }
    std::printf("device %s\n", device.c_str());
    std::printf("launches %s\n", first_counts.c_str());
    if (requests > 1) {
      std::printf("load_s %.6f\n", load_s);
      std::printf("request_ms");
      for (double m : ms) std::printf(" %.6f", m);
      std::printf("\n");
    }
    std::printf("%s\n", ok ? "LOADER_OK" : "LOADER_MISMATCH");
    std::fflush(stdout);
    return ok ? 0 : 1;
  } catch (const std::exception& e) {
    fatal(e.what());
  }
}
