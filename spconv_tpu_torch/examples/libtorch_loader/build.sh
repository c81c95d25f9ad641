#!/bin/sh
# Build the C++ loader and the op library it loads (the kernels' ops defined
# from C++), against the installed torch: python3 only finds torch's headers
# and libraries and runs g++ (spconv_tpu_torch/_build.py: build_ops_library,
# build_loader); neither target links libpython.  CUDA=1 builds both for the
# card: the nvcc kernels, the ops' CUDA kernels, libtorch_cuda.
#   ./build.sh            CPU
#   CUDA=1 ./build.sh     the card
set -e
cd "$(dirname "$0")/../../.."
CUDA="${CUDA:-0}" python3 - <<'PY'
import os
from spconv_tpu_torch._build import build_loader, build_ops_library

cuda = os.environ["CUDA"] == "1"
ops, loader = build_ops_library(cuda)[0], build_loader(cuda)[0]
print(f"built {loader}\n  and {ops}")
print(f"run:   {loader} {ops} <artifact_dir> [requests]")
print("the artifact: python -m spconv_tpu_torch.examples.export_model")
PY
