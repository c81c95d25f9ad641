"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a`` (Hopper).  The library is named by a hash of the
sources and flags and lives under ``_build/`` (git-ignored).  The build runs
at first use, under a file lock, so concurrent processes build it once.
Importing the package needs neither ``nvcc`` nor a GPU: nothing here runs
until a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build_library", "load_library", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and $PATH); the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspconv_tpu_torch_{h.hexdigest()[:16]}.so"


def build_library() -> tuple:
    """Build the library if it is missing.  Returns ``(path, seconds spent
    compiling, compiler log)``; seconds is 0.0 when it was already built."""
    lib = library_path()
    log = lib.with_suffix(".log")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return lib, 0.0, log.read_text() if log.exists() else ""
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in _sources()]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.perf_counter() - t0
            text = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{text}")
            log.write_text(text)
            os.replace(tmp, lib)
            return lib, secs, text
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call, with every entry's
    ``argtypes`` set (pointers and the stream as ``c_void_p``, sizes as
    ``c_int``) so that no pointer is cut to 32 bits."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dg_pos_launch.argtypes = [vp, i32, i32, ctypes.POINTER(i32), i32,
                                  vp, vp]
    for name in ("dg_fwd_f32_launch", "dg_fwd_bf16_launch"):
        getattr(lib, name).argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                       vp]
    for name in ("dg_pos_launch", "dg_fwd_f32_launch", "dg_fwd_bf16_launch"):
        getattr(lib, name).restype = i32
    return lib
