"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source, all started together, and links the objects into one shared
library with a plain C interface.  The library is named by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags, and lives
under ``_build/`` (git-ignored).  The build runs
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
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
            nvcc = _nvcc()
            objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o"
                    for s in _sources()]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(_sources(), objs)]
            outs = [(p.args, p.communicate()[0], p.returncode)
                    for p in procs]
            link = [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]]
            if all(rc == 0 for _, _, rc in outs):
                proc = subprocess.run(link, capture_output=True, text=True)
                outs.append((link, proc.stdout + proc.stderr,
                             proc.returncode))
            secs = time.perf_counter() - t0
            for o in objs:
                o.unlink(missing_ok=True)
            text = "".join(out for _, out, _ in outs)
            for cmd, out, rc in outs:
                if rc != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
            log.write_text(text)
            os.replace(tmp, lib)
            return lib, secs, text
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call, with every entry's
    ``argtypes`` set (pointers and the stream as ``c_void_p``, sizes as
    ``c_int``, a float scale as ``c_float``) so that no pointer is cut to
    32 bits."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        # rows, n_rows, tab, n_tab, geom, row_sent, divide, self, sort,
        # tile, gpp, pool, smem, pos, stream
        "dg_pos_launch": [vp, i32, vp, i32, ctypes.POINTER(i32), i32, i32,
                          i32, i32, i32, i32, i32, i32, vp, vp],
        # x, w, pos, out, n, C, K, kv, stream
        "dg_fwd_f32_launch": [vp, vp, vp, vp, i32, i32, i32, i32, vp],
        # x, w, pos, out, n, C, K, kv, tile, vec, trans, stream
        "dg_fwd_bf16_launch": [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                               i32, vp],
        # x, w, keys, out, n, C, K, kv, geom, sentinel, reverse, stream
        "dg_fwd_search_f32_launch": [vp, vp, vp, vp, i32, i32, i32, i32,
                                     ctypes.POINTER(i32), i32, i32, vp],
        # x, w, keys, out, n, C, K, kv, geom, sentinel, reverse, tile, vec,
        # trans, stream
        "dg_fwd_search_bf16_launch": [vp, vp, vp, vp, i32, i32, i32, i32,
                                      ctypes.POINTER(i32), i32, i32, i32,
                                      i32, i32, vp],
        # x, wt, pos, scale, bias, add, add_scale, relu, out, n, C, K, kv,
        # tile, vec, stream
        "dg_fwd_q_launch": [vp, vp, vp, vp, vp, vp, ctypes.c_float, i32, vp,
                            i32, i32, i32, i32, i32, i32, vp],
        # x, wt, keys, scale, bias, add, add_scale, relu, out, n, C, K, kv,
        # geom, sentinel, tile, vec, stream
        "dg_fwd_q_search_launch": [vp, vp, vp, vp, vp, vp, ctypes.c_float,
                                   i32, vp, i32, i32, i32, i32,
                                   ctypes.POINTER(i32), i32, i32, i32, vp],
        # x, dout, pos_rev, part, out, n, C, K, kv, splits, stream
        "dg_wgrad_f32_launch": [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                vp],
        # ..., splits, tile, vec, d_vec, stream
        "dg_wgrad_bf16_launch": [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                 i32, i32, i32, i32, vp],
        # x, dout, keys, part, out, n, C, K, kv, splits, geom, sentinel,
        # stream
        "dg_wgrad_search_f32_launch": [vp, vp, vp, vp, vp, i32, i32, i32,
                                       i32, i32, ctypes.POINTER(i32), i32,
                                       vp],
        # ..., sentinel, tile, vec, d_vec, stream
        "dg_wgrad_search_bf16_launch": [vp, vp, vp, vp, vp, i32, i32, i32,
                                        i32, i32, ctypes.POINTER(i32), i32,
                                        i32, i32, i32, vp],
        # feat, bf16, in_keys, n, out_keys, m, C, geom, sent_out, mean,
        # tile, pool, lanes, threads, vec, smem, out, stream
        "sk_pool_launch": [vp, i32, vp, i32, vp, i32, i32,
                           ctypes.POINTER(i32), i32, i32, i32, i32, i32, i32,
                           i32, i32, vp, vp],
        # the probe kernels (B9, csrc/probes.cu)
        # x, n, width, kind, start, scale, off, rows, vec, tx, ty, grid,
        # out, stream
        "probe_copy_launch": [vp, i32, i32, i32, vp, *[i32] * 7, vp, vp],
        # a, m, n, p, q, vec, out, stream
        "probe_transpose_launch": [vp, i32, i32, i32, i32, i32, vp, vp],
        # x, width, idx, rows, rb, smem, grid, out, stream
        "probe_gather_launch": [vp, i32, vp, *[i32] * 4, vp, vp],
        # x, width, row, scale, rows, rb, rw, grid, out, stream
        "probe_broadcast_launch": [vp, i32, i32, ctypes.c_float, *[i32] * 4,
                                   vp, vp],
        # probes, t_n, keys, w_n, table, c, is_int8, vec, threads, search,
        # grid, out, stream
        "probe_join_launch": [vp, i32, vp, i32, vp, *[i32] * 6, vp, vp],
        # keys, w_n, probes, rows, lanes, search, kvec, rb, grid, out, stream
        "probe_rank_launch": [vp, i32, vp, *[i32] * 6, vp, vp],
        # a, b, m, k, n, is_int8, bm, bn, kw, ks, kc, vec, smem, out, stream
        "probe_gemm_launch": [vp, vp, *[i32] * 11, vp, vp],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = i32
    return lib
