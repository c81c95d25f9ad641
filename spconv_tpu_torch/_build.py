"""Build and load the port's CUDA kernels, and build the C++ deployment
targets.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source, all started together, and links the objects into one shared
library with a plain C interface.  The library is named by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags, and lives
under ``_build/`` (git-ignored).  The build runs
at first use, under a file lock, so concurrent processes build it once.
Importing the package needs neither ``nvcc`` nor a GPU: nothing here runs
until a kernel is first launched.

Two more targets serve an exported program from C++ with no Python
(``export.package``): :func:`build_ops_library`, the kernels as torch ops
defined from C++ (``csrc/torch_ops.cpp``, and on the card
``csrc/torch_ops_cuda.cpp`` linked to the kernel library), and
:func:`build_loader`, the program that runs a package through them
(``examples/libtorch_loader/libtorch_loader.cc``).  Both are compiled by
``g++`` against the installed torch's headers and libraries, into
``_build/``, named by a hash of their sources, flags and torch version, at
first use under the same lock.  A compiler's failure raises.
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

__all__ = ["build_library", "load_library", "NVCC_FLAGS",
           "build_ops_library", "build_loader"]

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _cuda_home() -> Path:
    return Path(_nvcc()).resolve().parent.parent


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


def _build(target: Path, commands, tool: str, prelink=None) -> tuple:
    """Builds ``target`` under the lock unless it exists.  ``commands()``
    gives ``(compiles, link)``: ``[(command, object file)]``, all started
    together, then the command that links them into ``{out}``, after
    ``prelink()`` where given (a library the link needs).  Returns
    ``(path, seconds, log)`` as :func:`build_library`."""
    log = target.with_name(target.name + ".log")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a lock a target, so that one target's build never waits on another's
    with open(BUILD_DIR / f"{target.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if target.exists():
                return target, 0.0, log.read_text() if log.exists() else ""
            tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
            compiles, link = commands()
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for cmd, _ in compiles]
            outs = [(p.args, p.communicate()[0], p.returncode)
                    for p in procs]
            link = [a.format(out=tmp) for a in link]
            if prelink is not None and all(rc == 0 for _, _, rc in outs):
                prelink()
            if all(rc == 0 for _, _, rc in outs):
                proc = subprocess.run(link, capture_output=True, text=True)
                outs.append((link, proc.stdout + proc.stderr,
                             proc.returncode))
            secs = time.perf_counter() - t0
            for _, o in compiles:
                o.unlink(missing_ok=True)
            text = "".join(out for _, out, _ in outs)
            for cmd, out, rc in outs:
                if rc != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"{tool} failed ({rc}):\n{' '.join(cmd)}\n{out}")
            log.write_text(text)
            os.replace(tmp, target)
            return target, secs, text
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _objects(compiler, flags, sources, target: Path):
    """``[(command, object file)]`` compiling each source of ``target`` on
    its own."""
    return [([compiler, *flags, "-c", "-o", str(o), str(s)], o)
            for s in sources
            for o in [BUILD_DIR / f"{target.name}.{s.stem}.{os.getpid()}.o"]]


def build_library() -> tuple:
    """Build the library if it is missing.  Returns ``(path, seconds spent
    compiling, compiler log)``; seconds is 0.0 when it was already built."""
    def commands():
        nvcc = _nvcc()
        objs = _objects(nvcc, NVCC_FLAGS, _sources(), library_path())
        return objs, [nvcc, "-shared", "-o", "{out}",
                      *[str(o) for _, o in objs]]

    return _build(library_path(), commands, "nvcc")


# the C++ deployment targets (g++ against the installed torch)
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wno-deprecated-declarations",
             "-Wno-c++20-extensions")
OPS_SOURCES = ("torch_ops.cpp",)
OPS_CUDA_SOURCES = ("torch_ops_cuda.cpp",)
OPS_HEADERS = ("plans.h", "torch_ops.h")
LOADER_SOURCE = _PKG / "examples" / "libtorch_loader" / "libtorch_loader.cc"


def _torch_flags(cuda: bool):
    """``(compile flags, link flags)`` against the installed torch: its
    headers (and the CUDA toolkit's), its C++ ABI, its libraries with an
    rpath to them (and on the card libtorch_cuda, c10_cuda and cudart)."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch.compiled_with_cxx11_abi())
    inc = list(cpp_extension.include_paths())
    libs = list(cpp_extension.library_paths())
    names = ["c10", "torch_cpu", "torch"]
    if cuda:
        cuda_home = _cuda_home()
        inc.append(str(cuda_home / "include"))
        libs.append(str(cuda_home / "lib64"))
        names += ["c10_cuda", "torch_cuda", "cudart"]
    comp = [*CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            *(f"-I{p}" for p in inc)]
    link = [*(f"-L{p}" for p in libs), "-Wl,--no-as-needed",
            *(f"-l{n}" for n in names), "-Wl,--as-needed",
            *(f"-Wl,-rpath,{p}" for p in libs)]
    return comp, link


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on $PATH; the C++ targets cannot "
                           "be built")
    return found


def _target(stem: str, cuda: bool, files, flags) -> Path:
    import torch

    h = hashlib.sha256(" ".join([torch.__version__, *flags]).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    kind = "cuda" if cuda else "cpu"
    return BUILD_DIR / f"{stem}_{kind}_{h.hexdigest()[:16]}"


def build_ops_library(cuda: bool) -> tuple:
    """The C++ op library (``csrc/torch_ops.cpp``; with ``cuda`` also
    ``csrc/torch_ops_cuda.cpp``, linked to :func:`build_library`'s kernel
    library, built, where it is missing, while the C++ compiles).  Returns
    ``(path, seconds, log)``.  Load it only into a process that never
    imports ``spconv_tpu_torch``: it defines the same ops."""
    comp, link = _torch_flags(cuda)
    sources = [SRC_DIR / n for n in OPS_SOURCES
               + (OPS_CUDA_SOURCES if cuda else ())]
    deps = []
    if cuda:
        deps = [f"-L{BUILD_DIR}", f"-l:{library_path().name}",
                "-Wl,-rpath,$ORIGIN"]
    files = sources + [SRC_DIR / n for n in OPS_HEADERS]
    target = _target("libspconv_tpu_torch_ops", cuda, files,
                     comp + link + deps)
    target = target.with_name(target.name + ".so")

    def commands():
        objs = _objects(_cxx(), comp, sources, target)
        return objs, [_cxx(), "-shared", "-o", "{out}",
                      *[str(o) for _, o in objs], *deps, *link]

    return _build(target, commands, "g++",
                  prelink=build_library if cuda else None)


def build_loader(cuda: bool) -> tuple:
    """The C++ loader (``examples/libtorch_loader/libtorch_loader.cc``),
    linked to libtorch (on the card with libtorch_cuda, whose AOTInductor
    runner serves CUDA packages).  Returns ``(path, seconds, log)``."""
    comp, link = _torch_flags(cuda)
    target = _target("libtorch_loader", cuda, [LOADER_SOURCE], comp + link)

    def commands():
        objs = _objects(_cxx(), comp, [LOADER_SOURCE], target)
        return objs, [_cxx(), "-o", "{out}", str(objs[0][1]), *link, "-ldl"]

    return _build(target, commands, "g++")


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
