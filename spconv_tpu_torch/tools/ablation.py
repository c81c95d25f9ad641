"""The build-and-time harness of the kernel ablation and counting scripts:
``b2_ablation`` (B2), ``wgrad_ablation`` (wgrad, and its counting build
of MMA rows), ``b7_ablation`` (B7, and its counting build),
``table_count`` (B1's counting build of the windows searched in global
memory), ``gemm_tiles`` (the probe GEMMs' ablations), ``copy_tiles``
(the probe copy's and transpose's ablations), ``join_gather_tiles`` (the
probe join's and gathers') and ``b6_tiles`` (its timer only);
``chip_smoke.py`` builds the three counting builds through it.  A kernel
source rebuilt with texts replaced, one shared library per ablation,
built in parallel, a CUDA event timer and an interleaved one.
"""

import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from .._build import NVCC_FLAGS, SRC_DIR, _nvcc


def ablated_source(file: str, edits) -> str:
    """``csrc/<file>`` with each ``(text, replacement)`` of ``edits``
    applied wherever the text is; each text must be in the source."""
    src = (SRC_DIR / file).read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{file} holds no {old!r}")
        src = src.replace(old, new)
    return src


def build(file: str, ablations, argtypes, out_dir: Path):
    """One shared library of ``csrc/<file>`` per ``(name, edits)`` of
    ``ablations``, built in parallel into ``out_dir``; returns ``{name:
    ctypes.CDLL}`` with ``argtypes`` (``{entry: [ctypes types]}``) set."""
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(file).stem
    procs = {}
    for i, (name, edits) in enumerate(ablations):
        cu = out_dir / f"{stem}_ablation{i}.cu"
        cu.write_text(ablated_source(file, edits))
        lib = out_dir / f"lib{stem}_ablation{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(SRC_DIR), "-o",
             str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        for entry, types in argtypes.items():
            getattr(dll, entry).argtypes = types
        libs[name] = dll
    return libs


def cuda_ms(fn, reps=10):
    """Milliseconds a call of ``fn``: CUDA events over ``reps`` calls after
    a warm-up, behind a queued device sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(fns, rounds=7, reps=100):
    """For each of ``fns``, the median of ``rounds`` readings of
    ``cuda_ms(fn, reps)``, the functions read in turn in each round."""
    reads = [[] for _ in fns]
    for _ in range(rounds):
        for r, fn in zip(reads, fns):
            r.append(cuda_ms(fn, reps))
    return [statistics.median(r) for r in reads]
