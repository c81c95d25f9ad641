"""Deployment export (counterpart of ``spconv_tpu/export.py``): a net, with
its output discovery, rulebooks and kernels, traced into one
``torch.export.ExportedProgram`` with static shapes, saved to portable
bytes and reloaded without the model's code.

Every kernel is a ``torch.library`` op (``ops/library.py``), so the
program holds one node per kernel call; on the card each runs the
hand-written kernel and counts its launch as an eager call does.  Loading
a blob needs ``import spconv_tpu_torch`` (which registers the ops), none
of the model's modules.

:func:`package` compiles the same program ahead of time into an
AOTInductor package, which a process with no Python serves through
libtorch: the kernels' ops are then defined from C++ (``csrc/torch_ops.cpp``,
``_build.build_ops_library``) and the C++ loader
(``examples/libtorch_loader``) runs it.
"""

from __future__ import annotations

import functools
import io
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

__all__ = ["export_inference", "serialize", "deserialize_and_call",
           "package"]


class _Fn(nn.Module):
    """A plain function as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_inference(fn_or_module: Union[Callable, nn.Module],
                     example_args: Sequence) -> torch.export.ExportedProgram:
    """Exports ``fn_or_module(*example_args)`` for inference: an
    ``ExportedProgram`` with the example's static shapes, traced under
    ``torch.no_grad()``.  A module must be in eval mode (every submodule:
    a BatchNorm in training mode would bake its batch statistics into the
    program); a plain function is wrapped in a module.  ``example_args``:
    tensors (a net's features and indices, say), on the device the
    program is to run on."""
    if isinstance(fn_or_module, nn.Module):
        training = [name or type(fn_or_module).__name__
                    for name, m in fn_or_module.named_modules() if m.training]
        if training:
            raise ValueError(
                f"export_inference exports inference, but {training[0]} is "
                "in training mode: call .eval() on the net first")
        module = fn_or_module
    else:
        module = _Fn(fn_or_module).eval()
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args), strict=False)


def serialize(fn_or_module: Union[Callable, nn.Module],
              example_args: Sequence) -> bytes:
    """:func:`export_inference`, then ``torch.export.save`` into bytes."""
    buf = io.BytesIO()
    torch.export.save(export_inference(fn_or_module, example_args), buf)
    return buf.getvalue()


def deserialize_and_call(blob: bytes, *args):
    """Loads a blob of :func:`serialize` (``torch.export.load``) and runs
    its program on ``args``."""
    program = torch.export.load(io.BytesIO(blob))
    with torch.no_grad():
        return program.module()(*args)


@functools.lru_cache(maxsize=None)
def _openmp_cxx() -> Optional[str]:
    """A C++ compiler that builds OpenMP code, which AOTInductor needs (it
    compiles every package's wrapper with ``-fopenmp``): Inductor's own
    pick (``$CXX``, else ``g++``) where it can, else ``g++`` or ``c++`` on
    ``PATH`` (a ``$CXX`` may be a compiler built without libgomp).  None
    where none can: Inductor's own choice and its error then stand."""
    candidates = dict.fromkeys(c for c in (os.environ.get("CXX"), "g++",
                                           "c++") if c)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "omp.cc"
        src.write_text("#include <omp.h>\n"
                       "int main() { return omp_get_max_threads() < 1; }\n")
        for cxx in candidates:
            if shutil.which(cxx) is None:
                continue
            r = subprocess.run([cxx, "-fopenmp", str(src), "-o",
                                str(Path(tmp) / "omp")], capture_output=True,
                               timeout=120)
            if r.returncode == 0:
                return cxx
    return None


def package(fn_or_module: Union[Callable, nn.Module], example_args: Sequence,
            path: Union[str, Path]) -> Path:
    """:func:`export_inference`, then
    ``torch._inductor.aoti_compile_and_package``: the program compiled
    ahead of time for the device of ``example_args`` into an AOTInductor
    package at ``path`` (a ``.pt2`` zip), which libtorch's
    ``AOTIModelPackageLoader`` runs with no Python.  Each kernel stays a
    node that calls its ``spconv_tpu_torch`` op by name; the torch ops
    around them are compiled, with Inductor's bf16 arithmetic rounded
    where eager's separate ops round it (``emulate_precision_casts``), by
    a C++ compiler that builds OpenMP code (:func:`_openmp_cxx`).  Returns
    the package's path."""
    import torch._inductor
    from torch._inductor import config

    program = export_inference(fn_or_module, example_args)
    patch = {"emulate_precision_casts": True}
    cxx = _openmp_cxx()
    if cxx is not None:
        patch["cpp.cxx"] = (None, cxx)
    with config.patch(patch):
        return Path(torch._inductor.aoti_compile_and_package(
            program, package_path=str(path)))
