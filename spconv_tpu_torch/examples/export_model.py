"""Export a small encoder as a deployment artifact (the Python half of the
JAX package's ``examples/pjrt_loader/export_model.py``).

The net is that file's: SubM 3 -> 32 (ReLU), ``SparseConv3d`` 32 -> 64
stride 2 (ReLU, ``out_bound`` the buffer), SubM 64 -> 64, all on
``algo="native"``, with weights drawn from ``WEIGHT_SEED``.  The input is
``benchmark.basic.synthetic_scan(seed)`` cut to the buffer as the JAX
example cuts its real scan (every ``step``-th voxel), key-sorted: the real
scan that example reads is not in the repository.  The whole forward
(rulebooks, gather-GEMMs, epilogues) exports as one ``torch.export``
program with static shapes (``spconv_tpu_torch.export``).

Artifact layout (written to ``artifact/`` beside this file, or
``out_dir``):
  model.pt2        the ``ExportedProgram`` (``torch.export.save``)
  package.pt2      the same program compiled ahead of time, an AOTInductor
                   package (``spconv_tpu_torch.export.package``; with
                   ``package=True``, as the command line writes it)
  manifest.txt     one line a tensor: "input|output dtype d0,d1 file",
                   dtype one of f32, bf16, s8, s32, s64
  input_*.bin      raw little-endian row-major inputs
  expected_*.bin   the eager outputs, for a loader's check

The C++ loader (``examples/libtorch_loader``) serves ``package.pt2`` with
no Python: ``libtorch_loader <op library> <artifact dir> [requests]``.

Usage: python -m spconv_tpu_torch.examples.export_model
"""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import SparseConvTensor, SparseSequential, default_device
from ..benchmark.basic import synthetic_scan
from ..export import package as aot_package
from ..export import serialize
from ..modules import SparseConv3d, SubMConv3d

__all__ = ["ARTIFACT", "NBUF", "WEIGHT_SEED", "build_net", "load_input",
           "write_artifact", "run_loader", "main"]

ARTIFACT = Path(__file__).resolve().parent / "artifact"
NBUF = 16384  # the deployment's voxel budget, the JAX example's
WEIGHT_SEED = 7
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "s8",
           torch.int32: "s32", torch.int64: "s64"}


def build_net(device=None, nbuf: int = NBUF) -> SparseSequential:
    """The JAX example's three convs on ``algo="native"``, in eval mode."""
    gen = torch.Generator().manual_seed(WEIGHT_SEED)
    kw = dict(algo="native", device=device, generator=gen)
    return SparseSequential(
        SubMConv3d(3, 32, 3, indice_key="s0", act_type="relu", **kw),
        SparseConv3d(32, 64, 3, stride=2, padding=1, act_type="relu",
                     out_bound=nbuf, **kw),
        SubMConv3d(64, 64, 3, indice_key="s1", **kw)).eval()


def load_input(seed: int = 0, nbuf: int = NBUF):
    """``(features [nbuf, 3] f32, indices [nbuf, 4] int32, shape)``: the
    synthetic scan of ``seed``, every ``step``-th voxel up to ``nbuf -
    128``, key-sorted, padded with invalid rows."""
    voxels, coors, shape = synthetic_scan(seed)
    n = min(nbuf - 128, voxels.shape[0])
    step = max(1, voxels.shape[0] // n)
    voxels, coors = voxels[::step][:n], coors[::step][:n]
    key = coors[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * int(s) + coors[:, a + 1]
    order = np.argsort(key, kind="stable")
    feats = np.zeros((nbuf, 3), np.float32)
    inds = np.full((nbuf, 4), -1, np.int32)
    feats[:len(order)] = voxels[order]
    inds[:len(order)] = coors[order]
    return feats, inds, tuple(int(s) for s in shape)


def write_artifact(out: Path, forward, inputs: Sequence[torch.Tensor],
                   package: bool = False) -> Dict[str, object]:
    """Writes the artifact of ``forward(*inputs)`` (tensors in, a tensor or
    a tuple of tensors out) to ``out``: ``model.pt2``, with ``package``
    also ``package.pt2``, the manifest, the inputs and the eager outputs.
    Returns ``{"blob": bytes, "outputs": eager outputs (a tuple),
    "package_s": seconds compiling the package (None without one)}``."""
    out.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        outputs = forward(*inputs)
    if isinstance(outputs, torch.Tensor):
        outputs = (outputs,)
    blob = serialize(forward, inputs)
    (out / "model.pt2").write_bytes(blob)
    package_s = None
    if package:
        t0 = time.perf_counter()
        aot_package(forward, inputs, out / "package.pt2")
        package_s = time.perf_counter() - t0
    lines = []
    for kind, tensors in (("input", inputs), ("output", outputs)):
        for n, t in enumerate(tensors):
            name = f"{'input' if kind == 'input' else 'expected'}_{n}.bin"
            # bf16 has no numpy dtype: its bits are written as int16
            raw = t.cpu().view(torch.int16) if t.dtype == torch.bfloat16 \
                else t.cpu()
            raw.numpy().tofile(out / name)
            dims = ",".join(str(d) for d in t.shape)
            lines.append(f"{kind} {_DTYPES[t.dtype]} {dims} {name}\n")
    (out / "manifest.txt").write_text("".join(lines))
    return {"blob": blob, "outputs": outputs, "package_s": package_s}


def run_loader(ops_library: Union[str, Path], loader: Union[str, Path],
               artifact: Union[str, Path], requests: int = 1,
               timeout: float = 600) -> Dict[str, object]:
    """Runs the C++ loader (``_build.build_loader``) on ``artifact`` with
    the op library ``ops_library`` (``_build.build_ops_library``), in a
    process of its own whose environment has no ``PYTHON*`` variable, and
    parses what it prints: ``{"rc", "stdout", "stderr", "ok" (LOADER_OK),
    "outputs": [{"dtype", "dims", "max_abs_diff", "max_abs_ref", "gate",
    "bitequal", "ok"}], "launches": {counter: n} of one request,
    "load_s", "request_ms": [ms a request]}`` (the last two with
    ``requests > 1``)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTHON")}
    r = subprocess.run([str(loader), str(ops_library), str(artifact),
                        str(requests)], capture_output=True, text=True,
                       timeout=timeout, env=env)
    res = {"rc": r.returncode, "stdout": r.stdout, "stderr": r.stderr,
           "ok": r.stdout.splitlines()[-1:] == ["LOADER_OK"],
           "outputs": [], "launches": {}, "load_s": None, "request_ms": []}
    for line in r.stdout.splitlines():
        if not line.strip():
            continue
        head, *rest = line.split()
        if head == "output" and rest[0].isdigit():
            fields = dict(f.split("=") for f in rest[3:-1])
            res["outputs"].append({
                "dtype": rest[1], "dims": rest[2],
                **{k: float(v) for k, v in fields.items()
                   if k != "bitequal"},
                "bitequal": fields["bitequal"] == "1",
                "ok": rest[-1] == "ok"})
        elif head == "launches":
            res["launches"] = {k: int(v) for k, v in
                               (f.split("=") for f in rest)}
        elif head == "load_s":
            res["load_s"] = float(rest[0])
        elif head == "request_ms":
            res["request_ms"] = [float(v) for v in rest]
    return res


def main(device=None, out_dir: Optional[Path] = None, seed: int = 0,
         nbuf: int = NBUF, package: bool = False) -> Dict[str, object]:
    """Exports the net on ``device`` (None: the CUDA card), writes the
    artifact to ``out_dir`` (default ``ARTIFACT``) and returns
    :func:`write_artifact`'s dict with ``"active"``: the active output
    sites.  ``package``: also compile ``package.pt2`` (some 25 s on the
    CPU), as the command line does."""
    device = default_device(device)
    out = Path(out_dir) if out_dir is not None else ARTIFACT
    net = build_net(device, nbuf)
    feats, inds, shape = load_input(seed, nbuf)
    f = torch.from_numpy(feats).to(device)
    i = torch.from_numpy(inds).to(device)

    def forward(f, i):
        y = net(SparseConvTensor(f, i, shape, 1, keys_sorted=True))
        return y.features, y.indices

    res = write_artifact(out, forward, (f, i), package=package)
    active = int((res["outputs"][1][:, 0] >= 0).sum())
    print(f"exported: {len(res['blob'])} B torch.export program"
          + (f", package.pt2 in {res['package_s']:.1f} s" if package else "")
          + f", {nbuf} voxel budget, {active} active output sites, to {out}")
    return {**res, "active": active}


if __name__ == "__main__":
    main(package=True)
