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
  manifest.txt     one line a tensor: "input|output dtype d0,d1 file"
  input_*.bin      raw little-endian row-major inputs
  expected_*.bin   the eager outputs, for a loader's check

A C++ loader over libtorch is to read this directory (ROADMAP A12b).

Usage: python -m spconv_tpu_torch.examples.export_model
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .. import SparseConvTensor, SparseSequential, default_device
from ..benchmark.basic import synthetic_scan
from ..export import serialize
from ..modules import SparseConv3d, SubMConv3d

__all__ = ["ARTIFACT", "NBUF", "WEIGHT_SEED", "build_net", "load_input",
           "main"]

ARTIFACT = Path(__file__).resolve().parent / "artifact"
NBUF = 16384  # the deployment's voxel budget, the JAX example's
WEIGHT_SEED = 7
_DTYPES = {torch.float32: "f32", torch.int32: "s32"}


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


def main(device=None, out_dir: Optional[Path] = None, seed: int = 0,
         nbuf: int = NBUF) -> Dict[str, object]:
    """Exports the net on ``device`` (None: the CUDA card), writes the
    artifact to ``out_dir`` (default ``ARTIFACT``) and returns ``{"blob":
    bytes, "outputs": eager outputs, "active": active output sites}``."""
    device = default_device(device)
    out = Path(out_dir) if out_dir is not None else ARTIFACT
    out.mkdir(parents=True, exist_ok=True)
    net = build_net(device, nbuf)
    feats, inds, shape = load_input(seed, nbuf)
    f = torch.from_numpy(feats).to(device)
    i = torch.from_numpy(inds).to(device)

    def forward(f, i):
        y = net(SparseConvTensor(f, i, shape, 1, keys_sorted=True))
        return y.features, y.indices

    with torch.no_grad():
        outputs = forward(f, i)
    blob = serialize(forward, (f, i))
    (out / "model.pt2").write_bytes(blob)
    lines = []
    for kind, tensors in (("input", (f, i)), ("output", outputs)):
        for n, t in enumerate(tensors):
            name = f"{'input' if kind == 'input' else 'expected'}_{n}.bin"
            t.cpu().numpy().tofile(out / name)
            dims = ",".join(str(d) for d in t.shape)
            lines.append(f"{kind} {_DTYPES[t.dtype]} {dims} {name}\n")
    (out / "manifest.txt").write_text("".join(lines))
    active = int((outputs[1][:, 0] >= 0).sum())
    print(f"exported: {len(blob)} B torch.export program, {nbuf} voxel "
          f"budget, {active} active output sites, to {out}")
    return {"blob": blob, "outputs": outputs, "active": active}


if __name__ == "__main__":
    main()
