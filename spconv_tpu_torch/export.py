"""Deployment export (counterpart of ``spconv_tpu/export.py``): a net, with
its output discovery, rulebooks and kernels, traced into one
``torch.export.ExportedProgram`` with static shapes, saved to portable
bytes and reloaded without the model's code.

Every kernel is a ``torch.library`` op (``ops/library.py``), so the
program holds one node per kernel call; on the card each runs the
hand-written kernel and counts its launch as an eager call does.  Loading
a blob needs ``import spconv_tpu_torch`` (which registers the ops), none
of the model's modules.  A C++ loader over libtorch reads the same bytes
(ROADMAP A12b).
"""

from __future__ import annotations

import io
from typing import Callable, Sequence, Union

import torch
from torch import nn

__all__ = ["export_inference", "serialize", "deserialize_and_call"]


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
