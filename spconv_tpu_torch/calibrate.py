"""Output-buffer calibration (counterpart of ``spconv_tpu/calibrate.py``).

Every regular conv and pool of the port writes into a static buffer of
``out_bound`` rows.  This module records each such layer's active output
count over calibration inputs and returns a copy of the net with snug
bounds set, and exports and applies those bounds as a plain list, in one
deterministic layer order (``net.modules()``).  Recording reads counts on
the host, so it syncs once per layer; served forwards never record.

As in the JAX package the recorded count is the clamped ``num_out``: a
layer whose output was already cut by its bound calibrates to the cut
size (a reference behaviour, listed in ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch import nn

__all__ = ["calibrate_out_bounds", "record_voxel_counts",
           "export_out_bounds", "apply_out_bounds"]

_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "spconv_tpu_torch_voxel_recorder", default=None)


def _maybe_record(module: nn.Module, num_out: torch.Tensor) -> None:
    """Record ``module``'s output count when a recorder is active."""
    rec = _RECORDER.get()
    if rec is None:
        return
    rec[id(module)] = max(rec.get(id(module), 0), int(num_out))


@contextlib.contextmanager
def record_voxel_counts() -> Iterator[Dict[int, int]]:
    """Context manager yielding ``{id(layer): max active output count}``
    over the forwards run inside it."""
    rec: Dict[int, int] = {}
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def _round_up(n: int, mult: int) -> int:
    return max(mult, -(-n // mult) * mult)


def _layers(net: nn.Module) -> List[nn.Module]:
    """Every conv and pool of ``net``, in module registration order."""
    from .modules.conv import SparseConvolution
    from .modules.pool import SparseMaxPool

    return [m for m in net.modules()
            if isinstance(m, (SparseConvolution, SparseMaxPool))]


def calibrate_out_bounds(net: nn.Module,
                         run: Optional[Callable[[nn.Module, object], object]],
                         inputs: Sequence, margin: float = 1.1,
                         mult: int = 512) -> nn.Module:
    """Run ``run(net, x)`` (default ``net(x)``) under ``torch.no_grad()``
    over the calibration inputs, recording each regular conv's and pool's
    active output count, and return a deep copy of ``net`` whose recorded
    layers have ``out_bound = round_up(max_count * margin, mult)``.
    ``net`` itself is left as it is."""
    if run is None:
        run = lambda m, x: m(x)  # noqa: E731
    with record_voxel_counts() as rec, torch.no_grad():
        for x in inputs:
            run(net, x)
    new = copy.deepcopy(net)
    for old, layer in zip(_layers(net), _layers(new)):
        if id(old) in rec:
            layer.out_bound = _round_up(int(rec[id(old)] * margin), mult)
    return new


def export_out_bounds(net: nn.Module) -> List[Optional[int]]:
    """Per-layer ``out_bound`` list (None where unset, e.g. subm convs),
    in the order :func:`apply_out_bounds` reads."""
    return [layer.out_bound for layer in _layers(net)]


def apply_out_bounds(net: nn.Module,
                     bounds: Sequence[Optional[int]]) -> nn.Module:
    """Inverse of :func:`export_out_bounds`: a deep copy of ``net`` with
    each layer's bound set from ``bounds`` (None entries leave it)."""
    new = copy.deepcopy(net)
    layers = _layers(new)
    if len(layers) != len(bounds):
        raise ValueError(f"bounds list has {len(bounds)} entries for "
                         f"{len(layers)} layers")
    for layer, b in zip(layers, bounds):
        if b is not None:
            layer.out_bound = int(b)
    return new
