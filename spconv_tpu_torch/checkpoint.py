"""Checkpoints (counterpart of ``spconv_tpu/checkpoint.py``): npz save and
load, reference (PyTorch spconv) state dicts in any of its weight layouts,
and JAX-package state dicts.  ``state_dict`` / ``load_state_dict`` are
``nn.Module``'s own.

``spconv_tpu.checkpoint.state_dict`` returns a dict of numpy arrays keyed by
dotted attribute path (``convs.0.weight``).  The port keeps the JAX
attribute names and the KRSC weight layout, so the keys and shapes match
``module.state_dict()`` one to one; a transposed conv's weight too moves
across unflipped, as its kernels read ``W[k]`` as it is.  The one exception: a JAX int8 conv
keeps its fp conv's configuration as ``base`` with a ``(1,)`` placeholder
weight (``base.weight``), which the port's ``QuantizedSparseConv`` does not
have; such keys are skipped and named in a warning.  A JAX
``SparseSequential`` keeps its layers in a list, ``layers.<i>.``; the
port's registers them as modules, ``<i>.`` (or a named layer's name), and
both spellings load.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch
from torch import nn

from .modules.modules import SparseSequential

__all__ = ["load_jax_state_dict", "save_checkpoint", "load_checkpoint",
           "convert_torch_weight_layout", "load_torch_state_dict"]


def _port_key(module: nn.Module, key: str) -> str:
    """``key`` with each JAX ``SparseSequential``'s ``layers.<i>`` turned
    into the name of the port container's ``i``-th layer, walking the
    port's module tree along the key."""
    parts = key.split(".")
    out = []
    m = module
    i = 0
    while i < len(parts):
        part = parts[i]
        if (isinstance(m, SparseSequential) and part == "layers"
                and i + 1 < len(parts) and parts[i + 1].isdigit()
                and int(parts[i + 1]) < len(m)):
            part = list(m._modules)[int(parts[i + 1])]
            i += 1
        out.append(part)
        m = m._modules.get(part) if isinstance(m, nn.Module) else None
        i += 1
    return ".".join(out)


def load_jax_state_dict(module: nn.Module, sd: Dict[str, np.ndarray],
                        strict: bool = True) -> nn.Module:
    """Copy the arrays of ``sd`` into ``module``'s parameters and buffers,
    in place, cast to each tensor's dtype and device.  Shapes must match.
    With ``strict`` (the default), a key missing on either side raises
    ``KeyError``; the JAX int8 convs' ``base.weight`` placeholders are
    skipped with a warning.  A key that ``module`` lacks is read with
    every JAX ``SparseSequential``'s ``layers.<i>`` renamed to the port
    container's layer name.  Modules with derived tensors (the int8 convs'
    ``refold``) re-derive them.  Returns ``module``."""
    own = module.state_dict(keep_vars=True)
    sd = {k if k in own else _port_key(module, k): v for k, v in sd.items()}
    placeholders = sorted(
        k for k in set(sd) - set(own)
        if k.endswith("base.weight") and np.shape(sd[k]) == (1,))
    if placeholders:
        warnings.warn(f"skipped {len(placeholders)} JAX int8-conv "
                      f"placeholder weights: {placeholders}")
    if strict:
        missing = sorted(set(own) - set(sd))
        if missing:
            raise KeyError(f"missing keys in state dict: {missing[:5]}")
        extra = sorted(set(sd) - set(own) - set(placeholders))
        if extra:
            raise KeyError(f"unexpected keys in state dict: {extra[:5]}")
    with torch.no_grad():
        for key, t in own.items():
            if key not in sd:
                continue
            arr = np.asarray(sd[key])
            if arr.dtype.kind not in "biuf":
                # e.g. ml_dtypes' bfloat16, which torch cannot wrap; the
                # widening to f32 is exact
                arr = arr.astype(np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
    for m in module.modules():
        refold = getattr(m, "refold", None)
        if callable(refold):
            refold()
    return module


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy; bf16 as f32 (numpy has no bf16; the
    widening is exact, so a load gives the same bits back)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_checkpoint(module: nn.Module, path: Union[str, Path]) -> None:
    """``module.state_dict()`` as an npz of numpy arrays, keyed as the
    state dict (bf16 tensors stored as f32)."""
    np.savez(str(path), **{k: _numpy(t)
                           for k, t in module.state_dict().items()})


def load_checkpoint(module: nn.Module, path: Union[str, Path],
                    strict: bool = True) -> nn.Module:
    """Loads an npz written by :func:`save_checkpoint` or by the JAX
    package's ``save_checkpoint`` into ``module``, in place, through
    :func:`load_jax_state_dict` (so the JAX ``layers.<i>`` keys load too).
    Returns ``module``."""
    with np.load(str(path)) as f:
        sd = {k: f[k] for k in f.files}
    return load_jax_state_dict(module, sd, strict=strict)


def convert_torch_weight_layout(w, layout: str, ndim: int):
    """A reference conv weight (numpy array or tensor) in KRSC: ``KRSC`` =
    ``[K, *ks, C]`` as it is, ``RSKC`` = ``[*ks, K, C]`` and ``RSCK`` =
    ``[*ks, C, K]`` moved to it."""
    move = np.moveaxis if isinstance(w, np.ndarray) else torch.movedim
    if layout == "KRSC":
        return w
    if layout == "RSKC":
        return move(w, ndim, 0)
    if layout == "RSCK":
        return move(w, ndim + 1, 0)
    raise ValueError(f"unknown layout {layout}")


def load_torch_state_dict(module: nn.Module, torch_sd: Dict,
                          layout: str = "KRSC") -> nn.Module:
    """Loads a reference spconv (PyTorch) state dict into ``module``, in
    place.  Each of ``module``'s keys takes the entry of the same name, or
    else the one entry whose key ends with it or that it ends with, at a
    dot (the containers may nest differently); a key with no such entry
    raises ``KeyError``.  A ``...weight`` of 3 or more axes whose shape
    differs is a conv weight in ``layout`` (``KRSC``, ``RSKC``, ``RSCK``),
    moved to KRSC.  Returns ``module``."""
    sd = {k: (_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in torch_sd.items()}
    out = {}
    for key, t in module.state_dict().items():
        if key in sd:
            arr = sd[key]
        else:
            cands = [k for k in sd
                     if key.endswith("." + k) or k.endswith("." + key)]
            if len(cands) != 1:
                raise KeyError(f"cannot match parameter {key}")
            arr = sd[cands[0]]
        if (tuple(arr.shape) != tuple(t.shape) and key.endswith("weight")
                and arr.ndim >= 3):
            arr = convert_torch_weight_layout(arr, layout, arr.ndim - 2)
        out[key] = arr
    return load_jax_state_dict(module, out, strict=False)
