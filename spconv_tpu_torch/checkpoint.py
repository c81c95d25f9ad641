"""Load a JAX-package state dict into a port module.

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
from typing import Dict

import numpy as np
import torch
from torch import nn

from .modules.modules import SparseSequential

__all__ = ["load_jax_state_dict"]


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
