"""Load a JAX-package state dict into a port module.

``spconv_tpu.checkpoint.state_dict`` returns a dict of numpy arrays keyed by
dotted attribute path (``convs.0.weight``).  The port keeps the JAX
attribute names and the KRSC weight layout, so the keys and shapes match
``module.state_dict()`` one to one; a transposed conv's weight too moves
across unflipped, as its kernels read ``W[k]`` as it is.  The one exception: a JAX int8 conv
keeps its fp conv's configuration as ``base`` with a ``(1,)`` placeholder
weight (``base.weight``), which the port's ``QuantizedSparseConv`` does not
have; such keys are skipped and named in a warning.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state_dict"]


def load_jax_state_dict(module: nn.Module, sd: Dict[str, np.ndarray],
                        strict: bool = True) -> nn.Module:
    """Copy the arrays of ``sd`` into ``module``'s parameters and buffers,
    in place, cast to each tensor's dtype and device.  Shapes must match.
    With ``strict`` (the default), a key missing on either side raises
    ``KeyError``; the JAX int8 convs' ``base.weight`` placeholders are
    skipped with a warning.  Modules with derived tensors (the int8 convs'
    ``refold``) re-derive them.  Returns ``module``."""
    own = module.state_dict(keep_vars=True)
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
