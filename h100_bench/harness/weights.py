"""The benchmark's weights, made on the device from the seed and loaded
into both the program and the reference.

One ``torch.rand`` call on a generator seeded with ``--seed`` draws every
conv weight, uniform in ``+-sqrt(6 / fan_in)`` (He's init for ReLU nets),
and every conv bias, uniform in ``+-1 / sqrt(fan_in)``, rounded once to
the dtype they are served in; BN scales start at 1 and shifts at 0, in
float32.  The reference takes the same values in float32.  The port's
own init (``+-1 / sqrt(fan_in)`` for the weights too) shrinks the signal
about tenfold a layer, so that the biases make up 99 % of the CenterPoint
BEV and a check of it would barely see the convs; He's keeps the signal
above the biases.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[str, Tuple[int, ...], str, int]
# a conv weight's and bias's bound, times 1 / sqrt(fan_in)
BOUND = {"weight": float(np.sqrt(6.0)), "bias": 1.0}


def draw(specs: Sequence[Spec], seed: int, device: torch.device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``specs`` (``reference/<config>.py::
    param_specs``): kinds ``weight`` and ``bias`` (a conv's) in ``dtype``,
    ``ones`` / ``zeros`` in float32."""
    sizes = [int(np.prod(shape)) for _, shape, kind, _ in specs
             if kind in BOUND]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in specs:
        if kind in BOUND:
            n = int(np.prod(shape))
            bound = BOUND[kind] / float(np.sqrt(fan_in))
            out[name] = ((flat[at:at + n] * 2 - 1) * bound).reshape(
                shape).to(dtype)
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
    return out


def load(net: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copies ``params`` into ``net``'s parameters of the same names,
    which must be exactly those."""
    named = dict(net.named_parameters())
    if set(named) != set(params):
        raise ValueError(
            "the program's parameters differ from the reference's: "
            f"only the program has {sorted(set(named) - set(params))}, "
            f"only the reference {sorted(set(params) - set(named))}")
    with torch.no_grad():
        for name, p in named.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(p.shape)}, the reference's "
                                 f"{tuple(params[name].shape)}")
            p.copy_(params[name])
