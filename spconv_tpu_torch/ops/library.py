"""The port's kernels as ``torch.library`` ops, in the ``spconv_tpu_torch``
namespace, so that ``torch.export`` traces a net through them
(``spconv_tpu_torch/export.py``).

One op per kernel family, each defined beside its wrapper:

* ``dg_pos`` (B1, ``ops/dg_conv.py``): the match table in every mode
  (subm, reversed, affine, divide, divide on swapped spaces);
* ``dg_gather_gemm`` (B2): every forward path, dgrad, S1 and S2;
* ``dg_fwd_q`` (B7): every int8 forward path and S4;
* ``dg_wgrad`` (wgrad): every dW path and S3;
* ``sk_pool`` (B6, ``ops/sorted_pool.py``): the sorted-key pool.

Each op has three kernels: on CUDA the hand-written launch, counted in
``ops.dg_conv.launch_counts``; on the CPU the plain version; and a fake
that gives the output's shape and dtype from the inputs' alone (no plan,
no SM count, no device property), which ``torch.export`` traces with.
The schemas take tensors, ``int``, ``int[]``, ``bool``, ``float``, ``str``
and ``int?``: a geometry goes in as int lists, a launch count's name as a
string.

The ops are registered with ``torch.library.Library``'s ``define`` and
``impl`` and ``torch.library.register_fake``, not the ``custom_op``
decorator, whose Python wrapper costs several times as much a call
(``PERF.md`` §6).  Importing the package registers them, so a
process that loads an exported program needs ``spconv_tpu_torch`` and none
of the model's modules.  The ops record no autograd graph: the autograd
Functions around the wrappers (``DGConvFn``, ``DGSearchFn``,
``IndiceConvFn``, ``SKPool2Fn``) differentiate.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NAMESPACE", "define_op"]

NAMESPACE = "spconv_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define_op(name: str, schema: str, *, cuda: Callable, cpu: Callable,
              fake: Callable):
    """Defines ``spconv_tpu_torch::<name><schema>`` with its CUDA, CPU and
    fake kernels; returns the op's overload, which the wrapper calls."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
