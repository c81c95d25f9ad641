"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of each conv's forward, input gradient and weight
gradient, counted from the benchmark's own rulebook (``reference/
sparse.py::LayerWork``), whatever implements them.

A conv does ``2 * C * K`` operations a matched pair in each of the three.
Its bytes count each input once and each output once: the forward reads
the active input rows and the weight and writes the active output rows;
the input gradient reads the output gradient and the weight and writes
the input gradient; the weight gradient reads the input and the output
gradient and writes the weight gradient, all in the served dtype.  A
kernel's least time is the larger of its operations over the peak rate
and its bytes over the peak bandwidth (its roofline bound).
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA's data sheet for the H100 SXM, dense (no sparsity), at 700 W:
# operations a second by the dtype the tensor cores (or, for float32, the
# FMA units the port's float32 kernels use) take, and HBM3 bytes a second
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
            "int8": 1979e12}
PEAK_BYTES = 3.35e12
ELT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def conv_ops(w) -> float:
    """Operations of one of a conv's three products."""
    return 2.0 * w.c * w.k * w.pairs


def conv_bytes(w, dtype: str) -> float:
    """Bytes of one of a conv's three products (each reads two of the
    input, the output (gradient) and the weight and writes the third)."""
    return float(w.n_in * w.c + w.kv * w.c * w.k + w.n_out * w.k) \
        * ELT_BYTES[dtype]


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for the work."""
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES)


PASSES = ("forward", "dgrad", "wgrad")


def runs(w, p: str) -> bool:
    """Whether conv ``w`` runs product ``p``: a net's first conv has no
    input gradient, since its input needs none."""
    if p not in PASSES:
        raise ValueError(f"a pass is one of {PASSES}, not {p!r}")
    return not (p == "dgrad" and w.first)


def pass_ops(work: Iterable, passes: Iterable[str]) -> float:
    """Operations of the products ``passes`` of every conv of ``work``."""
    return sum(conv_ops(w) for p in passes for w in work if runs(w, p))


def bound_s_of(work: Iterable, passes: Iterable[str], dtype: str) -> float:
    """Summed least time of the products ``passes`` of every conv."""
    return sum(bound_s(conv_ops(w), conv_bytes(w, dtype), dtype)
               for p in passes for w in work if runs(w, p))
