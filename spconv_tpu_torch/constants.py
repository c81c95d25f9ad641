"""Fixed conventions of the PyTorch port (counterpart of
``spconv_tpu/constants.py``).

Only what the port reads lives here: the weight layout that a state dict
carries between the two packages, the conv algorithm a layer takes when
none is given, and the opt-in overflow check.
"""

from __future__ import annotations

import os

# Conv weights are KRSC: ``[K_out, *kernel_size, C_in]`` (the reference's
# 2.2+ layout, the same as the JAX package), so a state dict moves across
# unchanged.
WEIGHT_LAYOUT = "KRSC"

# Layer default when ``algo`` is not given.  ``"auto"`` resolves to the
# dynamic-gather path (``"dg"``) where it serves the input (key-sorted rows
# on a grid of int32 keys), else to the native rulebook path.
DEFAULT_ALGO = "auto"

# Debug: every bounded output discovery (pools, strided convs) checks on
# the host that its static out_bound kept every site, and raises if not
# (``debug_utils.maybe_assert_overflow``; one device sync per bounded op).
# Without the flag, ``SparseConvTensor.check_overflow()`` does the same on
# demand.
SPCONV_CHECK_OVERFLOW = os.getenv("SPCONV_TPU_CHECK_OVERFLOW", "0") == "1"
