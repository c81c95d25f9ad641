"""Fixed conventions and flags of the PyTorch port (counterpart of
``spconv_tpu/constants.py``).

Only what the port reads lives here: the weight layout that a state dict
carries between the two packages, the conv algorithm a layer takes when
none is given (``SPCONV_TPU_ALGO``), the reference's algorithm enum, the
tuner's switch and cache directory (``SPCONV_TPU_TUNE``,
``SPCONV_TPU_TUNE_CACHE``), the opt-in overflow check and the debug dump's
directory (``SPCONV_TPU_DEBUG_SAVE_PATH``), each read when the port is
imported.  The JAX package's ``SPCONV_TPU_OUT_BOUND_RATIO`` and
``SPCONV_TPU_FP32_HIGHEST`` are not ported: nothing in that package reads
them.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path

# Conv weights are KRSC: ``[K_out, *kernel_size, C_in]`` (the reference's
# 2.2+ layout, the same as the JAX package), so a state dict moves across
# unchanged.
WEIGHT_LAYOUT = "KRSC"

# Layer default when ``algo`` is not given.  ``"auto"`` resolves per call
# through the tuner (``tuner.CONV_TUNER.select_algo``): a cached winner,
# else the dynamic-gather path (``"dg"``) where it serves the input
# (key-sorted rows on a grid of int32 keys), else the native rulebook path.
# ``SPCONV_TPU_ALGO=native`` / ``dg`` / ``sk`` forces one for every layer
# built without an ``algo``.
DEFAULT_ALGO = os.getenv("SPCONV_TPU_ALGO", "auto")

# Tune-on-first-call (``tuner.ConvTuner.tune_enabled``): the first
# ``"auto"`` call of each conv signature times every candidate on the live
# tensor and caches the winner.
SPCONV_TUNE = os.getenv("SPCONV_TPU_TUNE", "0") == "1"

# The tuner's on-disk cache directory.  The port keeps its own, apart from
# the JAX package's ``~/.cache/spconv_tpu``, so a winner timed on a TPU is
# never read as a winner on the card.
SPCONV_TUNE_CACHE = os.getenv(
    "SPCONV_TPU_TUNE_CACHE",
    str(Path.home() / ".cache" / "spconv_tpu_torch"))

# Debug: every bounded output discovery (pools, strided convs) checks on
# the host that its static out_bound kept every site, and raises if not
# (``debug_utils.maybe_assert_overflow``; one device sync per bounded op).
# Without the flag, ``SparseConvTensor.check_overflow()`` does the same on
# demand.
SPCONV_CHECK_OVERFLOW = os.getenv("SPCONV_TPU_CHECK_OVERFLOW", "0") == "1"

# Debug: the directory ``debug_utils.spconv_save_debug_data`` pickles a
# problem's coordinates into (the reference's SPCONV_DEBUG_SAVE_PATH); empty
# (the default): it writes nothing.
SPCONV_DEBUG_SAVE_PATH = os.getenv("SPCONV_TPU_DEBUG_SAVE_PATH", "")


class ConvAlgo(enum.Enum):
    """The reference's algorithm enum (``spconv/core.py``: Native /
    MaskImplicitGemm / MaskSplitImplicitGemm), which the conv modules accept
    in place of the string.  Both implicit-GEMM members are ``"sk"``, as in
    the JAX package (the second is an alias of the first); in the port
    ``"sk"`` runs the dynamic-gather kernels."""

    Native = "native"
    MaskImplicitGemm = "sk"
    MaskSplitImplicitGemm = "sk"
