"""Fixed conventions of the PyTorch port (counterpart of
``spconv_tpu/constants.py``).

Only what the port reads lives here: the weight layout that a state dict
carries between the two packages, and the conv algorithm a layer takes when
none is given.
"""

from __future__ import annotations

# Conv weights are KRSC: ``[K_out, *kernel_size, C_in]`` (the reference's
# 2.2+ layout, the same as the JAX package), so a state dict moves across
# unchanged.
WEIGHT_LAYOUT = "KRSC"

# Layer default when ``algo`` is not given.  ``"auto"`` resolves to the
# dynamic-gather path (``"dg"``) on key-sorted input; the native rulebook
# path of the JAX package is not ported yet (ROADMAP A4-A5).
DEFAULT_ALGO = "auto"
