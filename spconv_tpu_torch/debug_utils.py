"""Debug helpers (counterpart of ``spconv_tpu/debug_utils.py``): the
opt-in check that a bounded output discovery kept every output site, and
``spconv_save_debug_data``, which pickles a problem's coordinates for a
bug report when ``SPCONV_TPU_DEBUG_SAVE_PATH`` names a directory."""

from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np

from . import constants

__all__ = ["spconv_save_debug_data", "maybe_assert_overflow"]


def maybe_assert_overflow(num_out_total, out_bound: int, context: str) -> None:
    """Under ``SPCONV_TPU_CHECK_OVERFLOW=1``, raise ``ValueError`` when a
    bounded output discovery found more sites than its static
    ``out_bound`` holds (it kept the smallest keys and dropped the rest).
    Reads the 0-d count on the host, so it syncs with the device: a debug
    check, off by default.  Without the flag it does nothing."""
    if not constants.SPCONV_CHECK_OVERFLOW:
        return
    bound = int(out_bound)
    total = int(num_out_total)
    if total > bound:
        raise ValueError(
            f"[SPCONV_TPU_CHECK_OVERFLOW] {context}: {total} active output "
            f"sites exceed the static out_bound {bound}; raise "
            f"out_bound / out_bound_ratio on this layer.")


def spconv_save_debug_data(indices) -> str:
    """Pickles ``indices`` (a tensor or an array) as a numpy array into
    ``SPCONV_TPU_DEBUG_SAVE_PATH`` (made if missing), in a file named by
    the time in ms, and returns its path; without the flag it writes
    nothing and returns ``""``.  The pickle is the JAX package's: the same
    array loads from either."""
    if not constants.SPCONV_DEBUG_SAVE_PATH:
        return ""
    path = Path(constants.SPCONV_DEBUG_SAVE_PATH)
    path.mkdir(parents=True, exist_ok=True)
    fname = path / f"spconv_tpu_debug_{int(time.time() * 1000)}.pkl"
    if hasattr(indices, "detach"):
        indices = indices.detach().cpu().numpy()
    with fname.open("wb") as f:
        pickle.dump(np.asarray(indices), f)
    return str(fname)
