"""Debug checks (counterpart of ``spconv_tpu/debug_utils.py``).

Only ``maybe_assert_overflow`` is ported: the opt-in check that a bounded
output discovery kept every output site."""

from __future__ import annotations

from . import constants

__all__ = ["maybe_assert_overflow"]


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
