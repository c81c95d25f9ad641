"""The probe scripts of the JAX package's ``tools/`` directory, on the
card (counterparts of ``tools/probe_int8.py``, ``probe_dg.py``,
``probe_cast.py``, ``probe_dma_align.py`` and ``probe_sk_v2.py`` /
``probe_sk_v3.py``).

Each module runs its probe's cases through the port's kernels
(``ops.probes``; ``probe_sk`` through the search-mode subm conv) and prints
one ``<case>: OK`` or ``<case>: WRONG`` line per case against the numpy
reference its Pallas probe checks against.  ``main(device=None)`` runs on
the CUDA card unless the caller passes ``device="cpu"`` (then the plain
versions run) and returns ``{case: ok}``.  Run one with, e.g.::

    python -m spconv_tpu_torch.tools.probe_dg

Beside them: the kernel ablation and counting scripts on the card
(``b2_ablation``, ``wgrad_ablation``, ``b7_ablation``, ``table_count``,
sharing ``ablation``'s harness), ``b6_tiles`` (the sweep behind B6's tile
rule), ``gemm_tiles`` (the sweep behind the probe GEMMs' plan, and their
ablations), ``copy_tiles`` (the same for the probe copy and transpose) and
``table_cases``, the edge inputs of the table and pool kernels that the
tests and ``chip_smoke.py`` share.
"""

from typing import Dict

__all__ = ["report"]


def report(results: Dict[str, bool], case: str, ok: bool,
           note: str = "") -> None:
    """Records ``case`` in ``results`` and prints its ``OK`` / ``WRONG``
    line."""
    results[case] = bool(ok)
    print(f"{case}: {'OK' if ok else 'WRONG'}{note}", flush=True)
