"""The port's spans and its table counter.

:func:`span` opens a ``torch.profiler.record_function`` range while a
profiler records, and is otherwise one shared ``contextlib.nullcontext``:
with the profiler off a span costs one boolean read and adds no device
op, sync or allocation.  The spans are profiler ranges, so the profiler
stamps them on the clock of its device activity: each device op can be
put against the span open at its launch, and each idle gap against the
span open at its start.  While ``torch.export`` traces, no profiler
records and no range enters a graph.

Every conv and pool opens a range under its layer's name
(``modules.run_layer``); the spans below open inside it, or inside
autograd's backward, all named ``spconv.*``:

===================  =================================================
span                 what it holds
===================  =================================================
``spconv.rulebook``  every match table, rulebook and output-discovery
                     build (B1, the sorts, the searches, the compares):
                     a subm stage's tables, a regular conv's output
                     discovery and its affine and divide tables, the
                     native rulebooks, a keyless subm conv's keys, a
                     pool's output discovery and rulebooks
``spconv.product``   the conv product with the weight's layout change:
                     B2 / B7 on a table, the search-mode kernels, the
                     native gather-GEMM, the 1x1 matmul
``spconv.epilogue``  bias, residual add, activation and the output mask
``spconv.pool``      a pool's reduction (B6, the seg route's, the
                     native pool's)
``spconv.bn``        ``BatchNorm1d``: statistics and normalization,
                     and in its backward the two reductions and
                     ``dx`` (``ops/batch_norm.py``)
``spconv.dense``     ``SparseConvTensor.dense``: the scatter into the
                     dense grid
``spconv.dgrad``     a conv's input gradient, with the cast of ``dout``
``spconv.wgrad``     a conv's weight gradient
``spconv.pool.bwd``  the sorted-key pool's backward
===================  =================================================

The backward of the epilogue and the seg pool runs as autograd's own
nodes, which open no span of the port: a reader of a trace reaches their
forward span through the node's sequence number.

``table_counts`` counts, on the host and always, the tables that the
convs and pools build and reuse, one increment at each site (a keyed
record or rulebook is built once and then reused by every later layer of
its key):

* ``subm.built`` / ``subm.reused``: a DG subm stage's match tables under
  its ``indice_key``;
* ``regular.built`` / ``regular.reused``: a regular or transposed conv's
  record (output discovery), and its reuse by a conv or inverse conv of
  the same key;
* ``native.built`` / ``native.reused``: the native path's rulebooks;
* ``pool.built``: a pool's output discovery or rulebook.

A subm conv without a key builds no table and counts nothing;
:func:`reset_table_counts` sets every count to 0.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "table_counts", "reset_table_counts"]

_OFF = contextlib.nullcontext()

# tables built and reused since the last reset_table_counts()
table_counts = dict.fromkeys(
    ("subm.built", "subm.reused", "regular.built", "regular.reused",
     "native.built", "native.reused", "pool.built"), 0)


def reset_table_counts() -> None:
    for name in table_counts:
        table_counts[name] = 0


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
