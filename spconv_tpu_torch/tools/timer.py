"""Timers of the reference's ``spconv/tools.py`` (counterpart of
``spconv_tpu/tools.py``): :class:`KernelTimer` (also under the reference's
name ``CUDAKernelTimer``) and :func:`benchmark_model`.

On the card both time with CUDA events on the stream the work is queued
on, and read them after one synchronisation; on the CPU they read the host
clock (``time.perf_counter``).  Nothing here needs the kernels' library.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..core import default_device

__all__ = ["KernelTimer", "CUDAKernelTimer", "benchmark_model"]


class KernelTimer:
    """Named time spans, nested as ``"outer.inner"`` keys (the reference's
    ``CUDAKernelTimer`` API and the JAX package's nesting).

    ``namespace(name)`` times the work queued inside it; a span opened
    again under the same key adds to it.  On a CUDA ``device`` (None: the
    card) a span is a pair of CUDA events recorded on the current stream
    (or ``record``'s ``stream``); no event is read inside a span, so the
    spans add no sync: :meth:`get_all_pair_time` synchronises once and
    sums each key's ms.  On the CPU a span reads the host clock.  With
    ``enable=False`` nothing is recorded."""

    def __init__(self, enable: bool = True,
                 device: Union[None, str, torch.device] = None):
        self.enable = enable
        self.device = default_device(device)
        self._ms: Dict[str, float] = {}
        self._pending: List[Tuple[str, torch.cuda.Event,
                                  torch.cuda.Event]] = []
        self._ns: List[str] = []

    @contextlib.contextmanager
    def namespace(self, name: str, stream=None):
        """Times the work inside under the key of the open namespaces and
        ``name``.  ``stream``: the CUDA stream to record on (None or 0:
        the current one)."""
        self._ns.append(name)
        key = ".".join(self._ns)
        try:
            if not self.enable:
                yield
            elif self.device.type == "cuda":
                s = (torch.cuda.current_stream(self.device)
                     if stream in (None, 0) else stream)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(s)
                try:
                    yield
                finally:
                    end.record(s)
                    self._pending.append((key, start, end))
            else:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._ms[key] = self._ms.get(key, 0.0) + (
                        time.perf_counter() - t0) * 1e3
        finally:
            self._ns.pop()

    @contextlib.contextmanager
    def record(self, name: str, stream=None):
        """:meth:`namespace` under the reference's name."""
        with self.namespace(name, stream):
            yield

    def get_all_pair_time(self) -> Dict[str, float]:
        """``{key: ms}`` summed over every span of each key so far (one
        device sync when CUDA spans are pending)."""
        if self._pending:
            torch.cuda.synchronize(self.device)
            for key, start, end in self._pending:
                self._ms[key] = self._ms.get(key, 0.0) + start.elapsed_time(
                    end)
            self._pending.clear()
        return dict(self._ms)


CUDAKernelTimer = KernelTimer  # the reference's name


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def benchmark_model(fn: Callable, args, rep: int = 10, n_outer: int = 3,
                    perturb: Optional[Callable] = None) -> float:
    """The ms of one ``fn(*args)``: one warm-up call, then ``n_outer``
    rounds of ``rep`` calls, each round timed whole and divided by
    ``rep``; the median round is returned.  ``perturb(i, args) -> args``,
    when given, makes the arguments of call ``i`` of a round.

    When the first tensor in ``args`` lies on a CUDA device a round is
    timed by two CUDA events on the current stream around its ``rep``
    calls, read after the round's sync: the device time between the first
    call's start and the last call's end, idle gaps included where the
    host queues slower than the card runs.  Otherwise (the CPU) the host
    clock times each round.  The JAX version subtracts a dispatch floor
    measured inside ``jit``; there is no such floor to subtract here."""
    device = _device_of(args)
    cuda = device.type == "cuda"

    def call(i):
        return fn(*(perturb(i, args) if perturb is not None else args))

    call(0)
    if cuda:
        torch.cuda.synchronize(device)
    rounds = []
    for _ in range(n_outer):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(rep):
                call(i)
            end.record()
            end.synchronize()
            rounds.append(start.elapsed_time(end) / rep)
        else:
            t0 = time.perf_counter()
            for i in range(rep):
                call(i)
            rounds.append((time.perf_counter() - t0) * 1e3 / rep)
    return float(statistics.median(rounds))
