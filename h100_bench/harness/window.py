"""The measured window, which every loop kind (``loops/<kind>.py``)
shares: calls one after another, each ended by a device sync, with the
host's clock around each."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch
from torch.autograd import profiler as _profiler


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Range:
    """A ``record_function`` range while a profiler records, else
    nothing."""

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)


@dataclass
class Window:
    """What the window saw: each call's latency (host call to the end of
    its sync) and enqueue time (host call to the return), its ring slot,
    and the window's length (its first call to its last sync)."""

    latency_s: List[float] = field(default_factory=list)
    enqueue_s: List[float] = field(default_factory=list)
    slots: List[int] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def count(self) -> int:
        return len(self.latency_s)


def run_window(call: Callable, first: int, ring: int, seconds: float,
               device: torch.device,
               after: Optional[Callable] = None) -> Window:
    """Calls ``call(i)`` for ``i = first, first + 1, ...`` until
    ``seconds`` have passed at the end of a call's sync; ``after(i,
    out)`` runs after each call's timing (it keeps answers)."""
    win = Window()
    sync(device)
    start = time.perf_counter()
    i = first
    while True:
        t0 = time.perf_counter()
        out = call(i)
        t1 = time.perf_counter()
        sync(device)
        t2 = time.perf_counter()
        win.latency_s.append(t2 - t0)
        win.enqueue_s.append(t1 - t0)
        win.slots.append(i % ring)
        if after is not None:
            after(i, out)
        i += 1
        if t2 - start >= seconds:
            break
    sync(device)
    win.seconds = time.perf_counter() - start
    return win
