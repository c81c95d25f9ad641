"""The traced run's profiled parts and their reduction to numbers.

``profile_part`` runs a few calls under ``torch.profiler`` and keeps
every device op (kernels, copies, fills) with its start and end, and,
with ``host=True``, every host event.  A part with device activity alone
costs the host least, so the run reads its numbers from one; a second
part with host activity too labels the idle gaps.  From a part:

* ``kernel_s(patterns)``: the summed device time of the ops whose name
  holds one of ``patterns`` (each per-layer metric names its kernels);
* ``busy_s``: the length of the union of the device ops' intervals, and
  ``window_s``: the part's length on the host clock, from its first call
  to its last sync;
* ``breakdown``: the device ops that took the most time, by name, and the
  device's idle gaps summed by what the host had open at their start: the
  innermost ``record_function`` range (the port opens one around each
  conv and pool, the benchmark around the forward, loss, backward and
  update) and the innermost host op.

A part in which the profiler kept no device op is tried again, up to
``tries`` times, and then fails the run: it never reads as all idle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

NAME_CHARS = 160  # a kernel's name in the breakdown (templates are long)


@dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]   # name, start us, end us
    host_ops: List[Tuple[str, float, float, bool]]  # ..., user range
    window_s: float
    slots: List[int]

    def kernel_s(self, patterns: Sequence[str]) -> float:
        return sum(e - s for n, s, e in self.device_ops
                   if any(p in n for p in patterns)) / 1e6

    def merged(self) -> List[Tuple[float, float]]:
        spans = sorted((s, e) for _, s, e in self.device_ops)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def _labeller(self) -> Callable[[float], str]:
        """``label(t)``: the innermost host range and host op open at
        ``t`` (the latest-starting event that holds it)."""
        users = sorted((s, e, n) for n, s, e, u in self.host_ops if u)
        ops = sorted((s, e, n) for n, s, e, u in self.host_ops if not u)
        op_starts = [s for s, _, _ in ops]

        def inner(events, hi, t):
            for s, e, n in reversed(events[max(0, hi - 64):hi]):
                if t < e:
                    return n
            return "-"

        def label(t: float) -> str:
            user = "-"
            for s, e, n in reversed(users):
                if s <= t < e:
                    user = n
                    break
            return f"{user} | {inner(ops, bisect.bisect_right(op_starts, t), t)}"
        return label

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        gaps: Dict[str, float] = {}
        spans = self.merged()
        label_at = self._labeller()
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            label = label_at(e0)
            gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
        order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gap_order = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in order],
                "idle_gaps": [[n, s] for n, s in gap_order]}


def profile_part(call: Callable[[int], object], first: int, n: int,
                 ring: int, sync: Callable[[], None], host: bool,
                 tries: int = 3) -> Trace:
    """Runs ``call(first)`` .. ``call(first + n - 1)``, each followed by
    ``sync()``, under the profiler, with host activity too when ``host``;
    see the module docstring."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    for attempt in range(tries):
        sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + n):
                call(i)
                sync()
            window_s = time.perf_counter() - t0
        dev, hosts = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if not e.is_user_annotation:
                    dev.append((e.name, float(tr.start), float(tr.end)))
            else:
                # a record_function range; the profiler does not flag
                # every one as a user annotation, but no host op's name
                # lacks a "::" or a "cuda" prefix
                user = bool(e.is_user_annotation) or not (
                    "::" in e.name or e.name.startswith("cuda"))
                hosts.append((e.name, float(tr.start), float(tr.end),
                              user))
        if dev:
            return Trace(dev, hosts, window_s,
                         [i % ring for i in range(first, first + n)])
        first += n
    raise RuntimeError(f"the profiler kept no device op in {tries} "
                       f"profiled parts of {n} calls")
