"""The port's spans in a profiled part: each device op attributed to the
``spconv.*`` span open at its launch, and the device's idle gaps split
by whether the host had a port range open at their start.

It works on the profiler's raw events (:func:`from_kineto`, from
``prof.profiler.kineto_results.events()``) of a part profiled with host
and device activity.  ``span_times.py`` profiles a cell's calls and
prints what :func:`attribute` finds; no reader of a run uses it, since
the runner keeps no raw event of its parts.

Attribution (:func:`attribute`):

* a device op's launch is the host op that its linked correlation id
  names (the innermost op open at the launch, on the thread ids of the
  ranges), else the runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) of its correlation id; time overlap is never
  used;
* the op goes to the innermost ``spconv.*`` span open on the launching
  thread at the launch;
* a launch inside autograd's backward with no span around it (BN's,
  the epilogue's and the seg pool's backward are autograd's own nodes)
  goes to the span open around the forward op of the same autograd
  sequence number on the forward's thread;
* the rest is outside every span (the loss, the update, the harness's
  copies, the net's own Python between layers).

Gaps are the idle intervals between the part's merged device intervals,
as ``trace.py`` finds them.  A gap is the port's when a port range holds
its start on some host thread: a ``spconv.*`` span, or a layer range, a
range that directly holds a ``spconv.*`` span and no other such range
(each conv and pool opens one; the caller's range around a whole
forward, which directly holds ``spconv.bn`` and ``spconv.dense`` besides
the layers, is not one).  Ranges are events that ``trace.py`` counts as
user ranges.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from h100_bench.harness.trace import Trace

PREFIX = "spconv."


@dataclass(frozen=True)
class Ev:
    """One profiler event, times in µs.  ``kind``: ``"device"`` (a
    kernel, copy or fill on the card), ``"runtime"`` (a host call into
    the CUDA runtime or driver), ``"range"`` (a ``record_function`` range
    or an autograd node, ``trace.py``'s user ranges) or ``"op"`` (any
    other host op)."""

    name: str
    kind: str
    tid: int
    start: float
    end: float
    corr: int = 0
    linked: int = 0
    seq: int = -1       # autograd sequence number, -1 for none
    fwd_tid: int = 0    # a backward node's forward thread, else 0

    @property
    def backward(self) -> bool:
        return self.seq >= 0 and self.fwd_tid != 0


class Nest:
    """Properly nested intervals of one thread; :meth:`at` finds the
    innermost one holding a time."""

    def __init__(self, evs: Iterable[Ev]):
        self.evs = sorted(evs, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.evs]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, e in enumerate(self.evs):
            while stack and self.evs[stack[-1]].end <= e.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def index_at(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.evs[i].end <= t:
            i = self.parent[i]
        return i

    def at(self, t: float) -> Optional[Ev]:
        i = self.index_at(t)
        return self.evs[i] if i >= 0 else None


def _by_thread(evs: Iterable[Ev]) -> Dict[int, Nest]:
    groups: Dict[int, List[Ev]] = defaultdict(list)
    for e in evs:
        groups[e.tid].append(e)
    return {tid: Nest(g) for tid, g in groups.items()}


def _at(nests: Dict[int, Nest], tid: int, t: float) -> Optional[Ev]:
    nest = nests.get(tid)
    return nest.at(t) if nest is not None else None


def port_ranges(ranges: Iterable[Ev]) -> List[Ev]:
    """The ``spconv.*`` spans and the layer ranges among ``ranges``."""
    out, layers = [], {}
    for nest in _by_thread(ranges).values():
        parent_of = {}
        for i, e in enumerate(nest.evs):
            p = nest.parent[i]
            if e.name.startswith(PREFIX):
                out.append(e)
                if p >= 0 and not nest.evs[p].name.startswith(PREFIX):
                    layers[(e.tid, p)] = nest.evs[p]
                    parent_of[p] = nest.parent[p]
        # a candidate that directly holds another is a caller's range
        outer = {parent_of[p] for p in parent_of}
        for p in parent_of:
            if p in outer:
                del layers[(nest.evs[p].tid, p)]
    return out + list(layers.values())


@dataclass
class Attribution:
    """Device µs by span over the part, the rest, and the gaps' split."""

    calls: int
    by_span: Dict[str, float] = field(default_factory=dict)
    outside: float = 0.0
    total: float = 0.0
    unlaunched: float = 0.0      # device ops with no launch found
    backward: float = 0.0        # device ops launched inside backward
    backward_reached: float = 0.0
    gap_port: float = 0.0
    gap_total: float = 0.0

    def span_ms(self, name: str) -> Optional[float]:
        """Device ms a call attributed to span ``name``; None when it
        never opened."""
        if name not in self.by_span:
            return None
        return self.by_span[name] / self.calls / 1e3

    @property
    def port_gap_share(self) -> float:
        return self.gap_port / self.gap_total if self.gap_total > 0 else 0.0

    def summary(self) -> dict:
        ms = 1e3 * self.calls
        return {
            "calls": self.calls,
            "span_ms": {k: v / ms for k, v in sorted(self.by_span.items())},
            "outside_ms": self.outside / ms, "total_ms": self.total / ms,
            "unlaunched_ms": self.unlaunched / ms,
            "closure": (sum(self.by_span.values()) + self.outside
                        - self.total) / self.total if self.total else 0.0,
            "backward_ms": self.backward / ms,
            "backward_reached": (self.backward_reached / self.backward
                                 if self.backward else None),
            "gap_ms": self.gap_total / ms, "port_gap_ms": self.gap_port / ms,
        }


def attribute(events: List[Ev], calls: int) -> Attribution:
    """See the module docstring."""
    device = [e for e in events if e.kind == "device"]
    # 0 is no correlation
    runtime = {e.corr: e for e in events if e.kind == "runtime" and e.corr}
    host_ops = {e.corr: e for e in events
                if e.kind in ("op", "range") and e.corr}
    ranges = [e for e in events if e.kind == "range"]
    spans = _by_thread(e for e in ranges if e.name.startswith(PREFIX))
    nodes = _by_thread(e for e in events
                       if e.backward and e.kind in ("op", "range"))
    forward_of: Dict[Tuple[int, int], Ev] = {}
    for e in sorted((e for e in events if e.seq >= 0 and e.fwd_tid == 0
                     and e.kind != "device"), key=lambda e: e.start):
        # the node takes its number last: the latest op that holds it
        forward_of[(e.tid, e.seq)] = e

    out = Attribution(calls)
    for d in device:
        dt = d.end - d.start
        out.total += dt
        launch = host_ops.get(d.linked) or runtime.get(d.corr)
        if launch is None:
            out.unlaunched += dt
            out.outside += dt
            continue
        span = _at(spans, launch.tid, launch.start)
        node = _at(nodes, launch.tid, launch.start)
        if span is None and node is not None:
            fwd = forward_of.get((node.fwd_tid, node.seq))
            if fwd is not None:
                span = _at(spans, fwd.tid, fwd.start)
        if node is not None:
            out.backward += dt
            if span is not None:
                out.backward_reached += dt
        if span is None:
            out.outside += dt
        else:
            out.by_span[span.name] = out.by_span.get(span.name, 0.0) + dt

    busy = Trace([(d.name, d.start, d.end) for d in device], [], 0.0,
                 []).merged()
    port = _by_thread(port_ranges(ranges)).values()
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        out.gap_total += s1 - e0
        if any(nest.at(e0) is not None for nest in port):
            out.gap_port += s1 - e0
    return out


def _kind(e) -> str:
    from torch.autograd import DeviceType

    if e.device_type() != DeviceType.CPU:
        return "device"
    name = e.name()
    if name.startswith("cu"):
        return "runtime"
    # trace.py's rule for a user range
    if e.is_user_annotation() or "::" not in name:
        return "range"
    return "op"


def from_kineto(events) -> List[Ev]:
    """The profiler's raw events (``prof.profiler.kineto_results.
    events()``) as :class:`Ev`; device-side range markers are dropped."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type() != DeviceType.CPU and e.is_user_annotation():
            continue
        out.append(Ev(e.name(), _kind(e), int(e.start_thread_id()),
                      e.start_ns() / 1e3, e.end_ns() / 1e3,
                      int(e.correlation_id()), int(e.linked_correlation_id()),
                      int(e.sequence_nr()), int(e.fwd_thread_id())))
    return out
