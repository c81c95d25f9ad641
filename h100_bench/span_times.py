"""The device time of each of the port's spans in one cell, and the split
of the device's idle time between the port's host work and the rest.

    python3 h100_bench/span_times.py --workload <name> --seeds s1,s2,... \\
        [--calls n] [--out spans-<name>.jsonl]

For each seed it sets the cell up and warms it up as a run does
(``harness/runner.py``), then runs ``--calls`` calls (the traffic's
``profiled_requests`` by default) three times, each call followed by a
device sync:

* ``plain``: without the profiler, on the host clock;
* ``full``: under the profiler with host and device activity, as the
  runner's second part: every device op attributed to a ``spconv.*``
  span (``harness/spans.py::attribute``), and the idle gaps split;
* ``ranges``: under the profiler with device activity and, of the host,
  only the ``record_function`` ranges and autograd's nodes.  The profiler
  then pays nothing for each host op, whose cost in ``full`` falls mostly
  inside the port's ranges; the idle gaps are split again.

It writes one JSON line a seed: each part's ms a call and device busy ms
a call; ``full``'s attribution (``Attribution.summary``: device ms a call
by span, the rest, the closure, backward's share that reaches a span);
each part's idle ms a call and the port's share of it; and
``front_idle_pct`` by each split, the idle share of a plain call
(1 - ``full``'s busy ÷ ``plain``'s ms) times the port's share of a
part's idle time.  The spans open only in the profiled parts.
``--rehearse`` runs on the CPU at the rehearsal sizes, where no device
op is kept.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _parts(cuda: bool):
    """``(full, ranges)``: makers of kineto profiler contexts with host
    activity, and device activity with ``cuda``; the second records of the
    host only the ranges and autograd's nodes."""
    import torch
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as ap

    class Ranges(ap.profile):
        def _start_trace(self):
            self.entered = True
            ap._run_on_profiler_start()
            torch.autograd._enable_profiler(
                self.config(), self.kineto_activities,
                {RecordScope.USER_SCOPE, RecordScope.BACKWARD_FUNCTION})
            self.profiling_start_time_ns = time.perf_counter_ns()

    # without use_kineto, "cuda" falls back to the legacy profiler, whose
    # results hold no device activity
    kw = dict(use_kineto=True, use_device="cuda" if cuda else None)
    return (lambda: ap.profile(**kw)), (lambda: Ranges(**kw))


def _timed(s, first, n, ctx=None):
    """Runs calls ``first`` .. ``first + n - 1``, each followed by a
    sync, inside ``ctx``; returns ms a call on the host clock."""
    import contextlib

    s.sync()
    with ctx or contextlib.nullcontext():
        t0 = time.perf_counter()
        for i in range(first, first + n):
            s.loop(i)
            s.sync()
        seconds = time.perf_counter() - t0
    return 1e3 * seconds / n


def one_seed(cell, seed: int, device, rehearse: bool, calls: int) -> dict:
    import torch

    from h100_bench.harness import runner, spans
    from h100_bench.harness.trace import Trace

    s = runner.build(cell, seed, device, rehearse)
    at = s.loop.warm_up()
    n = calls or int(s.traffic["profiled_requests"])
    cuda = device.type == "cuda"
    full, ranges = _parts(cuda)
    row = {"seed": seed, "calls": n, "ms": {}, "busy_ms": {}, "idle_ms": {},
           "port_idle_share": {}}
    row["ms"]["plain"] = _timed(s, at, n)
    at += n
    atts = {}
    for name, kind in (("full", full), ("ranges", ranges)):
        prof = kind()
        row["ms"][name] = _timed(s, at, n, prof)
        at += n
        events = spans.from_kineto(prof.kineto_results.events())
        device_ops = [(e.name, e.start, e.end) for e in events
                      if e.kind == "device"]
        if cuda and not device_ops:
            raise RuntimeError(f"the profiler kept no device op in the "
                               f"{name} part")
        att = atts[name] = spans.attribute(events, n)
        row["busy_ms"][name] = (1e3 * Trace(device_ops, [], 0.0, []).busy_s
                                / n)
        row["idle_ms"][name] = att.gap_total / n / 1e3
        row["port_idle_share"][name] = att.port_gap_share
        if name == "full":
            row["spans_opened"] = sorted(
                {e.name for e in events
                 if e.kind == "range" and e.name.startswith(spans.PREFIX)})
    row["attribution"] = atts["full"].summary()
    idle = 1.0 - row["busy_ms"]["full"] / row["ms"]["plain"]
    row["front_idle_pct"] = {k: 100.0 * idle * v
                             for k, v in row["port_idle_share"].items()}
    s.loop.release()
    s.free_program()
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--calls", type=int, default=0,
                   help="calls a part (default: profiled_requests)")
    p.add_argument("--out", default=None)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from h100_bench.run import environment

    environment()
    import torch

    from h100_bench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if args.rehearse:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
        print(runner.card_text(), file=sys.stderr, flush=True)
    out = open(args.out, "w") if args.out else None
    try:
        for seed in (int(v) for v in args.seeds.split(",")):
            line = json.dumps(dict(workload=args.workload, **one_seed(
                cell, seed, device, args.rehearse, args.calls)))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
