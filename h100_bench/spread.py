"""Repeated runs of one cell, and the spread of each end-to-end metric,
from which ``BENCHMARK.json``'s bounds are set.

    python3 h100_bench/spread.py --workload <name> --seeds s1,...,s6 \\
        --seconds <run_seconds> [--sets 2] [--first 1] \\
        [--trace-seeds t1,t2,t3] [--out spread-<name>.jsonl]

``--first`` runs that many runs before the sets (the checkout's first
run builds the kernels; their ``setup_s`` is kept apart).  Each set runs
every seed once, with ``--trace 0``, one process after another; then each
``--trace-seeds`` seed runs once with ``--trace 1``.  Every run's result
line goes to ``--out``; the last line sums up each metric by set: its
median, its quartiles (``statistics.quantiles(values, n=4)``), the spread
(the distance between the quartiles over the median), the spread with
each set's run farthest from its median left out, and five times the
widest spread, the bound that spread supports (at least 1 %).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_run(workload, seed, seconds, trace) -> dict:
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    row = {"seed": seed, "trace": trace, "rc": done.returncode,
           "wall_s": time.perf_counter() - t0}
    lines = done.stdout.strip().splitlines()
    if done.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    else:
        row["stderr"] = done.stderr[-4000:]
    return row


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def summarize(sets) -> dict:
    out = {}
    names = sorted({k for rows in sets for r in rows if "result" in r
                    for k in r["result"]["metrics"]})
    for name in names:
        per_set = []
        for rows in sets:
            v = [r["result"]["metrics"][name]["value"] for r in rows
                 if "result" in r and name in r["result"]["metrics"]]
            if not v:
                continue
            med = statistics.median(v)
            trimmed = sorted(v, key=lambda x: abs(x - med))[:-1]
            per_set.append({"values": v, "median": med,
                            "quartiles": (statistics.quantiles(v, n=4)
                                          if len(v) > 1 else None),
                            "spread": spread(v),
                            "spread_trimmed": spread(trimmed)})
        widest = max((s["spread"] or 0.0) for s in per_set)
        all_v = [x for s in per_set for x in s["values"]]
        out[name] = {"sets": per_set, "widest_spread": widest,
                     "spread_all": spread(all_v),
                     "bound_5x": max(0.01, 5 * widest)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line[:3000], flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        for i in range(args.first):
            emit(dict(one_run(args.workload, 1000003 + i, args.seconds, 0),
                      kind="first"))
        sets = []
        for k in range(args.sets):
            rows = []
            for seed in seeds:
                row = one_run(args.workload, seed, args.seconds, 0)
                emit(dict(row, kind=f"set{k + 1}"))
                rows.append(row)
            sets.append(rows)
        for seed in [int(s) for s in args.trace_seeds.split(",") if s]:
            emit(dict(one_run(args.workload, seed, args.seconds, 1),
                      kind="traced"))
        correct = [r["result"]["correct"] for rows in sets for r in rows
                   if "result" in r]
        emit({"summary": summarize(sets), "runs": len(correct),
              "correct": sum(correct)})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
