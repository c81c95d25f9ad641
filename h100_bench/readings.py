"""The readings that a cell's correctness limits are set from, at the
cell's own size, many seeds in one process.

    python3 h100_bench/readings.py --workload <name> --seeds 1,2,...,12 \\
        [--faults 3] [--out readings-<name>.jsonl]

For each seed it sets the cell up as a run does (``harness/runner.py``)
and writes one JSON line of the numbers of ``harness/check.py``, as the
cell's loop kind reads them (``loops/<kind>.py::readings``):

* ``sound``: the program against the float32 reference, as a run compares
  them (serving: one answer of every ring slot; training: the first
  ``compared_steps`` steps);
* for the first ``--faults`` seeds also ``control``: the reference
  computed in float8 (``reference/sparse.py``'s ``quant="fp8"``, the
  precision below the served bfloat16) in the program's place, and the
  faults a cell of its loop can have: serving, ``answer_swapped`` (one
  scan's answer replaced by another scan's where it is produced);
  training, ``half_batch`` (the reference's step leaving out half of the
  batch and taking twice the loss of the rest) and ``state_unchanged``
  (the program's state left as it was, which needs no run);
* with training, each leaf's reference gradient and weight norms, from
  which the learning rate of the config was chosen.

A last line sums up: the largest ``sound`` reading of each number and the
smallest reading of the control and of each fault.  ``--rehearse`` runs on
the CPU at the rehearsal sizes.  Nothing here is timed.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_seed(cell, seed: int, device, rehearse: bool, faults: bool) -> dict:
    from h100_bench.harness import runner

    s = runner.build(cell, seed, device, rehearse)
    return dict(seed=seed, **cell.loop.readings(s, faults))


def summary(rows) -> dict:
    out = {}
    kinds = dict.fromkeys(k for r in rows for k in r
                          if k not in ("seed", "losses", "leaves"))
    for kind in kinds:
        got = [r[kind] for r in rows if kind in r]
        pick = max if kind == "sound" else min
        out[kind] = {k: pick(g[k] for g in got) for k in got[0]}
        out[kind]["seeds"] = len(got)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--faults", type=int, default=3,
                   help="seeds (the first ones) that also read the control "
                        "and the faults")
    p.add_argument("--lr", type=float, default=None,
                   help="the training learning rate, in place of the "
                        "config's (for choosing it)")
    p.add_argument("--out", default=None)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from h100_bench.run import environment

    environment()
    import torch

    from h100_bench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if args.lr is not None:
        for cfg in (cell.config, cell.config.get("rehearsal", {})):
            if "train" in cfg:
                cfg["train"] = dict(cfg["train"], lr=args.lr)
    if args.rehearse:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
        print(runner.card_text(), file=sys.stderr, flush=True)
    rows = []
    out = open(args.out, "w") if args.out else None
    try:
        for n, seed in enumerate(int(v) for v in args.seeds.split(",")):
            row = one_seed(cell, seed, device, args.rehearse,
                           n < args.faults)
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        line = json.dumps({"summary": summary(rows)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
