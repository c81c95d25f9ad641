"""The benchmark of spconv_tpu_torch on an NVIDIA H100: one run of one cell.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for.  The last line of standard output is the result (JSON: correct,
attempted, failed, metrics, device, with ``--trace 1`` breakdown, and the
numbers compared, each beside its limit, under ``checks``); the last
lines of standard error repeat the checks.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones.  Without a
card, or with fewer than the cell asks for, it exits with 2 and prints no
result.  ``--rehearse`` runs the same steps on the CPU at the config's
and the traffic's rehearsal sizes and reports no metric: it tests the
harness, never the card.

The port builds its kernels at first use into ``spconv_tpu_torch/_build/``
inside the checkout, so only a checkout's first run compiles; the
benchmark points every other cache the program could use at fixed
directories inside ``h100_bench/.cache/`` and turns off what would make
runs differ (the tuner, its cache, the port's debug checks).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def environment() -> None:
    """Set before the port is imported: it reads these at import."""
    for k in ("SPCONV_TPU_ALGO", "SPCONV_TPU_TUNE",
              "SPCONV_TPU_CHECK_OVERFLOW", "SPCONV_TPU_DEBUG_SAVE_PATH"):
        os.environ.pop(k, None)
    cache = BENCH_DIR / ".cache"
    # never written: tuning is off, so no winner is ever cached here
    os.environ["SPCONV_TPU_TUNE_CACHE"] = str(cache / "tuner")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at the rehearsal sizes")
    args = p.parse_args(argv)

    environment()
    sys.path.insert(0, str(ROOT))
    from h100_bench.harness import runner

    try:
        result = runner.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), args.rehearse, T_START)
    except runner.RunError as e:
        print(f"run.py: {e}", file=sys.stderr, flush=True)
        return e.code
    runner.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
