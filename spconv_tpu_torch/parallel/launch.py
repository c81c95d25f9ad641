"""Starting ranks on one host: :func:`run_ranks`, for the examples, the
tests and the smoke run.  Each rank is a process started with
``torch.multiprocessing``'s ``spawn`` method that joins one process group
through a ``file://`` rendezvous in a fresh directory (no port to pick, so
concurrent runs never meet), runs the caller's function and hands its
result back through a file; a rank that raises leaves its traceback in a
file beside it, which the caller's error carries."""

from __future__ import annotations

import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]

# characters of a failed rank's traceback that its error carries: the end,
# where the raising frame and the message are
_TRACEBACK_CHARS = 4000


def _rank_main(rank: int, world_size: int, fn: Callable, args: Sequence,
               backend: str, workdir: str, timeout: float) -> None:
    init = Path(workdir) / "rendezvous"
    try:
        dist.init_process_group(backend, init_method=f"file://{init}",
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            result = fn(rank, world_size, *args)
            torch.save(result, Path(workdir) / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        # the parent reads it into its error; the exit code stays non-zero
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _failures(workdir: str, codes: Sequence[Optional[int]]) -> str:
    """The end of each failed rank's traceback (``rank{r}.err``), one
    block a rank; ranks that left none (terminated, or killed) add
    nothing."""
    text = ""
    for r, code in enumerate(codes):
        err = Path(workdir) / f"rank{r}.err"
        if code != 0 and err.is_file():
            text += (f"\n--- rank {r} (exit code {code}) raised:\n"
                     + err.read_text()[-_TRACEBACK_CHARS:])
    return text


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
              backend: str, timeout: float = 300.0,
              workdir: Optional[str] = None) -> List[Any]:
    """Runs ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one ``backend`` process group, and returns their
    results in rank order (saved with ``torch.save``, loaded onto the
    CPU).  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  ``workdir`` (default: a new temporary directory) holds the
    rendezvous file and the results.

    A rank that raises or exits non-zero, or a run past ``timeout``
    seconds, terminates every rank still running and raises
    ``RuntimeError`` with the exit codes and, for each rank that raised,
    the last ``_TRACEBACK_CHARS`` characters of its traceback: no process
    is left behind."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, fn, tuple(args), backend,
                                   tmp, timeout), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                for p in procs:
                    p.join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            late = time.monotonic() >= deadline
            raise RuntimeError(
                f"ranks of {getattr(fn, '__name__', fn)} exited with codes "
                f"{codes}" + (f" (past the {timeout} s timeout)" if late
                              else "") + _failures(tmp, codes))
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu",
                           weights_only=True) for r in range(world_size)]
