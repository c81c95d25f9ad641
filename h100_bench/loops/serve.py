"""Serving: one client, closed loop.  Each request builds a fresh
``SparseConvTensor`` from the next batch of the ring (so no rulebook is
carried over), runs the program's forward under ``torch.no_grad()`` and
ends in a device sync.

Set-up serves every batch of the ring once, and one more.  The window
keeps a sample of its answers drawn from the seed (:class:`Reservoir`);
once the program's state is freed, the reference answers the same
batches and each kept answer is compared, scan by scan
(``harness/check.py::serve_numbers``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench.harness import check
from h100_bench.harness.window import Range, Window
from h100_bench.reference import sparse

TRAIN = False           # the net in eval mode, the config's "serve" part
PASSES = ("forward",)   # the conv products a call runs


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed as they come (Algorithm R), copied into buffers made before the
    window."""

    def __init__(self, k: int, seed: int, like: torch.Tensor):
        self.rng = np.random.default_rng([int(seed) % 2**63, 7])
        self.bufs = [torch.empty_like(like) for _ in range(k)]
        self.which: List[Optional[int]] = [None] * k
        self.seen = 0

    def offer(self, i: int, out: torch.Tensor) -> None:
        """Answer ``out`` of request ``i``, the window's ``seen``-th."""
        k, t = len(self.bufs), self.seen
        self.seen += 1
        j = t if t < k else int(self.rng.integers(0, t + 1))
        if j < k:
            self.bufs[j].copy_(out)
            self.which[j] = i

    def kept(self):
        """``[(request, answer)]`` of the answers kept."""
        return [(i, b) for i, b in zip(self.which, self.bufs)
                if i is not None]


class Loop:
    """Request ``i`` serves ring slot ``i % ring``; returns the output."""

    def __init__(self, s):
        self.s = s
        self.reservoir: Optional[Reservoir] = None
        self.kept: list = []

    def __call__(self, i: int):
        s = self.s
        x = s.make_x(i % len(s.ring))
        with torch.no_grad(), Range("bench.forward"):
            return s.forward(s.net, x)

    def warm_up(self) -> int:
        """Serves every slot once, and one more; returns the index of the
        window's first request."""
        n = len(self.s.ring) + 1
        for i in range(n):
            out = self(i)
            self.s.sync()
        self.reservoir = Reservoir(int(self.s.traffic["kept_answers"]),
                                   self.s.seed, out)
        return n

    def after(self, i: int, out: torch.Tensor) -> None:
        self.reservoir.offer(i, out)

    def release(self) -> None:
        self.kept = self.reservoir.kept()
        self.reservoir = None

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"serve_scans_per_s": win.count * self.s.batch / win.seconds,
                "serve_p95_ms": float(np.percentile(win.latency_s, 95))
                * 1e3}

    def check(self, limits: dict):
        """``(judged, failed)``: the numbers against their limits, and the
        kept answers that fail."""
        answers = serve_answers(self.s, self.kept)
        judged = check.judge(check.serve_numbers(answers), limits)
        lim = limits["numbers"]["out_rel_l2"]["limit"]
        failed = 0
        for a in answers:
            v = check.serve_numbers([a])["out_rel_l2"]
            failed += not (np.isfinite(v) and v <= lim)
        return judged, failed


def ref_serve(s, slot: int, quant: Optional[str] = None) -> torch.Tensor:
    """The reference's answer to ring slot ``slot``."""
    params = {k: v.float() for k, v in s.params.items()}
    with torch.no_grad(), sparse.highest():
        _, f = s.ref_inputs(slot)
        return s.cell.reference.forward(s.cfg, s.ref_plan(slot), params, f,
                                        s.bn, quant)


def serve_answers(s, kept, quant: Optional[str] = None):
    """``[(program answer, reference answer)]`` of the kept answers
    (``[(request, answer)]``)."""
    refs: Dict[int, torch.Tensor] = {}
    out = []
    for i, got in kept:
        slot = i % len(s.ring)
        if slot not in refs:
            refs[slot] = ref_serve(s, slot, quant)
        out.append((got, refs[slot]))
    return out


def readings(s, faults: bool) -> dict:
    """The readings of one seed (``readings.py``): the program's answer to
    every slot against the reference's; with ``faults``, the float8
    control in the program's place, and one scan's answer swapped for
    another's where it is produced."""
    kept = []
    for i in range(len(s.ring)):
        kept.append((i, s.loop(i).clone()))
        s.sync()
    s.free_program()
    answers = serve_answers(s, kept)
    row = {"sound": check.serve_numbers(answers)}
    if faults:
        row["control"] = check.serve_numbers(
            [(c, r) for (_, c), (_, r) in zip(
                serve_answers(s, kept, quant="fp8"), answers)])
        swapped = []
        for got, ref in answers:
            bad = got.clone()
            bad[0] = got[1]
            swapped.append((bad, ref))
        row["answer_swapped"] = check.serve_numbers(swapped)
    return row
