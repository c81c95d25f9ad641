"""One run of one cell: set-up, warm-up, the measured window, the traced
parts, the check against the plain reference, and the result line.

The cell's traffic names its loop kind (``"loop"``), a module
``loops/<kind>.py`` that holds the call the window times, its warm-up,
its end-to-end metrics and its check; this file is the same for every
kind.  A run, in order:

1. set-up (counted in ``setup_s``, from the process's start): the ring of
   batches (``inputs/ring.py``), the weights on the device from the seed
   (``harness/weights.py``), the program's net (``configs/<config>.py``,
   which calibrates its buffers on the ring), then the loop's warm-up;
2. the window: ``--seconds`` of closed-loop calls, with the peak of
   allocated device memory taken over it;
3. with ``--trace 1``, two profiled parts after the window
   (``harness/trace.py``): one with device activity alone, which gives
   the device's busy time and the kernels' times, then one with host
   activity too, which labels the idle gaps of the breakdown; the
   per-layer metrics read the window's clock and the first part;
4. the program's state freed, the loop's check: the plain reference
   (``reference/``) on the same inputs and weights, in float32 with TF32
   off, and the numbers of ``harness/check.py`` against
   ``limits/<workload>.json``.

No module of ``jax``, ``jaxlib``, ``flax`` or ``spconv_tpu`` may be
loaded: top-level names are compared whole, since ``spconv_tpu_torch``
begins with ``spconv_tpu``.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

import torch

from h100_bench.harness import spec, trace, weights
from h100_bench.harness.window import Window, run_window, sync
from h100_bench.inputs.ring import Batch, make_ring
from h100_bench.reference import sparse

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spconv_tpu"})


class RunError(RuntimeError):
    """A run that cannot give a result (exit code ``code``)."""

    def __init__(self, msg: str, code: int = 1):
        super().__init__(msg)
        self.code = code


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_text() -> str:
    """The card's name and ``nvidia-smi``'s power limit."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"not read ({e})"
    return (f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def effective(cell: spec.Cell, rehearse: bool):
    """The config and the traffic, with their rehearsal sizes when
    rehearsing on the CPU."""
    cfg, traffic = dict(cell.config), dict(cell.traffic)
    if rehearse:
        cfg.update(cfg["rehearsal"])
        traffic.update(traffic["rehearsal"])
    return cfg, traffic


def fresh_tensor(features: torch.Tensor, indices: torch.Tensor,
                 batch: Batch):
    """The program's input for one call: a new ``SparseConvTensor``."""
    from spconv_tpu_torch import SparseConvTensor

    return SparseConvTensor(features, indices, batch.shape,
                            batch.batch_size, keys_sorted=batch.keys_sorted)


@dataclass
class Setup:
    """Everything a loop kind works on: the cell, its inputs and weights,
    the program's net and forward, and the loop itself."""

    cell: spec.Cell
    kind: ModuleType
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    dtype: torch.dtype
    bn: bool
    ring: List[Batch]
    feats: List[torch.Tensor]   # served dtype, on the device
    inds: List[torch.Tensor]
    params: Dict[str, torch.Tensor]
    net: Optional[torch.nn.Module] = None
    forward: object = None
    loop: object = None
    phases: Dict[str, float] = field(default_factory=dict)

    @property
    def batch(self) -> int:
        return int(self.traffic["scans_per_request"])

    def make_x(self, slot: int, dtype: Optional[torch.dtype] = None):
        f = self.feats[slot]
        if dtype is not None and dtype != f.dtype:
            f = f.to(dtype)
        return fresh_tensor(f, self.inds[slot], self.ring[slot])

    def sync(self) -> None:
        sync(self.device)

    def free_program(self) -> None:
        """Drops the program's net and loop and returns their memory."""
        self.net = self.loop = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def ref_inputs(self, slot: int, half: bool = False):
        """The reference's input of ring slot ``slot``: the active sites
        and their features (the served dtype's values, in float32); with
        ``half``, only the first half of the batch's scans."""
        n = self.ring[slot].n_active
        coords = self.inds[slot][:n].long()
        feats = self.feats[slot][:n].float()
        if half:
            keep = coords[:, 0] < self.batch // 2
            coords, feats = coords[keep], feats[keep]
        return coords, feats

    def ref_plan(self, slot: int, half: bool = False) -> sparse.Plan:
        coords, _ = self.ref_inputs(slot, half)
        return self.cell.reference.plan(self.cfg, coords, self.batch)


def build(cell: spec.Cell, seed: int, device: torch.device,
          rehearse: bool = False) -> Setup:
    """Inputs, weights, the program's net and the loop (no call run)."""
    t = time.perf_counter()
    phases = {}

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    cfg, traffic = effective(cell, rehearse)
    kind = cell.loop
    dtype = getattr(torch, cfg["dtype"])
    bn = bool(cfg["train" if kind.TRAIN else "serve"]["bn"])
    ring = make_ring(
        grid=cfg["grid"], voxels_per_scan=cfg["voxels_per_scan"],
        in_channels=cfg["in_channels"], feature_fill=cfg["feature_fill"],
        ring=traffic["ring"], scan_seeds=traffic["scan_seeds"],
        scans_per_request=traffic["scans_per_request"],
        row_order=traffic["row_order"], seed=seed)
    feats = [torch.from_numpy(b.features).to(device).to(dtype) for b in ring]
    inds = [torch.from_numpy(b.indices).to(device) for b in ring]
    lap("ring")
    params = weights.draw(cell.reference.param_specs(cfg, bn), seed, device,
                          dtype)
    lap("weights")
    s = Setup(cell, kind, cfg, traffic, seed, device, dtype, bn, ring,
              feats, inds, params, phases=phases)
    s.net, s.forward = cell.program.build(
        cfg, train=kind.TRAIN, dtype=dtype,
        inputs=lambda dt: [s.make_x(r, dt) for r in range(len(ring))],
        load=lambda net: weights.load(net, params), device=device)
    s.loop = kind.Loop(s)
    lap("net")
    return s


def end_to_end_value(e2e: Dict[str, float], name: str) -> float:
    """The value of end-to-end metric ``name``: ``e2e[name]``, else the
    quantity named by ``name`` up to its first ``.`` (a suffix gives the
    same quantity a bound of its own, for cells that spread otherwise)."""
    return e2e[name] if name in e2e else e2e[name.split(".")[0]]


def _peak(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def run(workload: str, seed: int, seconds: float, traced: bool,
        rehearse: bool, t_start: float) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_imports = time.perf_counter() - t_start
    cell = spec.load_cell(workload)
    chips = int(cell.entry["chips"])
    if rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false", 2)
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell asks for {chips} cards, "
                           f"{torch.cuda.device_count()} present", 2)
        device = torch.device("cuda", 0)
        print(card_text(), file=sys.stderr, flush=True)

    s = build(cell, seed, device, rehearse)
    t = time.perf_counter()
    first = s.loop.warm_up()
    # set-up's objects leave the collector's young generations, so that
    # its passes in the window scan only what the window makes
    gc.collect()
    gc.freeze()
    s.phases["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    print("set-up (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in
        [("imports", t_imports), *s.phases.items()]),
        file=sys.stderr, flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    win = run_window(s.loop, first, len(s.ring), seconds, device,
                     s.loop.after)
    peak = _peak(device)
    bad = forbidden_modules()
    if bad:
        raise RunError(f"forbidden modules loaded: {bad}", 3)

    tr = labelled = None
    if traced and not rehearse:
        n = int(s.traffic["profiled_requests"])
        at = first + win.count
        tr = trace.profile_part(s.loop, at, n, len(s.ring), s.sync,
                                host=False)
        labelled = trace.profile_part(s.loop, at + n, n, len(s.ring),
                                      s.sync, host=True)

    # the program's state is freed before the reference runs
    loop = s.loop
    loop.release()
    s.free_program()
    judged, failed = loop.check(cell.limits)
    correct = all(j["ok"] for j in judged.values())

    e2e = {"setup_s": setup_s, "peak_mem_gib": peak / 2**30,
           **loop.end_to_end(win)}
    metrics = {}
    if not rehearse:
        if traced:
            ctx = ReadCtx(s, win, tr, [s.ref_plan(r).work
                                       for r in range(len(s.ring))])
            for m in cell.per_layer:
                v = cell.metric_reader(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": end_to_end_value(e2e,
                                                                m["name"]),
                                      "unit": m["unit"]}
    dev = ({"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
           if device.type == "cuda" else
           {"platform": "cpu", "kind": "rehearsal on the CPU", "count": 1,
            "memory_peak_bytes": 0})
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": correct, "attempted": win.count, "failed": failed,
              "metrics": metrics, "device": dev}
    if labelled is not None:
        result["breakdown"] = labelled.breakdown()
    result["checks"] = {k: {"value": j["value"], "limit": j["limit"]}
                        for k, j in judged.items()}
    bad = forbidden_modules()
    if bad:
        raise RunError(f"forbidden modules loaded: {bad}", 3)
    return result


@dataclass
class ReadCtx:
    """What a per-layer metric's reader reads: the setup (dtype, loop
    kind), the window (clock), the first profiled part (device trace) and
    each ring slot's conv work, counted by the reference's rulebook."""

    setup: Setup
    window: Window
    trace: Optional[trace.Trace]
    work: List[List[sparse.LayerWork]]

    @property
    def dtype(self) -> str:
        return self.setup.cfg["dtype"]

    @property
    def passes(self):
        """The conv products each call runs (the loop kind's)."""
        return self.setup.kind.PASSES


def print_result(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
