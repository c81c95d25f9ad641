"""Finds everything a cell needs by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run (the file
  that ``BENCHMARK.json`` names), with ``configs/<config>.py`` beside it,
  which builds the program's net, and ``reference/<config>.py``, its
  plain reference;
* ``traffic/<traffic>.json``: the traffic mix, read by the one generator
  (``inputs/ring.py``); its ``"loop"`` names the loop kind, the module
  ``loops/<loop>.py`` (the call the window times, its warm-up, its
  end-to-end metrics and its check);
* ``limits/<workload>.json``: the limit of each number the correctness
  check compares, with the readings it was set from;
* ``metrics/<metric>.py``: the reader of each per-layer metric; a
  metric whose name has no file of its own is read by the file of its
  name up to the first ``.`` (``mfu.serve`` and ``mfu.train`` by
  ``mfu.py``), which finds what differs in the cell's loop kind.

An end-to-end metric is a quantity that the loop kind or the runner
measures (``train_scans_per_s``); a name with a suffix after a ``.``
(``train_scans_per_s.benchnet``) is the same quantity under a bound of
its own.  A new cell, configuration, mix, loop kind or metric is new
files and new entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path) -> ModuleType:
    """Imports the file ``path`` (its name may hold ``-`` and ``.``)."""
    name = "h100_bench_" + "".join(
        ch if ch.isalnum() else "_"
        for ch in str(path.relative_to(BENCH_DIR)))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` and everything it names."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    loop: ModuleType
    program: ModuleType
    reference: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(reader_path(name))


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<name up to its first ".">.py``."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.exists() else (
        BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py")


def loop_module(kind: str) -> ModuleType:
    """The loop kind ``kind``: the module ``h100_bench.loops.<kind>``."""
    if not kind.isidentifier():
        raise ValueError(f"a loop kind is a module name, not {kind!r}")
    return importlib.import_module(f"h100_bench.loops.{kind}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    """The cell ``workload``; ``KeyError`` if ``BENCHMARK.json`` has no
    such workload."""
    bench = _json(bench_file)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in {bench_file.name}: "
                       f"{sorted(entries)}")
    entry = entries[workload]
    configs: Dict[str, dict] = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = _json(ROOT / cfg_entry["file"])
    name = entry["config"]
    traffic = _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=workload, entry=entry, config=config, traffic=traffic,
        limits=_json(BENCH_DIR / "limits" / f"{workload}.json"),
        loop=loop_module(traffic["loop"]),
        program=load_module(BENCH_DIR / "configs" / f"{name}.py"),
        reference=load_module(BENCH_DIR / "reference" / f"{name}.py"),
        end_to_end=[m for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )
