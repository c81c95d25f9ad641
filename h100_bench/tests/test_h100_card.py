"""Each cell end to end on the card: a short traced run whose result line
has the result's keys, is correct and reports every per-layer metric of
the cell.  Needs a CUDA card; skips without one (decided in a fixture).

    python -m pytest h100_bench/tests/test_h100_card.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from h100_bench.harness import spec

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_traced(card, workload):
    done = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", workload,
         "--seed", "3735928559", "--seconds", "2", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    cell = spec.load_cell(workload)
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    for m in result["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100
