"""``BENCHMARK.json`` against its schema's shape rules, and the harness
driven by data: a throwaway traffic mix, loop kind, configuration,
limits file and per-layer metric run as new cells with no edit to any
file that is there."""

import json
import re
import shutil
import subprocess
import sys

from h100_bench.harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128


def test_names_units_and_entries():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == configs
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] \
                or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_finds_its_files():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2
        for m in cell.per_layer:
            assert hasattr(cell.metric_reader(m["name"]), "read")
        assert set(cell.limits["numbers"])


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A mix, a loop kind, a configuration, their limits and a metric
    added as files and entries, and run."""
    (tmp_path / "spconv_tpu_torch").symlink_to(ROOT / "spconv_tpu_torch")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = _bench()
    new = tmp_path / "h100_bench"
    # a loop kind of its own: serving that counts its calls
    (new / "loops" / "serve_counted.py").write_text(
        "import sys\n"
        "from h100_bench.loops.serve import *  # noqa: F401,F403\n"
        "from h100_bench.loops import serve\n\n\n"
        "class Loop(serve.Loop):\n"
        "    def end_to_end(self, win):\n"
        "        print('counted', win.count, file=sys.stderr)\n"
        "        return dict(super().end_to_end(win), calls=win.count)\n")
    (new / "traffic" / "serve-b3.json").write_text(json.dumps(dict(
        json.loads((new / "traffic" / "serve-b16.json").read_text()),
        loop="serve_counted", scans_per_request=3,
        why="a throwaway mix")))
    (new / "limits" / "cp-serve-b3.json").write_text(
        (new / "limits" / "cp-serve-b16.json").read_text())
    # read by requests_seen.py, the file of its name up to the first "."
    (new / "metrics" / "requests_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.window.count)\n")
    bench["workloads"].append({
        "name": "cp-serve-b3", "config": "centerpoint-voxelres-nus01",
        "traffic": "serve-b3", "chips": 1, "why": "throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cp-serve-b16" in m["workloads"]:
            m["workloads"].append("cp-serve-b3")
    bench["end_to_end"].append({
        "name": "calls", "unit": "calls", "better": "higher", "bound": 0.05,
        "source": "host_clock", "workloads": ["cp-serve-b3"]})
    bench["per_layer"].append({
        "name": "requests_seen.b3", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "net",
        "moves": "serve_scans_per_s", "workloads": ["cp-serve-b3"]})
    # a configuration: its file, its builder and its reference
    cp = "centerpoint-voxelres-nus01"
    for sub, ext in (("configs", ".json"), ("configs", ".py"),
                     ("reference", ".py")):
        shutil.copy(new / sub / f"{cp}{ext}", new / sub / f"cp-copy{ext}")
    bench["configs"].append(dict(
        next(c for c in bench["configs"] if c["name"] == cp),
        name="cp-copy", file="h100_bench/configs/cp-copy.json"))
    bench["workloads"].append({
        "name": "cpcopy-serve-b3", "config": "cp-copy",
        "traffic": "serve-b3", "chips": 1, "why": "throwaway"})
    (new / "limits" / "cpcopy-serve-b3.json").write_text(
        (new / "limits" / "cp-serve-b16.json").read_text())
    for m in bench["end_to_end"]:
        if "workloads" in m and "cp-serve-b3" in m["workloads"]:
            m["workloads"].append("cpcopy-serve-b3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in ("cp-serve-b3", "cpcopy-serve-b3"):
        done = subprocess.run(
            [sys.executable, "h100_bench/run.py", "--workload", cell,
             "--seed", "4294967311", "--seconds", "0.5", "--trace", "0",
             "--rehearse"], cwd=tmp_path, capture_output=True, text=True,
            timeout=600)
        assert done.returncode == 0, done.stderr[-3000:]
        result = json.loads(done.stdout.strip().splitlines()[-1])
        assert result["attempted"] >= 1
        assert "out_rel_l2" in result["checks"]
        assert f"counted {result['attempted']}" in done.stderr
