"""The yardstick's arithmetic on hand-worked cases, the metric readers on
a made-up trace, and the check that no JAX module is loaded."""

import json
import subprocess
import sys

import pytest

import numpy as np

from h100_bench.harness import runner, spec, trace
from h100_bench.harness import work as W
from h100_bench.harness.window import Window
from h100_bench.inputs import ring as R
from h100_bench.reference.sparse import LayerWork

ROOT = spec.ROOT


def _layer(**kw):
    base = dict(name="l", c=64, k=128, kv=27, pairs=1000, n_in=100,
                n_out=50, first=False)
    base.update(kw)
    return LayerWork(**base)


def test_ops_and_bytes_by_hand():
    w = _layer()
    assert W.conv_ops(w) == 2 * 64 * 128 * 1000
    # inputs 100 x 64, weight 27 x 64 x 128, outputs 50 x 128, 2 bytes each
    assert W.conv_bytes(w, "bfloat16") == 2 * (6400 + 221184 + 6400)
    # 16.384 MFLOP at 989 T/s = 16.6 ns; 468 kB at 3.35 TB/s = 139.7 ns
    assert W.bound_s(W.conv_ops(w), W.conv_bytes(w, "bfloat16"),
                     "bfloat16") == pytest.approx(467968 / 3.35e12)
    big = _layer(pairs=10**9)
    assert W.bound_s_of([big], ["forward"], "bfloat16") == pytest.approx(
        2 * 64 * 128 * 1e9 / 989e12)


def test_first_layer_has_no_dgrad():
    a, b = _layer(first=True), _layer()
    assert W.bound_s_of([a, b], ["dgrad"], "bfloat16") == W.bound_s_of(
        [b], ["dgrad"], "bfloat16")
    assert W.pass_ops([a, b], W.PASSES) == 5 * W.conv_ops(a)
    assert W.pass_ops([a, b], ["forward"]) == 2 * W.conv_ops(a)
    with pytest.raises(ValueError):
        W.pass_ops([a], ["backward"])


class _Kind:
    def __init__(self, passes):
        self.PASSES = passes


class _Setup:
    def __init__(self, passes):
        self.kind = _Kind(passes)
        self.cfg = {"dtype": "bfloat16"}


def _ctx(train, device_ops):
    passes = W.PASSES if train else ("forward",)
    win = Window(latency_s=[0.02, 0.03], enqueue_s=[0.01, 0.02],
                 slots=[0, 1], seconds=0.05)
    tr = trace.Trace(device_ops, [("SubMConv3d", 0.0, 50.0, True),
                                  ("aten::mm", 10.0, 30.0, False)],
                     window_s=100e-6, slots=[0])
    work = [[_layer(first=True), _layer()], [_layer(pairs=3000)]]
    return runner.ReadCtx(_Setup(passes), win, tr, work)


def _read(name, ctx):
    return spec.load_module(spec.reader_path(name)).read(ctx)


def test_readers_on_a_made_up_trace():
    ops = [("void dg_fwd_bf16_kernel<T>(...)", 0.0, 20.0),
           ("void dg_wgrad_bf16_kernel<T>(...)", 20.0, 30.0),
           ("void dg_wgrad_reduce_kernel<float>(...)", 40.0, 45.0),
           ("void at::native::elementwise_kernel<...>", 60.0, 70.0)]
    serve, train = _ctx(False, ops), _ctx(True, ops)
    work0 = serve.work[0]
    fwd = W.bound_s_of(work0, ["forward"], "bfloat16")
    assert _read("b2_roofline.serve", serve) == pytest.approx(
        100 * fwd / 20e-6)
    assert _read("b2_roofline.train", train) == pytest.approx(
        100 * (fwd + W.bound_s_of(work0, ["dgrad"], "bfloat16")) / 20e-6)
    assert _read("wgrad_roofline", train) == pytest.approx(
        100 * W.bound_s_of(work0, ["wgrad"], "bfloat16") / 15e-6)
    # busy 20 + 10 + 5 + 10 us in the part's one call, against 25 ms a
    # call in the window (0.05 s over 2 calls)
    assert _read("device_idle_pct.serve", serve) == pytest.approx(
        100 * (1 - 45e-6 / 0.025))
    ops_all = sum(W.pass_ops(w, ["forward"]) for w in serve.work)
    assert _read("mfu.serve", serve) == pytest.approx(
        100 * ops_all / (0.05 * 989e12))
    ops_train = sum(W.pass_ops(w, W.PASSES) for w in train.work)
    assert _read("mfu.train", train) == pytest.approx(
        100 * ops_train / (0.05 * 989e12))
    assert _read("host_enqueue_ms.serve", serve) == pytest.approx(15.0)
    # a part with no B2 record: the reader has nothing to read
    assert _read("b2_roofline.serve", _ctx(False, ops[3:])) is None
    assert spec.reader_path("mfu.serve").name == "mfu.py"
    assert spec.reader_path("wgrad_roofline").name == "wgrad_roofline.py"
    gaps = serve.trace.breakdown()["idle_gaps"]
    assert gaps[0][0] == "SubMConv3d | -"
    assert sum(s for _, s in gaps) == pytest.approx(25e-6)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spconv_tpu_torch_fake", object())
    assert "spconv_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spconv_tpu.fake", object())
    assert runner.forbidden_modules() == ["spconv_tpu"]


def test_a_rehearsal_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.argv = ['run.py', '--workload', 'cp-serve-b16', '--seed', "
        f"'12', '--seconds', '0.5', '--trace', '1', '--rehearse']\n"
        f"sys.path.insert(0, {str(ROOT / 'h100_bench')!r})\n"
        "import run\n"
        "rc = run.main(sys.argv[1:])\n"
        "names = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'names': names}))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert not set(got["names"]) & runner.FORBIDDEN
    assert "spconv_tpu_torch" in got["names"]


def test_ring_repeats_no_scan(monkeypatch, tmp_path):
    """Three slots of 16 scans from 6 base scans: every (base scan,
    transform) once; every seed the same scans, in another order."""
    monkeypatch.setattr(R, "CACHE", tmp_path)
    made = []

    def fake_base(seed, shape, n):
        made.append(seed)
        coors = np.zeros((2, 4), np.int32)
        coors[:, 1] = seed
        coors[1, 2] = 1
        return np.zeros((2, 3), np.float32), coors

    monkeypatch.setattr(R, "base_scan", fake_base)
    kw = dict(grid=[4, 8, 8], voxels_per_scan=2, in_channels=3,
              feature_fill=[], ring=3, scan_seeds=list(range(6)),
              scans_per_request=16, row_order="key_sorted")
    seen = set()
    for slot in R.make_ring(seed=1, **kw):
        inds = slot.indices[:slot.n_active]
        scans = {tuple(map(tuple, inds[inds[:, 0] == b, 1:]))
                 for b in range(16)}
        assert len(scans) == 16
        assert not scans & seen
        seen |= scans
    other = R.make_ring(seed=2, **kw)
    assert sum(s.n_active for s in other) == 3 * 16 * 2
    with pytest.raises(ValueError):
        R.make_ring(seed=1, **dict(kw, scan_seeds=[0, 1]))


def test_base_scans_are_cached(monkeypatch, tmp_path):
    monkeypatch.setattr(R, "CACHE", tmp_path)
    R.base_scan.cache_clear()
    v, c = R.base_scan(3, (8, 32, 32), 50)
    assert len(list(tmp_path.glob("scan-3-8x32x32-50.npz"))) == 1
    R.base_scan.cache_clear()
    monkeypatch.setattr(R, "synthetic_scan", None)  # read, never made
    v2, c2 = R.base_scan(3, (8, 32, 32), 50)
    assert np.array_equal(v, v2) and np.array_equal(c, c2)
    R.base_scan.cache_clear()


def test_a_suffixed_end_to_end_name_reads_its_quantity():
    e2e = {"train_scans_per_s": 75.0, "setup_s": 12.0}
    assert runner.end_to_end_value(e2e, "train_scans_per_s.benchnet") == 75.0
    assert runner.end_to_end_value(e2e, "setup_s") == 12.0
