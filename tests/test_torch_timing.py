"""The port's timers and per-layer benchmark records against the JAX
package on the CPU: ``tools.KernelTimer``'s nested keys, ``tools.
benchmark_model``, the ``benchmark=True`` records of the nets of
``tests/test_modules.py::test_benchmark_record_per_layer`` and
``tests/test_spatial_bench.py::test_benchmark_records_per_layer_time``,
and the ``record_function`` ranges a profiler sees.  The timers' CUDA
events are held on the card in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.tools import KernelTimer as JaxKernelTimer

import spconv_tpu_torch as st
from spconv_tpu_torch import tools
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import dg_conv as TD

from utils import generate_sparse_data, pad_sparse

# the record fields that do not depend on timing, compared with JAX's
FIELDS = ("layer", "type", "num_voxels_in", "num_voxels_out", "num_pairs",
          "in_channels", "out_channels", "kernel_size", "stride", "algo",
          "indice_key")


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    TD.reset_launch_counts()
    yield
    assert not any(TD.launch_counts.values())


def _spans(timer):
    with timer.namespace("a"):
        with timer.namespace("b"):
            with timer.record("c"):
                pass
        with timer.namespace("b"):
            pass
    with timer.record("d"):
        pass
    return timer.get_all_pair_time()


def test_kernel_timer_keys_match_jax():
    """The same nesting gives JAX's keys (``"a.b.c"``), each a float >= 0,
    an outer span no shorter than an inner one; ``enable=False`` records
    nothing; ``CUDAKernelTimer`` is the same class; with no device given
    and no card it raises."""
    got = _spans(tools.KernelTimer(device="cpu"))
    want = _spans(JaxKernelTimer())
    assert sorted(got) == sorted(want) == ["a", "a.b", "a.b.c", "d"]
    assert all(isinstance(v, float) and v >= 0 for v in got.values())
    assert got["a"] >= got["a.b"] >= got["a.b.c"]
    assert _spans(tools.KernelTimer(enable=False, device="cpu")) == {}
    assert tools.CUDAKernelTimer is tools.KernelTimer
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tools.KernelTimer()


def test_benchmark_model_returns_ms():
    """``benchmark_model`` returns a float ms >= 0 on the host clock for CPU
    tensors, calling ``fn`` once to warm up and ``rep`` times a round, with
    ``perturb`` making each call's arguments."""
    x = torch.randn(64, 64)
    calls = []

    def fn(a):
        calls.append(float(a[0, 0]))
        return a @ a

    ms = tools.benchmark_model(fn, (x,), rep=3, n_outer=2)
    assert isinstance(ms, float) and ms >= 0
    assert len(calls) == 1 + 3 * 2
    calls.clear()
    ms = tools.benchmark_model(fn, (x,), rep=2, n_outer=1,
                               perturb=lambda i, a: (a[0] * (i + 1),))
    assert ms >= 0
    assert calls == [float(x[0, 0] * k) for k in (1, 1, 2)]


def _modules_input(rng, shape=(9, 10, 11), n=120, c=4, batch=2, nbuf=280):
    """``tests/test_modules.py``'s ``make_input`` as numpy arrays."""
    feats, inds = generate_sparse_data(shape, n, c, batch_size=batch,
                                       rng=rng)
    return pad_sparse(feats, inds, nbuf)


def _records_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        for f in FIELDS:
            g, w = got[name].get(f), want[name].get(f)
            assert (tuple(g) if isinstance(g, tuple) else g) == (
                tuple(w) if isinstance(w, tuple) else w), (name, f, g, w)


def test_benchmark_records_match_jax_net(rng):
    """``tests/test_modules.py:209``'s net (SubM -> ReLU -> strided conv ->
    max pool with a bound) on its input: one record a conv and pool, with
    JAX's names, types, channels, geometry, voxel counts and (native path
    on both sides) pair counts, and a measured ``time_ms``; the ReLU keeps
    the records and ``benchmark`` along."""
    fp, ip = _modules_input(rng)
    shape = (9, 10, 11)
    jnet = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 8, 3, indice_key="c1"),
        spconv_tpu.SparseReLU(),
        spconv_tpu.SparseConv3d(8, 16, 3, stride=2, padding=1,
                                indice_key="d1"),
        spconv_tpu.SparseMaxPool3d(2, out_bound=64),
    )
    tnet = st.SparseSequential(
        st.SubMConv3d(4, 8, 3, indice_key="c1", device="cpu"),
        st.SparseReLU(),
        st.SparseConv3d(8, 16, 3, stride=2, padding=1, indice_key="d1",
                        device="cpu"),
        st.SparseMaxPool3d(2, out_bound=64),
    )
    load_jax_state_dict(tnet, state_dict(jnet))
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(fp), jnp.asarray(ip),
                                     shape, 2)
    jx.benchmark = True
    tx = st.SparseConvTensor(torch.from_numpy(fp), torch.from_numpy(ip),
                             shape, 2, benchmark=True)
    with torch.no_grad():
        out = tnet(tx)
    want = jnet(jx).benchmark_record
    got = out.benchmark_record
    _records_equal(got, want)
    assert [r["type"] for r in got.values()] == [
        "SubMConv3d", "SparseConv3d", "SparseMaxPool3d"]
    assert got["SubMConv3d"]["num_pairs"] > 0
    assert all(isinstance(r["time_ms"], float) and r["time_ms"] > 0
               for r in got.values())
    assert out.benchmark and tx.benchmark_record == {}
    np.testing.assert_allclose(
        out.features.numpy(), np.asarray(jnet(jx).features), atol=1e-5)


def test_benchmark_records_spatial_net():
    """``tests/test_spatial_bench.py:46``'s named net (a native subm conv
    and a pool) on a key-sorted scan: records under the layers' names
    with the input's voxel count, JAX's fields and a time > 0; the
    records ride through ``sort_by_key`` and ``replace_feature``; a
    layer that runs twice adds a ``name#1`` record."""
    rng = np.random.RandomState(0)
    shape = (16, 16, 16)
    n = 64
    flat = rng.choice(np.prod(shape), n, replace=False)
    coords = np.stack(np.unravel_index(flat, shape), -1)
    inds = np.concatenate([np.zeros((n, 1), np.int32),
                           coords.astype(np.int32)], 1)
    feats = rng.randn(n, 8).astype(np.float32)
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, 1, benchmark=True).sort_by_key()
    jnet = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(8, 8, 3, indice_key="b0", algo="native",
                              name="conv_a", key=jax.random.PRNGKey(0)),
        spconv_tpu.SparseMaxPool3d(2, 2, name="pool_a"),
    )
    tnet = st.SparseSequential(
        st.SubMConv3d(8, 8, 3, indice_key="b0", algo="native", name="conv_a",
                      device="cpu"),
        st.SparseMaxPool3d(2, 2, name="pool_a"),
    )
    load_jax_state_dict(tnet, state_dict(jnet))
    tx = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                             shape, 1, benchmark=True).sort_by_key()
    assert tx.benchmark
    with torch.no_grad():
        out = tnet(tx.replace_feature(tx.features))
        twice = tnet[0](tnet[0](tx))
    want = jnet(jx).benchmark_record
    _records_equal(out.benchmark_record, want)
    rec = out.benchmark_record
    assert rec["conv_a"]["num_voxels_in"] == n
    assert rec["conv_a"]["time_ms"] > 0 and rec["pool_a"]["time_ms"] > 0
    assert list(twice.benchmark_record) == ["conv_a", "conv_a#1"]


def test_no_benchmark_no_records():
    """Without ``benchmark`` a net adds no record and leaves the flag
    off."""
    rng = np.random.RandomState(1)
    fp, ip = _modules_input(rng)
    net = st.SparseSequential(
        st.SubMConv3d(4, 8, 3, indice_key="c1", device="cpu"),
        st.SparseMaxPool3d(2, 2))
    with torch.no_grad():
        out = net(st.SparseConvTensor(torch.from_numpy(fp),
                                      torch.from_numpy(ip), (9, 10, 11), 2))
    assert not out.benchmark and out.benchmark_record == {}


def test_profiler_ranges_per_layer():
    """Inside a profiler window each conv and pool runs in a
    ``record_function`` range under its name (the JAX package's
    ``jax.named_scope``), its ``spconv.*`` phase spans inside it in order
    (``spconv_tpu_torch.tracing``); outside one no range opens."""
    rng = np.random.RandomState(2)
    fp, ip = _modules_input(rng)
    net = st.SparseSequential(
        st.SubMConv3d(4, 8, 3, indice_key="c1", name="sub_a", device="cpu"),
        st.SparseConv3d(8, 8, 3, stride=2, padding=1, device="cpu"),
        st.SparseMaxPool3d(2, 2, name="pool_b"))
    x = st.SparseConvTensor(torch.from_numpy(fp), torch.from_numpy(ip),
                            (9, 10, 11), 2)
    opened = []
    real = torch.profiler.record_function

    class Spy(real):
        def __init__(self, name, *a, **k):
            opened.append(name)
            super().__init__(name, *a, **k)

    torch.profiler.record_function = Spy
    try:
        with torch.no_grad():
            net(x)
        assert opened == []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                net(x)
    finally:
        torch.profiler.record_function = real
    # unsorted rows: both convs take the native path
    conv = ["spconv.rulebook", "spconv.product", "spconv.epilogue"]
    assert opened == ["sub_a", *conv, "SparseConv3d", *conv,
                      "pool_b", "spconv.rulebook", "spconv.pool"]
    names = {e.name for e in prof.events()}
    assert {"sub_a", "SparseConv3d", "pool_b", *conv,
            "spconv.pool"} <= names
