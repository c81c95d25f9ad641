"""The port's deployment export (``spconv_tpu_torch/export.py``) and its
kernels as ``torch.library`` ops (``ops/library.py``) on the CPU.

The nets: ``tests/test_export.py``'s SubM(4, 8) -> SparseConv(8, 16, s2)
on ``(9, 10, 11)`` and ``centerpoint_encoder(5, bn=False)`` on ``(21, 36,
36)`` with 420 voxels in 512 rows, on the DG route (key-sorted input:
the ``dg_pos`` and ``dg_gather_gemm`` ops) and with ``algo="native"``
(rulebooks from torch ops, ``dg_gather_gemm``), with the JAX nets'
weights.  The port's exported program, and the program after
``serialize`` / ``deserialize_and_call``, are bit-equal to the port's
eager run (the plain versions behind the ops, the same torch ops around
them), and match the JAX package's ``serialize`` / ``deserialize_and_call``
on the same inputs within 1e-5 abs (f32 sums in another order), with equal
indices.  The int8 encoder (``quantize_encoder``, the ``dg_fwd_q`` op)
exports bit-equal to its eager run and stays within
``test_torch_quant_encoder.py``'s 2-step / 1 % bound of the JAX eager int8
encoder.  A fresh interpreter that imports ``spconv_tpu_torch`` (no JAX)
reloads a blob and reproduces the output.  Each op passes
``torch.library.opcheck`` and its fake gives its CPU output's shape and
dtype, on the arguments its wrappers pass (recorded by a dispatch mode).
"""

import collections
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.export import deserialize_and_call as jax_call
from spconv_tpu.export import serialize as jax_serialize
from spconv_tpu.models import centerpoint_encoder as jax_encoder
from spconv_tpu.quantization import quantize_encoder as jax_quantize

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.export import (deserialize_and_call, export_inference,
                                     serialize)
from spconv_tpu_torch.models import centerpoint_encoder
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import library as TL
from spconv_tpu_torch.ops import sorted_pool as TSP
from spconv_tpu_torch.quantization import (observe_encoder_scales,
                                           quantize_encoder)

from utils import generate_sparse_data, pad_sparse

REPO = Path(__file__).resolve().parents[1]
SMALL_SHAPE = (9, 10, 11)
CP_SHAPE = (21, 36, 36)
JAX_TOL = 1e-5
# test_torch_quant_encoder.py's bound of the int8 output against the JAX
# CPU route, in output steps, and the share of entries that may differ
STEP_BOUND = 2
MISMATCH_SHARE = 0.01
# the ops of one forward of each net, in the exported graph
CP_OPS = {"dg": {"dg_pos": 8, "dg_gather_gemm": 21},
          "native": {"dg_gather_gemm": 21}}
SMALL_OPS = {"dg": {"dg_pos": 2, "dg_gather_gemm": 2},
             "native": {"dg_gather_gemm": 2}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the CPU (as in ``test_torch_centerpoint.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sorted_input(shape, n, c, nbuf, seed):
    """``n`` random sites of ``c`` features, key-sorted, in ``nbuf`` rows
    (numpy)."""
    feats, inds = generate_sparse_data(shape, n, c, batch_size=1,
                                       rng=np.random.RandomState(seed))
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    return pad_sparse(feats[order], inds[order], nbuf)


def _infer(pkg, net, shape, bev):
    """The exported function of either package: features and indices ->
    the net's features and indices (``bev``: the dense BEV map first)."""
    def infer(f, i):
        out = net(pkg.SparseConvTensor(f, i, shape, 1, keys_sorted=True))
        if not bev:
            return out.features, out.indices
        dense = out.dense()
        b, c, d, h, w = dense.shape
        return dense.reshape(b, c * d, h, w), out.features, out.indices

    return infer


def _small_nets(algo):
    jnet = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 8, 3, indice_key="c1", act_type="relu",
                              algo=algo),
        spconv_tpu.SparseConv3d(8, 16, 3, stride=2, padding=1, out_bound=512,
                                algo=algo))
    tnet = st.SparseSequential(
        st.SubMConv3d(4, 8, 3, indice_key="c1", act_type="relu", algo=algo,
                      device="cpu"),
        st.SparseConv3d(8, 16, 3, stride=2, padding=1, out_bound=512,
                        algo=algo, device="cpu"))
    return jnet, load_jax_state_dict(tnet, state_dict(jnet)).eval()


def _cp_nets(algo):
    jnet = jax_encoder(in_channels=5, bn=False, dtype=jnp.float32, algo=algo)
    tnet = centerpoint_encoder(in_channels=5, bn=False, algo=algo,
                               device="cpu")
    return jnet, load_jax_state_dict(tnet, state_dict(jnet)).eval()


def _graph_ops(program):
    """``{op name: nodes}`` of the ``spconv_tpu_torch`` ops in an exported
    program's graph."""
    prefix = f"{TL.NAMESPACE}."
    return dict(collections.Counter(
        str(n.target)[len(prefix):].split(".")[0]
        for n in program.graph.nodes if str(n.target).startswith(prefix)))


def _check_export(pkg_nets, shape, n, c, nbuf, seed, bev, ops):
    """The port's exported and reloaded programs bit-equal to its eager
    run, with ``ops`` in the graph; the JAX package's exported program
    within ``JAX_TOL`` (floats) and equal (indices)."""
    jnet, tnet = pkg_nets
    fp, ip = _sorted_input(shape, n, c, nbuf, seed)
    f, i = torch.from_numpy(fp), torch.from_numpy(ip)
    infer = _infer(st, tnet, shape, bev)
    with torch.no_grad():
        want = infer(f, i)
    program = export_inference(infer, (f, i))
    assert _graph_ops(program) == ops
    blob = serialize(infer, (f, i))
    assert isinstance(blob, bytes) and len(blob) > 1000
    jf, ji = jnp.asarray(fp), jnp.asarray(ip)
    jouts = jax_call(jax_serialize(_infer(spconv_tpu, jnet, shape, bev),
                                   (jf, ji)), jf, ji)
    for outs in (program.module()(f, i), deserialize_and_call(blob, f, i)):
        assert len(outs) == len(want) == len(jouts)
        for got, ref, jref in zip(outs, want, jouts):
            assert torch.equal(got, ref)
            jref = np.asarray(jref)
            if got.dtype.is_floating_point:
                assert np.abs(jref).max() > 0
                np.testing.assert_allclose(got.numpy(), jref, rtol=0,
                                           atol=JAX_TOL)
            else:
                np.testing.assert_array_equal(got.numpy(), jref)


@pytest.mark.parametrize("algo", ["dg", "native"])
def test_small_net_exports_like_eager_and_jax(algo):
    """``tests/test_export.py``'s net, on key-sorted input."""
    _check_export(_small_nets(None if algo == "dg" else algo), SMALL_SHAPE,
                  120, 4, 256, 42, False, SMALL_OPS[algo])


@pytest.mark.parametrize("algo", ["dg", "native"])
def test_centerpoint_exports_like_eager_and_jax(algo):
    """The CenterPoint encoder to its BEV map (and last stage's features
    and indices): 8 tables and 21 gather-GEMMs on the DG route, 21
    gather-GEMMs on the native one."""
    _check_export(_cp_nets(None if algo == "dg" else algo), CP_SHAPE, 420, 5,
                  512, 0, True, CP_OPS[algo])


def test_int8_encoder_exports_like_eager_and_matches_jax():
    """``quantize_encoder`` of the CenterPoint encoder (scales observed on
    the scan, the same dict on both sides): the exported and reloaded
    programs bit-equal to the eager int8 output, with 8 tables and 21
    ``dg_fwd_q`` calls in the graph; the output within ``STEP_BOUND``
    output steps of the JAX eager int8 encoder, equal on all but
    ``MISMATCH_SHARE`` of the entries."""
    jnet, tnet = _cp_nets(None)
    fp, ip = _sorted_input(CP_SHAPE, 420, 5, 512, 1)
    f, i = torch.from_numpy(fp), torch.from_numpy(ip)
    x = st.SparseConvTensor(f, i, CP_SHAPE, 1, keys_sorted=True)
    with torch.no_grad():
        scales = observe_encoder_scales(tnet, [x])
        tq = quantize_encoder(tnet, scales=scales).eval()
    jq = jax_quantize(jnet, scales=scales)
    infer = _infer(st, tq, CP_SHAPE, False)
    with torch.no_grad():
        want = infer(f, i)
    program = export_inference(infer, (f, i))
    assert _graph_ops(program) == {"dg_pos": 8, "dg_fwd_q": 21}
    blob = serialize(infer, (f, i))
    for outs in (program.module()(f, i), deserialize_and_call(blob, f, i)):
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref)
    jout = jq(spconv_tpu.SparseConvTensor(jnp.asarray(fp), jnp.asarray(ip),
                                          CP_SHAPE, 1, keys_sorted=True))
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(jout.indices))
    ref = np.asarray(jout.features)
    assert np.abs(ref).max() > 0
    steps = np.abs(want[0].numpy() - ref) / tq.out_scale
    assert steps.max() <= STEP_BOUND + 1e-3, steps.max()
    assert (steps > 1e-3).mean() <= MISMATCH_SHARE, (steps > 1e-3).mean()


def test_export_refuses_a_net_in_training_mode():
    """A module with a submodule in training mode is refused, naming it;
    in eval mode it exports, and its program equals the eager call."""
    net = st.SparseSequential(st.SubMConv3d(4, 8, 3, indice_key="c1",
                                            device="cpu"),
                              st.SparseReLU())
    fp, ip = _sorted_input(SMALL_SHAPE, 50, 4, 64, 3)
    x = st.SparseConvTensor(torch.from_numpy(fp), torch.from_numpy(ip),
                            SMALL_SHAPE, 1, keys_sorted=True)

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, f, i):
            return self.net(st.SparseConvTensor(f, i, SMALL_SHAPE, 1,
                                                keys_sorted=True)).features

    wrap = Wrap()
    wrap.eval()
    net[1].train()
    with pytest.raises(ValueError, match=r"net\.1 is in training mode"):
        export_inference(wrap, (x.features, x.indices))
    wrap.eval()
    program = export_inference(wrap, (x.features, x.indices))
    with torch.no_grad():
        assert torch.equal(program.module()(x.features, x.indices),
                           wrap(x.features, x.indices))


_CHILD = """
import sys
import numpy as np
import torch
import spconv_tpu_torch  # registers the kernels' ops
from spconv_tpu_torch.export import deserialize_and_call

blob_path, in_path, out_path = sys.argv[1:4]
data = np.load(in_path)
outs = deserialize_and_call(open(blob_path, "rb").read(),
                            torch.from_numpy(data["f"]),
                            torch.from_numpy(data["i"]))
np.savez(out_path, *[o.numpy() for o in outs])
assert "jax" not in sys.modules and "spconv_tpu" not in sys.modules
"""


def test_fresh_interpreter_reloads_the_blob(tmp_path):
    """The counterpart of ``test_export_subprocess.py``: the CenterPoint
    encoder's blob, reloaded in a fresh interpreter that imports
    ``spconv_tpu_torch`` and never JAX, reproduces the eager output bit
    for bit."""
    jnet, tnet = _cp_nets(None)
    fp, ip = _sorted_input(CP_SHAPE, 420, 5, 512, 2)
    f, i = torch.from_numpy(fp), torch.from_numpy(ip)
    infer = _infer(st, tnet, CP_SHAPE, True)
    with torch.no_grad():
        want = infer(f, i)
    (tmp_path / "cp.pt2").write_bytes(serialize(infer, (f, i)))
    np.savez(tmp_path / "inputs.npz", f=fp, i=ip)
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path / "cp.pt2"),
         str(tmp_path / "inputs.npz"), str(tmp_path / "outputs.npz")],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, f"child failed:\n{r.stderr[-3000:]}"
    got = np.load(tmp_path / "outputs.npz")
    assert len(got.files) == len(want)
    for k, ref in zip(sorted(got.files, key=lambda n: int(n.split("_")[1])),
                      want):
        np.testing.assert_array_equal(got[k], ref.numpy())


def test_export_model_example_writes_the_artifact(tmp_path):
    """``examples.export_model`` on the CPU (a 2,048-voxel budget): the
    program, the inputs, the expected outputs and the manifest; the saved
    program run on the saved inputs gives the expected bytes."""
    from spconv_tpu_torch.examples import export_model

    res = export_model.main(device="cpu", out_dir=tmp_path, nbuf=2048)
    lines = (tmp_path / "manifest.txt").read_text().splitlines()
    assert lines == ["input f32 2048,3 input_0.bin",
                     "input s32 2048,4 input_1.bin",
                     "output f32 2048,64 expected_0.bin",
                     "output s32 2048,4 expected_1.bin"]
    dtypes = {"f32": np.float32, "s32": np.int32}
    arrays = {}
    for line in lines:
        _, dt, dims, name = line.split()
        arrays[name] = np.fromfile(tmp_path / name, dtypes[dt]).reshape(
            [int(d) for d in dims.split(",")])
    assert 0 < res["active"] <= 2048
    assert (arrays["input_1.bin"][:, 0] >= 0).sum() == 2048 - 128
    outs = deserialize_and_call(
        (tmp_path / "model.pt2").read_bytes(),
        torch.from_numpy(arrays["input_0.bin"]),
        torch.from_numpy(arrays["input_1.bin"]))
    for got, name, ref in zip(outs, ("expected_0.bin", "expected_1.bin"),
                              res["outputs"]):
        np.testing.assert_array_equal(got.numpy(), arrays[name])
        assert torch.equal(got, ref)
    assert np.abs(arrays["expected_0.bin"]).max() > 0


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

class _OpCalls(TorchDispatchMode):
    """Records each ``spconv_tpu_torch`` op called under it, with its
    arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == TL.NAMESPACE:
            self.calls.append((func, args, kwargs))
        return func(*args, **kwargs)


def _op_cases():
    """``{case: (op, args, kwargs)}``: each op in each of its modes, as
    the wrappers call it on a small key-sorted scan (f32; int8 for B7):
    B1 subm, reversed, affine and divide; B2 forward and dgrad on a table,
    S1 and S2; B7 on a table with bias, ReLU and a residual, and S4;
    wgrad on a table and S3; B6 max and mean."""
    shape, out_shape, c, k = (5, 6, 7), (3, 3, 4), 4, 8
    fp, ip = _sorted_input(shape, 60, c, 64, 5)
    ind = torch.from_numpy(ip)
    keys, _ = TC.linearize(ind, shape, 1)
    live = ip[:, 0] >= 0
    parents = np.unique((ip[live, 1:] // 2) @ np.array([12, 4, 1]))
    out_keys = torch.full((32,), TC.grid_sentinel(out_shape, 1),
                          dtype=torch.int32)
    out_keys[:len(parents)] = torch.from_numpy(parents.astype(np.int32))
    g = torch.Generator().manual_seed(9)
    x = torch.from_numpy(fp)
    w = torch.randn((27, c, k), generator=g)
    x8 = torch.randint(-127, 128, (64, c), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (27, c, k), generator=g, dtype=torch.int8)
    scale = torch.rand(k, generator=g) / 100
    bias = torch.randn(k, generator=g)
    add = torch.randint(-127, 128, (64, k), generator=g, dtype=torch.int8)
    subm = dict(ksize=(3, 3, 3), dilation=(1, 1, 1), spatial_shape=shape,
                batch_size=1)
    reg = dict(ksize=(2, 2, 2), stride=(2, 2, 2), padding=(0, 0, 0),
               dilation=(1, 1, 1), in_shape=shape, out_shape=out_shape,
               batch_size=1)
    geom = TD.SearchGeom.of(**subm)
    cases = {}
    with _OpCalls() as rec:
        for name, call in [
                ("dg_pos subm", lambda: TD.build_dg_pos(keys, **subm)),
                ("dg_pos reversed", lambda: TD.build_dg_pos(
                    keys, reverse=True, **subm)),
                ("dg_pos affine", lambda: TD.build_dg_pos_affine(
                    keys, out_keys, **reg)),
                ("dg_pos divide", lambda: TD.build_dg_pos_divide(
                    keys, out_keys, path="transposed", **reg))]:
            n = len(rec.calls)
            cases[name] = (call(), n)
        pos = cases["dg_pos subm"][0]
        rev = cases["dg_pos reversed"][0]
        dout = torch.randn((64, k), generator=g)
        for name, call in [
                ("B2 forward", lambda: TD.dg_fwd(x, w, pos)),
                ("B2 dgrad", lambda: TD.dg_dgrad(dout, w, rev)),
                ("S1", lambda: TD.dg_fwd_search(x, w, keys, geom)),
                ("S2", lambda: TD.dg_dgrad_search(dout, w, keys, geom)),
                ("B7", lambda: TD.dg_fwd_q(x8, w8, pos, scale, bias,
                                           act="relu", add=add,
                                           add_scale=0.5)),
                ("S4", lambda: TD.dg_fwd_q_search(x8, w8, keys, scale, None,
                                                  geom)),
                ("wgrad", lambda: TD.dg_wgrad(x, dout, rev)),
                ("S3", lambda: TD.dg_wgrad_search(x, dout, keys, geom)),
                ("B6 max", lambda: TSP.sk_pool2(
                    x, keys, out_keys, in_shape=shape, out_shape=out_shape,
                    batch_size=1)),
                ("B6 mean", lambda: TSP.sk_pool2(
                    x, keys, out_keys, in_shape=shape, out_shape=out_shape,
                    batch_size=1, mode="mean"))]:
            n = len(rec.calls)
            cases[name] = (call(), n)
    assert len(rec.calls) == len(cases)
    return {name: rec.calls[n] for name, (_, n) in cases.items()}


OPS = ("dg_pos", "dg_gather_gemm", "dg_fwd_q", "dg_wgrad", "sk_pool")
OP_CASES = ("dg_pos subm", "dg_pos reversed", "dg_pos affine",
            "dg_pos divide", "B2 forward", "B2 dgrad", "S1", "S2", "B7", "S4",
            "wgrad", "S3", "B6 max", "B6 mean")


@pytest.fixture(scope="module")
def op_cases():
    cases = _op_cases()
    assert tuple(cases) == OP_CASES
    return cases


def test_every_kernel_family_is_an_op(op_cases):
    """The five ops, each with CUDA, CPU and fake (Meta) kernels, and
    each wrapper mode calling its family's op."""
    family = {"dg_pos": "dg_pos", "B2": "dg_gather_gemm",
              "S1": "dg_gather_gemm", "S2": "dg_gather_gemm",
              "B7": "dg_fwd_q", "S4": "dg_fwd_q", "wgrad": "dg_wgrad",
              "S3": "dg_wgrad", "B6": "sk_pool"}
    for case, (op, _, _) in op_cases.items():
        assert op.name() == f"{TL.NAMESPACE}::{family[case.split()[0]]}"
    for name in OPS:
        qual = f"{TL.NAMESPACE}::{name}"
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key)


@pytest.mark.parametrize("case", OP_CASES)
def test_op_passes_opcheck(op_cases, case):
    """``torch.library.opcheck`` (schema, autograd registration, fake
    tensor, AOT dispatch with dynamic shapes) on the CPU arguments the
    wrapper passes, none needing a gradient."""
    op, args, kwargs = op_cases[case]
    torch.library.opcheck(op, args, kwargs)


@pytest.mark.parametrize("case", OP_CASES)
def test_op_fake_matches_cpu_output(op_cases, case):
    """Each op's fake kernel gives its CPU output's shape and dtype (and
    the wrapper's output is the op's)."""
    op, args, kwargs = op_cases[case]
    real = op(*args, **kwargs)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = op(*fake_args, **kwargs)
    assert fake.shape == real.shape and fake.dtype == real.dtype
    assert real.device.type == "cpu" and real.numel() > 0
