"""The C++ deployment path on the CPU: the kernels' ops defined from C++
(``spconv_tpu_torch/csrc/torch_ops.cpp``, ``_build.build_ops_library``)
and the loader (``examples/libtorch_loader``, ``_build.build_loader``)
serving an AOTInductor package (``export.package``) with no Python.

One module fixture builds the CPU op library and the loader (``g++``
against the installed torch) and writes the artifact of
``examples.export_model``'s net and input at a 2,048-voxel budget
(``write_artifact``), ``package.pt2`` included, with the JAX example's
net's weights (``checkpoint.load_jax_state_dict``).  Then:

* the five C++ schemas equal the Python ones, character for character;
* each C++ CPU kernel gives the Python CPU kernel's bits on
  ``test_torch_export.py``'s op cases, in an interpreter that loads only
  the C++ library (``torch.ops.load_library``) and never imports the
  port, and counts one launch a call; ``dg_wgrad`` is refused there with
  its message;
* the loader, in a process with no ``PYTHONPATH`` and no libpython,
  serves the package: ``LOADER_OK``, three ``dg_gather_gemm`` launches a
  request, every output bit-equal to ``expected_*.bin``, which matches the
  JAX package's forward of the same net within 1e-5 * max|ref| (indices
  equal); a corrupted golden gives ``LOADER_MISMATCH`` and exit 1;
* an int8 CenterPoint encoder (``quantize_encoder`` on ``(21, 36, 36)``)
  through the loader, bit-equal to eager with eager's launches.
"""

import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict

import spconv_tpu_torch as st
from spconv_tpu_torch._build import build_loader, build_ops_library
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.examples import export_model
from spconv_tpu_torch.examples.export_model import run_loader, write_artifact
from spconv_tpu_torch.models import centerpoint_encoder
from spconv_tpu_torch.quantization import (observe_encoder_scales,
                                           quantize_encoder)

from test_torch_export import (CP_SHAPE, OP_CASES, OPS, _infer, _op_cases,
                               _sorted_input)

NBUF = 2048
JAX_TOL = 1e-5  # of max|ref|: f32 sums in another order
TIMEOUT = 300   # seconds a subprocess may take
# the cases whose op is dg_wgrad, which the C++ library refuses
REFUSED = ("wgrad", "S3")


def _env(tmp):
    """A subprocess's environment: no PYTHONPATH, one thread."""
    return {"PATH": "/usr/bin:/bin", "HOME": str(tmp), "TMPDIR": str(tmp),
            "OMP_NUM_THREADS": "1"}


def _loader(built, artifact, requests=1):
    """``export_model.run_loader``, one thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("TMPDIR", str(artifact.parent))
        return run_loader(built["ops"], built["loader"], artifact, requests,
                          timeout=TIMEOUT)


def _jax_net(nbuf):
    """The JAX example's net (``examples/pjrt_loader/export_model.py``)."""
    kw = dict(algo="native")
    return spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(3, 32, 3, indice_key="s0", act_type="relu",
                              **kw),
        spconv_tpu.SparseConv3d(32, 64, 3, stride=2, padding=1,
                                act_type="relu", out_bound=nbuf, **kw),
        spconv_tpu.SubMConv3d(64, 64, 3, indice_key="s1", **kw))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The CPU op library, the loader, and the example's artifact (with
    the JAX net's weights) under ``artifact``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    with ThreadPoolExecutor(2) as pool:
        ops = pool.submit(build_ops_library, False)
        loader = pool.submit(build_loader, False)
        ops, loader = ops.result()[0], loader.result()[0]
    tmp = tmp_path_factory.mktemp("cpp_loader")
    jnet = _jax_net(NBUF)
    tnet = load_jax_state_dict(export_model.build_net("cpu", NBUF),
                               state_dict(jnet)).eval()
    feats, inds, shape = export_model.load_input(0, NBUF)

    def forward(f, i):
        y = tnet(st.SparseConvTensor(f, i, shape, 1, keys_sorted=True))
        return y.features, y.indices

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch._inductor.config.patch(compile_threads=1):
            res = write_artifact(tmp / "artifact", forward,
                                 (torch.from_numpy(feats),
                                  torch.from_numpy(inds)), package=True)
    finally:
        torch.set_num_threads(n)
    return {"ops": ops, "loader": loader, "artifact": tmp / "artifact",
            "jnet": jnet, "res": res, "tmp": tmp}


def _manifest(artifact):
    """``{file: array}`` of the artifact's manifest."""
    dtypes = {"f32": np.float32, "s32": np.int32}
    arrays = {}
    for line in (artifact / "manifest.txt").read_text().splitlines():
        _, dt, dims, name = line.split()
        arrays[name] = np.fromfile(artifact / name, dtypes[dt]).reshape(
            [int(d) for d in dims.split(",")])
    return arrays


def test_loader_serves_the_package_bit_equal(built):
    """``LOADER_OK``, exit 0, 3 native gather-GEMM launches a request,
    each output bit-equal to its golden, over 3 requests (each
    checked)."""
    r = _loader(built, built["artifact"], 3)
    assert r["rc"] == 0 and r["ok"], (r["stdout"][-2000:],
                                      r["stderr"][-3000:])
    assert r["launches"] == {"dg_fwd_native": 3}
    assert [(o["dtype"], o["dims"]) for o in r["outputs"]] == [
        ("f32", "2048,64"), ("s32", "2048,4")]
    assert all(o["bitequal"] and o["ok"] and o["max_abs_diff"] == 0
               for o in r["outputs"])
    assert len(r["request_ms"]) == 3 and r["load_s"] >= 0
    assert "\nrequest " not in r["stdout"]


def test_package_outputs_match_jax(built):
    """The goldens the loader reproduced bit for bit (eager's outputs on
    the JAX weights) against the JAX package's forward of the same net on
    the same input: features within 1e-5 * max|ref|, indices equal."""
    arrays = _manifest(built["artifact"])
    feats, inds = arrays["input_0.bin"], arrays["input_1.bin"]
    _, _, shape = export_model.load_input(0, NBUF)
    y = built["jnet"](spconv_tpu.SparseConvTensor(
        jnp.asarray(feats), jnp.asarray(inds), shape, 1, keys_sorted=True))
    ref = np.asarray(y.features)
    assert np.abs(ref).max() > 0
    np.testing.assert_array_equal(arrays["expected_1.bin"],
                                  np.asarray(y.indices))
    np.testing.assert_allclose(arrays["expected_0.bin"], ref, rtol=0,
                               atol=JAX_TOL * np.abs(ref).max())
    for got, want in zip(built["res"]["outputs"],
                         (arrays["expected_0.bin"], arrays["expected_1.bin"])):
        np.testing.assert_array_equal(got.numpy(), want)


def test_loader_reports_a_mismatch(built, tmp_path):
    """A golden with one value changed: ``LOADER_MISMATCH``, exit 1, the
    output's line marked."""
    art = tmp_path / "artifact"
    shutil.copytree(built["artifact"], art)
    gold = np.fromfile(art / "expected_0.bin", np.float32)
    gold[np.argmax(np.abs(gold))] += 1.0
    gold.tofile(art / "expected_0.bin")
    r = _loader(built, art)
    assert r["rc"] == 1, (r["stdout"][-2000:], r["stderr"][-3000:])
    assert r["stdout"].splitlines()[-1] == "LOADER_MISMATCH"
    assert [o["ok"] for o in r["outputs"]] == [False, True]
    assert abs(r["outputs"][0]["max_abs_diff"] - 1.0) < 1e-6


def test_loader_process_has_no_python(built):
    """Neither the loader nor the op library it loads links libpython."""
    for path in (built["loader"], built["ops"]):
        r = subprocess.run(["ldd", str(path)], capture_output=True,
                           text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        assert "libtorch" in r.stdout and "libpython" not in r.stdout


# ---------------------------------------------------------------------------
# the C++ ops in an interpreter that never imports the port
# ---------------------------------------------------------------------------

_CHILD = """
import ctypes
import sys
import torch

torch.set_num_threads(1)
lib, cases_path, out_path = sys.argv[1:4]
torch.ops.load_library(lib)
ns = torch.ops.spconv_tpu_torch
ops, cases = torch.load(cases_path)
schemas = {name: str(getattr(ns, name).default._schema) for name in ops}
outputs = {}
for case, (op, args, kwargs) in cases.items():
    try:
        outputs[case] = getattr(ns, op)(*args, **kwargs)
    except RuntimeError as e:
        outputs[case] = str(e)
buf = ctypes.create_string_buffer(4096)
ctypes.CDLL(lib).spconv_tpu_torch_launch_counts(buf, 4096)
torch.save({"schemas": schemas, "outputs": outputs,
            "counts": buf.value.decode()}, out_path)
if "spconv_tpu_torch" in sys.modules or "jax" in sys.modules:
    sys.exit("the child imported the port or JAX")
"""


@pytest.fixture(scope="module")
def cpp_ops(built):
    """``(Python CPU outputs, the child's results)`` on the op cases."""
    cases = _op_cases()
    assert tuple(cases) == OP_CASES
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = {case: op(*args, **kwargs)
                for case, (op, args, kwargs) in cases.items()
                if case not in REFUSED}
    finally:
        torch.set_num_threads(n)
    plain = {case: (op.name().split("::")[1], list(args), kwargs)
             for case, (op, args, kwargs) in cases.items()}
    tmp = built["tmp"]
    torch.save((OPS, plain), tmp / "cases.pt")
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, str(built["ops"]),
         str(tmp / "cases.pt"), str(tmp / "cpp_out.pt")],
        capture_output=True, text=True, timeout=TIMEOUT, env=_env(tmp))
    assert r.returncode == 0, r.stderr[-3000:]
    return cases, want, torch.load(tmp / "cpp_out.pt")


@pytest.mark.parametrize("name", OPS)
def test_cpp_schema_equals_python(cpp_ops, name):
    """The op's schema from C++ is the Python one, character for
    character."""
    python = str(getattr(torch.ops.spconv_tpu_torch, name).default._schema)
    assert cpp_ops[2]["schemas"][name] == python


@pytest.mark.parametrize("case", [c for c in OP_CASES if c not in REFUSED])
def test_cpp_cpu_kernel_equals_python(cpp_ops, case):
    """The C++ CPU kernel's output is the Python CPU kernel's, bit for
    bit (same dtype and shape)."""
    _, want, got = cpp_ops
    out = got["outputs"][case]
    assert isinstance(out, torch.Tensor), out
    assert out.dtype == want[case].dtype and torch.equal(out, want[case])
    assert want[case].numel() > 0


def test_cpp_ops_count_each_call(cpp_ops):
    """One launch counted a call, under the counter the wrapper passed
    (``sk_pool`` for B6), none for the refused calls."""
    cases, _, got = cpp_ops
    want = {}
    for case, (op, args, _) in cases.items():
        if case in REFUSED:
            continue
        counter = "sk_pool" if case.startswith("B6") else args[-1]
        want[counter] = want.get(counter, 0) + 1
    assert got["counts"] == " ".join(f"{k}={v}" for k, v in sorted(
        want.items()))


@pytest.mark.parametrize("case", REFUSED)
def test_cpp_dg_wgrad_is_refused(cpp_ops, case):
    """``dg_wgrad`` (wgrad and S3) raises with its message: a training op,
    which no inference program holds."""
    msg = cpp_ops[2]["outputs"][case]
    assert isinstance(msg, str)
    assert "dg_wgrad is refused by the C++ op library" in msg
    assert "training op" in msg


# ---------------------------------------------------------------------------
# an int8 encoder through the loader
# ---------------------------------------------------------------------------

def test_int8_encoder_through_the_loader(built, tmp_path):
    """``quantize_encoder`` of ``centerpoint_encoder(5, bn=False)`` (scales
    observed on the scan) packaged and served by the loader: features and
    indices bit-equal to eager, 4 + 4 tables and 17 + 4 ``dg_fwd_q``
    launches a request."""
    fp, ip = _sorted_input(CP_SHAPE, 420, 5, 512, 1)
    f, i = torch.from_numpy(fp), torch.from_numpy(ip)
    net = centerpoint_encoder(in_channels=5, bn=False, device="cpu").eval()
    x = st.SparseConvTensor(f, i, CP_SHAPE, 1, keys_sorted=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            scales = observe_encoder_scales(net, [x])
            qnet = quantize_encoder(net, scales=scales).eval()
        with torch._inductor.config.patch(compile_threads=1):
            write_artifact(tmp_path / "int8", _infer(st, qnet, CP_SHAPE,
                                                     False), (f, i),
                           package=True)
    finally:
        torch.set_num_threads(n)
    r = _loader(built, tmp_path / "int8")
    assert r["rc"] == 0 and r["ok"], (r["stdout"][-2000:],
                                      r["stderr"][-3000:])
    assert r["launches"] == dict(dg_fwd_q=17, dg_fwd_q_strided=4, dg_pos=4,
                                 dg_pos_affine=4)
    assert len(r["outputs"]) == 2
    assert all(o["bitequal"] and o["ok"] for o in r["outputs"])


def test_package_compiler_builds_openmp(monkeypatch):
    """``export.package`` compiles with a C++ compiler that builds OpenMP
    code: a ``$CXX`` that cannot (here one that does not exist; on a
    machine, a compiler built without libgomp) gives way to ``g++``."""
    from spconv_tpu_torch import export

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    export._openmp_cxx.cache_clear()
    try:
        assert export._openmp_cxx() == "g++"
    finally:
        export._openmp_cxx.cache_clear()
