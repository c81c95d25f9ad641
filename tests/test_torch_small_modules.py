"""The small modules of the port (``Lambda``, ``SparseIdentity`` /
``Identity``, ``SparseReLU``, ``SparseLeakyReLU``, ``SparseSigmoid``,
``SparseBatchNorm``, ``ToDense``, ``PrintTensorMeta``,
``PrintCurrentTime``, ``SparseSequential``'s bare callables, ``add`` and
iteration, ``assign_name_for_sparse_modules``) against the JAX package's on
the CPU, on tensors with padding rows."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.models import SparseClassifier as JaxClassifier
from spconv_tpu.quantization import prepare_qat as jax_prepare_qat

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.examples import mnist_qat
from spconv_tpu_torch.models import SparseClassifier
from spconv_tpu_torch.quantization import prepare_qat

from utils import generate_sparse_data

# f32 elementwise ops of two libraries (sigmoid, BN's rsqrt) differ by a
# few ulps: of max|ref|
TOL = 1e-6


def _tensors(ndim=3, n=150, c=6, nbuf=200, seed=0, batch=1):
    """A key-sorted tensor with ``nbuf - n`` padding rows, features in
    [-2, 2], as (port, JAX) tensors."""
    shape = (6, 7, 8)[:ndim] if ndim == 3 else (9, 11)
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n // batch, c,
                                       batch_size=batch, rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key)
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, ndim + 1), -1, np.int32)
    fb[:len(order)] = 2 * feats[order]
    ib[:len(order)] = inds[order]
    tx = st.SparseConvTensor(torch.from_numpy(fb), torch.from_numpy(ib),
                             shape, batch, keys_sorted=True)
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(fb), jnp.asarray(ib), shape,
                                     batch, keys_sorted=True)
    return tx, jx


def _affine(f):
    """A feature-wise function with ``f(0) != 0`` that both libraries'
    arrays support."""
    return f * 2.0 + 1.0


MODULES = {
    "Lambda": lambda P: P.Lambda(_affine),
    "SparseIdentity": lambda P: P.SparseIdentity(),
    "Identity": lambda P: P.Identity(),
    "SparseReLU": lambda P: P.SparseReLU(),
    "SparseLeakyReLU": lambda P: P.SparseLeakyReLU(0.2),
    "SparseSigmoid": lambda P: P.SparseSigmoid(),
}


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_featurewise_module_matches_jax(kind):
    """Each feature-wise module on a tensor with 50 padding rows: the
    features within TOL of max|ref| of the JAX module's, inactive rows 0
    (also where ``f(0) != 0``), the coordinates untouched.  On a plain
    tensor it applies the function to every row, as the JAX module does."""
    tx, jx = _tensors()
    tm, jm = MODULES[kind](st), MODULES[kind](spconv_tpu)
    got, want = tm(tx), jm(jx)
    ref = np.asarray(want.features)
    np.testing.assert_allclose(got.features.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())
    assert not got.features[150:].any()
    assert got.indices is tx.indices
    plain = tm(tx.features)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jm(jx.features)),
                               rtol=0, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("training", [False, True])
def test_sparse_batchnorm_matches_jax(training):
    """``SparseBatchNorm`` is ``BatchNorm1d``: with seeded running stats
    and affine part, eval (running stats) or train (masked batch stats),
    within TOL of max|ref| of the JAX module; loaded strictly."""
    tx, jx = _tensors(c=5)
    rng = np.random.RandomState(3)
    sd = dict(weight=rng.uniform(0.5, 2, 5).astype(np.float32),
              bias=(0.3 * rng.randn(5)).astype(np.float32),
              running_mean=(0.3 * rng.randn(5)).astype(np.float32),
              running_var=rng.uniform(0.5, 2, 5).astype(np.float32))
    jbn = spconv_tpu.SparseBatchNorm(5)
    jbn = jbn.replace(**{k: jnp.asarray(v) for k, v in sd.items()})
    tbn = load_jax_state_dict(st.SparseBatchNorm(5, device="cpu"), sd)
    assert isinstance(tbn, st.BatchNorm1d)
    tbn.train(training)
    got = tbn(tx).features.detach().numpy()
    ref = np.asarray(jbn(jx, training=training).features)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())
    assert not got[150:].any()


def test_sequential_bare_callable_add_and_iter():
    """A bare callable in ``SparseSequential`` is wrapped in ``Lambda`` (as
    the JAX container wraps it); the output equals the JAX container's
    within TOL.  ``add`` returns a new container with the layer appended,
    under its name when given, and leaves the old one as it was;
    iteration yields the layers in order."""
    tx, jx = _tensors()
    tseq = st.SparseSequential(st.SparseReLU(), _affine)
    jseq = spconv_tpu.SparseSequential(spconv_tpu.SparseReLU(), _affine)
    assert isinstance(tseq[1], st.Lambda) and len(tseq) == 2
    assert [type(m) for m in tseq] == [st.SparseReLU, st.Lambda]
    for t_s, j_s in ((tseq, jseq),
                     (tseq.add(st.SparseSigmoid()),
                      jseq.add(spconv_tpu.SparseSigmoid())),
                     (tseq.add(_affine, name="again"),
                      jseq.add(_affine, name="again"))):
        ref = np.asarray(j_s(jx).features)
        np.testing.assert_allclose(t_s(tx).features.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max())
    grown = tseq.add(_affine, name="again")
    assert len(tseq) == 2 and list(grown._modules) == ["0", "1", "again"]
    assert grown[0] is tseq[0] and isinstance(grown.again, st.Lambda)
    assert list(tseq.add(st.SparseSigmoid())._modules) == ["0", "1", "2"]


@pytest.mark.parametrize("ndim", [2, 3])
def test_to_dense_matches_jax(ndim):
    """``ToDense`` gives the JAX module's ``[B, C, *spatial]`` map exactly
    (batch 2, padding rows dropped); its channels-last layout (the
    tensor's ``dense(channels_first=False)``) is the JAX one's too."""
    tx, jx = _tensors(ndim=ndim, batch=2)
    got = st.ToDense()(tx)
    want = np.asarray(spconv_tpu.ToDense()(jx))
    assert tuple(got.shape) == want.shape == (2, 6, *tx.spatial_shape)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tx.dense(channels_first=False).numpy(),
                                  np.asarray(jx.dense(channels_first=False)))


def test_print_tensor_meta(capsys):
    """The same line as the JAX module's (which renders each shape entry
    as an array): feature shape and active count; the tensor passes
    through."""
    tx, jx = _tensors()
    assert st.PrintTensorMeta()(tx) is tx
    got = capsys.readouterr().out.strip()
    assert got == "SparseConvTensor feat_shape=(200, 6) num_voxels=150"
    spconv_tpu.PrintTensorMeta()(jx)
    jax.effects_barrier()
    want = capsys.readouterr().out.strip()
    nums = [int(v) for v in re.findall(r"Array\((\d+)", want)]
    assert want.startswith("SparseConvTensor feat_shape=(")
    assert nums == [200, 6] and want.endswith("num_voxels=150")


def test_print_current_time(capsys):
    """``[<package>] HH:MM:SS``, the JAX module's text with the port's
    tag; the tensor passes through."""
    tx, jx = _tensors()
    assert st.PrintCurrentTime()(tx) is tx
    got = capsys.readouterr().out.strip()
    spconv_tpu.PrintCurrentTime()(jx)
    want = capsys.readouterr().out.strip()
    assert re.fullmatch(r"\[spconv_tpu_torch\] \d\d:\d\d:\d\d", got)
    assert re.fullmatch(r"\[spconv_tpu\] \d\d:\d\d:\d\d", want)


def _jax_mnist_enc():
    """``examples/mnist_qat.py``'s float encoder (its ``build_net``)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    return spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv2d(1, 32, 3, indice_key="s1", bias=False,
                              key=ks[0]),
        spconv_tpu.BatchNorm1d(32), spconv_tpu.SparseReLU(),
        spconv_tpu.SparseConv2d(32, 64, 3, stride=2, padding=1, bias=False,
                                key=ks[1]),
        spconv_tpu.BatchNorm1d(64), spconv_tpu.SparseReLU())


def _jax_names(obj, out):
    """The ``name`` of every JAX module with one, in the JAX function's
    visiting order."""
    if isinstance(obj, spconv_tpu.Module):
        if "name" in obj.__dict__:
            out.append(obj.__dict__["name"])
        for v in obj.__dict__.values():
            _jax_names(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _jax_names(v, out)
    return out


def _port_names(module):
    return [m.name for m in module.modules() if "name" in vars(m)]


@pytest.mark.parametrize("net", ["mnist_enc", "mnist_qat", "classifier"])
def test_assign_names_match_jax(net):
    """``assign_name_for_sparse_modules`` names the MNIST QAT example's
    float encoder, its prepared QAT net and ``SparseClassifier`` as the
    JAX function names the same nets: ``f"{type}_{n}"`` in the same order,
    the same modules left unnamed; a given name is kept."""
    if net == "classifier":
        jnet = JaxClassifier(ndim=2, in_channels=1, num_classes=10)
        tnet = SparseClassifier(ndim=2, in_channels=1, num_classes=10,
                                device="cpu")
    else:
        jnet = _jax_mnist_enc()
        tnet = mnist_qat.build_net(device="cpu")[0]
        if net == "mnist_qat":
            jnet, tnet = jax_prepare_qat(jnet), prepare_qat(tnet)
    tnet_named = st.SparseReLU(name="kept")
    spconv_tpu.assign_name_for_sparse_modules(jnet)
    st.assign_name_for_sparse_modules(tnet)
    st.assign_name_for_sparse_modules(tnet_named)
    want = _jax_names(jnet, [])
    got = _port_names(tnet)
    assert got == want and len(got) >= 4
    assert all(re.fullmatch(r"[A-Za-z0-9]+_\d+", n) for n in got)
    assert tnet_named.name == "kept"
