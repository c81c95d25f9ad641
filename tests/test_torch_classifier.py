"""``SparseClassifier`` and the two example flows of the port
(``examples/mnist_sparse.py``, ``examples/mnist_qat.py``) against the JAX
package on the CPU: the classifier's logits and gradients at ndim 2 and 3,
the first SGD steps of the MNIST example on the same batches, and the QAT
flow end to end to an int8 net."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.models import SparseClassifier as JaxClassifier

import spconv_tpu_torch as st
import spconv_tpu_torch.quantization as tq
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.examples import mnist_qat, mnist_sparse
from spconv_tpu_torch.models import SparseClassifier

from utils import generate_sparse_data

TOL = 1e-5  # f32 sums in another order, of max|ref| per tensor
LOSS_RTOL = 1e-5  # the example's losses over three SGD steps, relative


def _jax_example():
    """``examples/mnist_sparse.py`` as a module (its ``make_batch``)."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "mnist_sparse.py"
    spec = importlib.util.spec_from_file_location("jax_mnist_sparse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tensor(x):
    return spconv_tpu.SparseConvTensor(
        jnp.asarray(x.features.numpy()), jnp.asarray(x.indices.numpy()),
        x.spatial_shape, x.batch_size, keys_sorted=True)


def _input(ndim):
    """ndim 2: an MNIST-example batch (8 images, labels); ndim 3: two
    batch elements of 120 voxels in 320 rows, 3 features, key-sorted."""
    if ndim == 2:
        x, y = mnist_sparse.make_batch(np.random.RandomState(4),
                                       device="cpu")
        return x, y
    shape = (9, 10, 11)
    rng = np.random.RandomState(8)
    feats, inds = generate_sparse_data(shape, 120, 3, batch_size=2, rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key)
    fb = np.zeros((320, 3), np.float32)
    ib = np.full((320, 4), -1, np.int32)
    fb[:240], ib[:240] = feats[order], inds[order]
    x = st.SparseConvTensor(torch.from_numpy(fb), torch.from_numpy(ib),
                            shape, 2, keys_sorted=True)
    return x, torch.tensor([3, 7])


@pytest.mark.parametrize("ndim", [2, 3])
def test_classifier_matches_jax(ndim):
    """The port's classifier loaded strictly from the JAX one's state dict
    (its attribute names): logits within TOL of max|ref|, and the
    gradients of the mean cross-entropy for every parameter (the four
    convs through the subm and strided backward, the head) within TOL of
    ``jax.grad``'s, per tensor."""
    c_in = 1 if ndim == 2 else 3
    jnet = JaxClassifier(ndim=ndim, in_channels=c_in, num_classes=10,
                         key=jax.random.PRNGKey(ndim))
    sd = state_dict(jnet)
    tnet = load_jax_state_dict(SparseClassifier(
        ndim=ndim, in_channels=c_in, num_classes=10, device="cpu"), sd)
    assert set(tnet.state_dict()) == set(sd)
    x, y = _input(ndim)
    jx, jy = _jax_tensor(x), jnp.asarray(y.numpy())

    def loss_j(m, t):
        logits = m(t)
        return jnp.mean(-jax.nn.log_softmax(logits)[
            jnp.arange(jy.shape[0]), jy]), logits

    (lj, jlogits), grads = spconv_tpu.filter_value_and_grad(
        loss_j, has_aux=True)(jnet, jx)
    logits = tnet(x)
    loss = mnist_sparse.ce(logits, y)
    loss.backward()
    ref = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())
    assert abs(float(loss.detach()) - float(lj)) <= TOL * abs(float(lj))
    ref_g = state_dict(grads)
    assert len(list(tnet.parameters())) == 10
    for name, p in tnet.named_parameters():
        ref = ref_g[name]
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(),
                                   err_msg=name)


def test_mnist_sparse_steps_match_jax():
    """The first three SGD steps (lr 0.1) of the MNIST example, the port's
    ``make_batch`` / ``sgd_step`` against the JAX example's loop on the
    same ``RandomState(0)`` batches from the same weights: equal inputs
    and labels, each step's loss within LOSS_RTOL."""
    jex = _jax_example()
    rng_j, rng_t = np.random.RandomState(0), np.random.RandomState(0)
    jnet = JaxClassifier(ndim=2, in_channels=1, num_classes=10,
                         key=jax.random.PRNGKey(0))
    tnet = load_jax_state_dict(SparseClassifier(
        ndim=2, in_channels=1, num_classes=10, device="cpu"),
        state_dict(jnet))

    def loss_fn(m, x, y):
        logits = m(x)
        return jnp.mean(
            -jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y])

    grad_fn = jax.jit(spconv_tpu.filter_value_and_grad(loss_fn))
    for step in range(3):
        jx, jy = jex.make_batch(rng_j)
        x, y = mnist_sparse.make_batch(rng_t, device="cpu")
        np.testing.assert_array_equal(x.indices.numpy(),
                                      np.asarray(jx.indices))
        np.testing.assert_array_equal(x.features.numpy(),
                                      np.asarray(jx.features))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert x.keys_sorted
        loss_j, grads = grad_fn(jnet, jx, jy)
        dyn, sta = spconv_tpu.partition(
            jnet, lambda v: spconv_tpu.module._is_inexact(v))
        dyn = jax.tree_util.tree_map(
            lambda p, g: p - 0.1 * g if g is not None else p, dyn, grads,
            is_leaf=lambda v: v is None)
        jnet = spconv_tpu.combine(dyn, sta)
        loss_t = mnist_sparse.sgd_step(tnet, x, y, lr=0.1)
        assert abs(float(loss_t) - float(loss_j)) <= LOSS_RTOL * float(
            loss_j), step


def test_mnist_qat_main_runs_to_int8(capsys):
    """The port's MNIST QAT flow, ``main(device="cpu", steps=2)``, from
    float pretraining through PTQ and QAT to two int8 nets: finite
    losses, accuracies in [0, 1] on the same 8 batches, int8 nets of
    ``QuantizedSparseConv`` layers (subm then strided, ReLU fused) whose
    scale chains start at the stub's scale, and the printed summary; the
    float encoder keeps its running statistics (the prepared net holds
    copies)."""
    res = mnist_qat.main(device="cpu", steps=2)
    assert len(res["losses_float"]) == len(res["losses_qat"]) == 2
    assert all(np.isfinite(v) and v > 0
               for v in res["losses_float"] + res["losses_qat"])
    assert all(0.0 <= a <= 1.0 for a in res["accuracy"].values())
    for key in ("int8_ptq", "int8_qat"):
        net = res[key]
        assert isinstance(net, tq.QuantizedSequential)
        assert [(m.base.subm, m.act_type) for m in net.layers] == [
            (True, "relu"), (False, "relu")]
        assert all(m.weight_i8.dtype == torch.int8 for m in net.layers)
        assert net.layers[1].input_scale == net.layers[0].output_scale
    assert res["int8_qat"].input_scale == float(res["qnet"][0].scale)
    enc = res["enc"]
    assert not enc[1].running_mean.any() and (enc[1].running_var == 1).all()
    out = capsys.readouterr().out
    assert "float pretrain done" in out and "QAT int8" in out
