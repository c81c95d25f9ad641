"""The slice: ``SparseUNet`` serving and training.  The port's small U-Net
with the JAX net's weights (loaded strictly, one to one) against the JAX
``SparseUNet`` on its CPU route (the native rulebook path): the output's
sites, its features and every parameter's gradient of ``sum(out ** 2)``;
one ``train_step``; and when the divide tables are built.  The Pallas
kernels the inverse and strided convs reach are held against the port in
``test_torch_inverse.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.models import SparseUNet as JaxUNet

from spconv_tpu_torch import SparseUNet
from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.benchmark import centerpoint as CP
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.models import centerpoint_encoder
from spconv_tpu_torch.ops import dg_conv as TD

SHAPE = (40, 64, 64)
N_VOX = 1500
CHANNELS = (8, 16, 24)
CLASSES = 5
FWD_TOL = 1e-4   # f32, of max|ref|: sums in another order, through 8 convs
GRAD_TOL = 5e-5  # f32, of max|ref| per tensor (ROADMAP.md)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the CPU with the plain versions' many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan():
    x, n = CP.synthetic_centerpoint_input(0, shape=SHAPE, n_target=N_VOX,
                                          device="cpu")
    assert n == N_VOX
    return x


@pytest.fixture(scope="module")
def jax_net():
    return JaxUNet(in_channels=5, channels=CHANNELS, num_classes=CLASSES)


def _port_net(jnet):
    net = SparseUNet(5, CHANNELS, CLASSES, device="cpu")
    sd = state_dict(jnet)
    assert set(net.state_dict()) == set(sd)
    return load_jax_state_dict(net, sd)


def _jax_tensor(x):
    return spconv_tpu.SparseConvTensor(
        jnp.asarray(x.features.numpy()), jnp.asarray(x.indices.numpy()),
        x.spatial_shape, x.batch_size, keys_sorted=True)


def test_unet_forward_matches_jax(scan, jax_net):
    """The output has exactly the input's sites (as the JAX net's) and its
    features are within 1e-4*max|ref| of the JAX net's."""
    ref = jax_net(_jax_tensor(scan))
    with torch.no_grad():
        out = _port_net(jax_net)(scan)
    np.testing.assert_array_equal(out.indices.numpy(), scan.indices.numpy())
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(ref.indices))
    assert out.spatial_shape == SHAPE and out.keys_sorted
    assert tuple(out.features.shape) == (scan.indices.shape[0], CLASSES)
    want = np.asarray(ref.features)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(out.features.numpy(), want, rtol=0,
                               atol=FWD_TOL * np.abs(want).max())
    assert not out.features[~scan.valid_mask].any()


def test_unet_grads_match_jax(scan, jax_net):
    """Every parameter's gradient of ``sum(out ** 2)`` against ``jax.grad``
    of the JAX net, within 5e-5*max|ref| per tensor: the subm, strided and
    inverse convs' backward and the skip joins."""
    def loss(m, t):
        return jnp.sum(m(t).features.astype(jnp.float32) ** 2)

    loss_j, grads = spconv_tpu.filter_value_and_grad(loss)(
        jax_net, _jax_tensor(scan))
    g_ref = state_dict(grads)
    net = _port_net(jax_net)
    loss_t = TB.train_step(net, scan, 0.0)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-4 * float(loss_j)
    for name, p in net.named_parameters():
        ref = g_ref[name]
        assert p.grad is not None and tuple(p.grad.shape) == ref.shape
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=name)


def test_unet_train_step_changes_every_parameter(scan):
    """One SGD step moves every parameter and lowers nothing to NaN."""
    net = SparseUNet(5, CHANNELS, CLASSES, device="cpu", seed=3)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    loss = TB.train_step(net, scan, 1e-3)
    assert np.isfinite(float(loss)) and float(loss) > 0
    for k, p in net.named_parameters():
        assert torch.isfinite(p).all(), k
        assert not torch.equal(p.detach(), before[k]), k


@pytest.fixture
def divide_builds(monkeypatch):
    """Counts the calls of ``build_dg_pos_divide`` (on the CPU no kernel
    launches, so ``launch_counts`` stays 0)."""
    calls = []
    real = TD.build_dg_pos_divide

    def counted(*args, **kw):
        calls.append(kw["in_shape"])
        return real(*args, **kw)

    monkeypatch.setattr(TD, "build_dg_pos_divide", counted)
    return calls


def _down_records(net, x):
    """Runs ``net`` on ``x``; returns, for each downsample, whether its
    record held a divide table just after the downsample ran, and the
    output."""
    seen = []
    hooks = [down.register_forward_hook(
        lambda m, i, out: seen.append(
            out.indice_dict[f"__dgreg__{m.indice_key}"].pos_div is not None))
        for down in net.enc_down]
    try:
        out = net(x)
    finally:
        for h in hooks:
            h.remove()
    return seen, out


def test_unet_divide_table_once_per_key(scan, divide_builds):
    """A training step builds one divide table per downsample, by the
    strided conv (its backward needs it), which the paired inverse conv
    then reuses; in serving the inverse conv builds it."""
    net = SparseUNet(5, CHANNELS, CLASSES, device="cpu")
    seen, out = _down_records(net, scan)
    assert seen == [True, True] and len(divide_builds) == 2
    recs = [out.indice_dict[f"__dgreg__down{i}"] for i in range(2)]
    assert all(r.pos_div is not None for r in recs)
    (out.features ** 2).sum().backward()
    assert len(divide_builds) == 2
    del divide_builds[:]
    with torch.no_grad():
        seen, out = _down_records(net, scan)
    assert seen == [False, False] and len(divide_builds) == 2
    assert all(out.indice_dict[f"__dgreg__down{i}"].pos_div is not None
               for i in range(2))


def test_no_divide_table_without_inverse_or_grad(scan, divide_builds):
    """A net with no inverse conv builds no divide table under
    ``torch.no_grad()``: the CenterPoint encoder's records keep none."""
    net = centerpoint_encoder(in_channels=5, bn=False, device="cpu").eval()
    with torch.no_grad():
        out = net(scan)
    recs = [v for k, v in out.indice_dict.items()
            if k.startswith("__dgreg__")]
    assert len(recs) == 4 and all(r.pos_div is None for r in recs)
    assert divide_builds == []
