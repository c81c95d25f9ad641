"""The CenterPoint slice against the JAX package on the CPU: BatchNorm1d,
``SparseConvTensor.dense``, the whole ``centerpoint_encoder`` (coordinates
after every stage, features and the BEV map), out-bound calibration and
the strict state-dict load.  The JAX encoder runs its CPU route (the
native rulebook path, whose output discovery truncates exactly as
``build_conv_outputs`` does); the strided Pallas kernels are held against
the port in ``test_torch_strided.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.calibrate import calibrate_out_bounds as jax_calibrate
from spconv_tpu.calibrate import export_out_bounds as jax_export
from spconv_tpu.checkpoint import load_state_dict, state_dict
from spconv_tpu.models import centerpoint_encoder as jax_encoder

import spconv_tpu_torch as st
from spconv_tpu_torch.benchmark import centerpoint as CP
from spconv_tpu_torch.calibrate import (apply_out_bounds,
                                        calibrate_out_bounds,
                                        export_out_bounds)
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.models import centerpoint_encoder

from utils import generate_sparse_data

SHAPE = (40, 64, 64)
N_VOX = 1500


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small torch ops; with one intra-op
    thread each, parallel test workers do not oversubscribe the CPU (a
    whole-net test ran ~7x slower beside five busy processes without
    this)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tensor(x):
    return spconv_tpu.SparseConvTensor(
        jnp.asarray(x.features.numpy()), jnp.asarray(x.indices.numpy()),
        x.spatial_shape, x.batch_size, keys_sorted=True)


def _seeded_bn_state(sd, seed):
    """``sd`` with every BN tensor drawn from ``seed``: running stats
    away from (0, 1) and an affine part away from (1, 0)."""
    rng = np.random.RandomState(seed)
    out = dict(sd)
    for k, v in sd.items():
        if ".running_mean" in k or (k.endswith(".bias") and "bn" in k):
            out[k] = (0.3 * rng.randn(*v.shape)).astype(np.float32)
        elif ".running_var" in k or (k.endswith(".weight") and "bn" in k):
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_matches_jax(training):
    """Running stats (eval) or masked batch stats over active rows only
    (train), with non-trivial running stats and an invalid tail; f32
    within 1e-5*max|ref|, inactive rows 0.  The tensors are exactly the
    JAX leaves, so the state dict loads strictly."""
    rng = np.random.RandomState(0)
    feats = (rng.randn(200, 6) * 3 + 1).astype(np.float32)
    feats[150:] = 0
    inds = np.full((200, 4), -1, np.int32)
    inds[:150] = np.stack([np.zeros(150), np.arange(150) // 25,
                           np.arange(150) % 25, np.zeros(150)], 1)
    jbn = spconv_tpu.BatchNorm1d(6)
    sd = _seeded_bn_state({f"bn.{k}": v for k, v in state_dict(jbn).items()},
                          1)
    sd = {k[3:]: v for k, v in sd.items()}
    jbn = load_state_dict(jbn, sd)
    tbn = load_jax_state_dict(st.BatchNorm1d(6, device="cpu"), sd)
    assert set(tbn.state_dict()) == set(sd)
    tbn.train(training)
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     (6, 25, 1), 1)
    ref = np.asarray(jbn(jx, training=training).features)
    tx = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                             (6, 25, 1), 1)
    with torch.no_grad():
        got = tbn(tx).features.numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert not got[150:].any()
    # bf16 features are normalized in f32 and cast back
    tx16 = tx.replace_feature(tx.features.bfloat16())
    with torch.no_grad():
        got16 = tbn(tx16).features
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), ref, rtol=0,
                               atol=1.6e-2 * np.abs(ref).max())


@pytest.mark.parametrize("channels_first", [True, False])
def test_dense_matches_jax(channels_first):
    """``dense()`` of a two-batch tensor with an invalid tail equals the
    JAX package's, and the replace/overflow helpers behave alike."""
    shape = (5, 6, 7)
    rng = np.random.RandomState(2)
    feats, inds = generate_sparse_data(shape, 40, 3, batch_size=2, rng=rng)
    fb = np.zeros((96, 3), np.float32)
    ib = np.full((96, 4), -1, np.int32)
    fb[:80], ib[:80] = feats, inds
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(fb), jnp.asarray(ib), shape,
                                     2, num_out_total=jnp.int32(81))
    tx = st.SparseConvTensor(torch.from_numpy(fb), torch.from_numpy(ib),
                             shape, 2, num_out_total=torch.tensor(81))
    ref = np.asarray(jx.dense(channels_first))
    got = tx.dense(channels_first)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert bool(tx.overflowed) and bool(jx.overflowed)
    with pytest.raises(ValueError, match="overflowed"):
        tx.check_overflow("test")
    y = tx.replace_feature_masked(tx.features + 1)
    np.testing.assert_array_equal(
        y.features.numpy(),
        np.asarray(jx.replace_feature_masked(jx.features + 1).features))
    assert tx.replace_feature(y.features).features is y.features


def _jax_stages(net, x):
    """The JAX encoder's forward, returning the same stage outputs as the
    port's ``forward_stages``."""
    x = net.conv_input(x)
    if net.bn_input is not None:
        x = net.bn_input(x)
    x = x.replace_feature(jax.nn.relu(x.features))
    outs = []
    for si, blocks in enumerate(net.stages):
        if si > 0:
            x = net.downs[si - 1](x)
        for b in blocks:
            x = b(x)
        outs.append(x)
    x = net.conv_out(x)
    if net.bn_out is not None:
        x = net.bn_out(x)
    outs.append(x.replace_feature(jax.nn.relu(x.features)))
    return outs


@pytest.fixture(scope="module")
def scan():
    x, n = CP.synthetic_centerpoint_input(0, shape=SHAPE, n_target=N_VOX,
                                          device="cpu")
    assert n == N_VOX and tuple(x.features.shape) == (2048, 5)
    return x


@pytest.mark.parametrize("bn", [False, True])
def test_centerpoint_encoder_matches_jax(scan, bn):
    """``centerpoint_encoder(in_channels=5)`` with the JAX weights (and,
    with ``bn``, seeded running stats in eval mode): coordinates equal
    after every stage and downsample, features and the BEV map within
    1e-4*max|ref| (f32 sums in another order, through 21 convs)."""
    jnet = jax_encoder(in_channels=5, bn=bn)
    sd = state_dict(jnet)
    if bn:
        sd = _seeded_bn_state(sd, 3)
        jnet = load_state_dict(jnet, sd)
    tnet = load_jax_state_dict(
        centerpoint_encoder(in_channels=5, bn=bn, device="cpu"), sd).eval()
    assert set(tnet.state_dict()) == set(sd)
    jx = _jax_tensor(scan)
    j_stages = _jax_stages(jnet, jx)
    with torch.no_grad():
        t_stages = tnet.forward_stages(scan)
        bev = tnet.bev(scan)
    assert len(t_stages) == 5
    for j, t in zip(j_stages, t_stages):
        assert t.spatial_shape == tuple(j.spatial_shape) and t.keys_sorted
        np.testing.assert_array_equal(t.indices.numpy(),
                                      np.asarray(j.indices))
        assert int(t.num_voxels) == int(j.num_voxels) > 0
        ref = np.asarray(j.features)
        np.testing.assert_allclose(t.features.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    assert int(t_stages[-1].num_out_total) == int(j_stages[-1].num_out_total)
    ref = np.asarray(jnet.bev(jx))
    assert tuple(bev.shape) == ref.shape == (1, 128 * 2, 8, 8)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(bev.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_calibrated_bounds_match_jax(scan):
    """``calibrate_out_bounds`` records the same per-layer counts as the
    JAX package and exports the same bound list (subm layers None);
    ``apply_out_bounds`` round-trips it, and the calibrated net keeps
    every site.  The f32 net is deep-copied: the original keeps its
    bounds."""
    jnet = jax_encoder(in_channels=5, bn=False)
    tnet = load_jax_state_dict(
        centerpoint_encoder(in_channels=5, bn=False, device="cpu"),
        state_dict(jnet)).eval()
    jcal = jax_calibrate(jnet, lambda m, t: m.bev(t), [_jax_tensor(scan)],
                         margin=1.15, mult=8)
    tcal = calibrate_out_bounds(tnet, lambda m, t: m.bev(t), [scan],
                                margin=1.15, mult=8)
    want = jax_export(jcal)
    got = export_out_bounds(tcal)
    assert got == want and len(got) == 21
    assert got[:17] == [None] * 17 and all(b for b in got[17:])
    assert export_out_bounds(tnet) == [None] * 21
    again = apply_out_bounds(tnet, got)
    assert export_out_bounds(again) == got
    with torch.no_grad():
        out = tcal(scan)
    recs = [v for k, v in out.indice_dict.items()
            if k.startswith("__dgreg__")]
    assert len(recs) == 4
    assert all(int(r.num_out_total) == int(r.num_out) for r in recs)
    with pytest.raises(ValueError, match="21 layers"):
        apply_out_bounds(tnet, got[:3])


def test_calibration_records_clamped_count():
    """A layer whose output its bound already cuts calibrates to the cut
    count, not the true one, in both packages (reference behaviour, kept
    on both sides, as ROADMAP.md lists it)."""
    shape = (13, 14, 15)
    feats, inds = generate_sparse_data(shape, 400, 4,
                                       rng=np.random.RandomState(6))
    key = (inds[:, 1] * shape[1] + inds[:, 2]) * shape[2] + inds[:, 3]
    order = np.argsort(key)
    feats, inds = feats[order], inds[order]
    jconv = spconv_tpu.SparseConv3d(4, 8, 3, stride=2, padding=1,
                                    out_bound=100)
    tconv = load_jax_state_dict(
        st.SparseConv3d(4, 8, 3, stride=2, padding=1, out_bound=100,
                        device="cpu"),
        state_dict(jconv))
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, 1, keys_sorted=True)
    tx = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                             shape, 1, keys_sorted=True)
    with torch.no_grad():
        assert int(tconv(tx).num_out_total) > 100
    want = jax_export(jax_calibrate(jconv, None, [jx], margin=1.0, mult=8))
    got = export_out_bounds(calibrate_out_bounds(tconv, None, [tx],
                                                 margin=1.0, mult=8))
    assert got == want == [104]


def test_centerpoint_encoder_grads_match_jax(scan):
    """Every parameter's gradient of ``sum(bev ** 2)`` through the
    ``bn=False`` encoder against ``jax.grad`` of the JAX encoder's CPU
    route, within 5e-5*max|ref| per tensor (ROADMAP.md's grad tolerance):
    the strided backward at the k3 s2 p1 downsamples and at ``conv_out``'s
    (3,1,1) / (2,1,1), through the divide table."""
    jnet = jax_encoder(in_channels=5, bn=False)
    tnet = load_jax_state_dict(
        centerpoint_encoder(in_channels=5, bn=False, device="cpu"),
        state_dict(jnet))

    def loss(m, t):
        return jnp.sum(m.bev(t).astype(jnp.float32) ** 2)

    loss_j, grads = spconv_tpu.filter_value_and_grad(loss)(
        jnet, _jax_tensor(scan))
    g_ref = state_dict(grads)
    loss_t = (tnet.bev(scan).float() ** 2).sum()
    loss_t.backward()
    assert abs(float(loss_t) - float(loss_j)) <= 1e-4 * float(loss_j)
    recs = [k for k in g_ref if k.startswith(("downs.", "conv_out."))]
    assert len(recs) == 8
    for name, p in tnet.named_parameters():
        ref = g_ref[name]
        assert p.grad is not None and np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=5e-5 * np.abs(ref).max(),
                                   err_msg=name)
