"""Checkpoints, box ops, the point-cloud codec and the ported examples
against the JAX package on the CPU: npz checkpoints across the two
packages (served outputs within 1e-5*max|ref|), reference state dicts in
the KRSC / RSKC / RSCK layouts loaded as JAX's ``load_torch_state_dict``
loads them (exact), ``rbbox_intersection`` / ``rbbox_iou`` within 1e-5 and
equal NMS keep masks, the same codec bytes, and each example's core
against its JAX counterpart on the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu import checkpoint as JCK
from spconv_tpu.models import SparseEncoder as JaxEncoder
from spconv_tpu.quantization import fuse_bn_act_in_sequential as jax_fuse
from spconv_tpu.quantization import observe_encoder_scales as jax_observe
from spconv_tpu.quantization import quantize_encoder as jax_quantize
from spconv_tpu.utils import PointToVoxel as JaxPointToVoxel
from spconv_tpu.utils import boxops as JB
from spconv_tpu.utils import pcc as JP

import spconv_tpu_torch as st
from spconv_tpu_torch import checkpoint as TCK
from spconv_tpu_torch.examples import fuse_bn_act, int8_ptq_encoder, voxel_gen
from spconv_tpu_torch.models import SparseEncoder
from spconv_tpu_torch.quantization import (observe_encoder_scales,
                                           quantize_encoder)
from spconv_tpu_torch.utils import boxops as TB
from spconv_tpu_torch.utils import pcc as TP

# f32 nets of a few convs, the packages summing in other orders: of
# max|ref|
NET_TOL = 1e-5
BOX_TOL = 1e-5


def _tensors(seed=1):
    """``examples.fuse_bn_act``'s input (unsorted random sites), as (port,
    JAX): the nets below have its layers, so that the JAX ops compile once
    for this file."""
    tx = fuse_bn_act.make_input(np.random.RandomState(seed), device="cpu")
    return tx, spconv_tpu.SparseConvTensor(
        jnp.asarray(tx.features.numpy()), jnp.asarray(tx.indices.numpy()),
        tx.spatial_shape, 1)


def _jax_seq():
    return spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 16, 3, bias=False, indice_key="c1",
                              key=jax.random.PRNGKey(1)),
        spconv_tpu.BatchNorm1d(16),
        spconv_tpu.SparseReLU(),
        spconv_tpu.SubMConv3d(16, 16, 3, indice_key="c1",
                              key=jax.random.PRNGKey(2)))


def _port_seq(seed=5, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return st.SparseSequential(
        st.SubMConv3d(4, 16, 3, bias=False, indice_key="c1", device="cpu",
                      generator=gen, dtype=dtype),
        st.BatchNorm1d(16, device="cpu", dtype=dtype),
        st.SparseReLU(),
        st.SubMConv3d(16, 16, 3, indice_key="c1", device="cpu",
                      generator=gen, dtype=dtype)).eval()


def _seeded_bn(sd, seed=4):
    rng = np.random.RandomState(seed)
    out = dict(sd)
    for k in sd:
        if k.endswith("running_mean"):
            out[k] = rng.randn(16).astype(np.float32)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 2, 16).astype(np.float32)
    return out


def test_jax_checkpoint_loads_and_serves(tmp_path):
    """An npz written by the JAX ``save_checkpoint`` (``layers.<i>`` keys)
    loads into the port's net, which then serves the JAX net's output."""
    jnet = _jax_seq()
    jnet = JCK.load_state_dict(jnet, _seeded_bn(JCK.state_dict(jnet)))
    path = tmp_path / "jax.npz"
    JCK.save_checkpoint(jnet, path)
    tnet = st.load_checkpoint(_port_seq(), path)
    tx, jx = _tensors()
    with torch.no_grad():
        got = tnet(tx).features.numpy()
    ref = np.asarray(jnet(jx).features)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=NET_TOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_checkpoint_round_trip(tmp_path, dtype):
    """The port's own npz: every tensor back bit for bit (bf16 through its
    exact f32 widening), the same output; the encoder's npz, whose keys
    are the JAX attribute paths, loads into the JAX encoder too."""
    net, other = _port_seq(5, dtype), _port_seq(6, dtype)
    path = tmp_path / "port.npz"
    st.save_checkpoint(net, path)
    assert st.load_checkpoint(other, path) is other
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              other.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    tx, _ = _tensors()
    tx = tx.replace_feature(tx.features.to(dtype))
    with torch.no_grad():
        assert torch.equal(net(tx).features, other(tx).features)

    if dtype == torch.float32:
        enc = dict(in_channels=4, base_channels=8, channels=(8, 16),
                   blocks_per_stage=1, out_channels=16, bn=True)
        tenc = SparseEncoder(device="cpu", seed=3, **enc)
        st.save_checkpoint(tenc, tmp_path / "enc.npz")
        jenc = JCK.load_checkpoint(JaxEncoder(**enc), tmp_path / "enc.npz")
        for k, v in JCK.state_dict(jenc).items():
            np.testing.assert_array_equal(v, tenc.state_dict()[k].numpy())


def _reference_state_dict(layout, prefix=""):
    """A reference spconv state dict of the Sequential (keys ``0.weight``
    ...), the conv weights in ``layout``, BN with its
    ``num_batches_tracked``."""
    rng = np.random.RandomState(9)
    krsc = {"0.weight": rng.randn(16, 3, 3, 3, 4), "3.weight":
            rng.randn(16, 3, 3, 3, 16)}
    sd = {}
    for k, w in krsc.items():
        if layout == "RSKC":
            w = np.moveaxis(w, 0, 3)
        elif layout == "RSCK":
            w = np.moveaxis(w, 0, 4)
        sd[k] = torch.from_numpy(w.astype(np.float32))
    sd["3.bias"] = torch.from_numpy(rng.randn(16).astype(np.float32))
    sd["1.weight"] = torch.from_numpy(rng.rand(16).astype(np.float32))
    sd["1.bias"] = torch.from_numpy(rng.randn(16).astype(np.float32))
    sd["1.running_mean"] = torch.from_numpy(rng.randn(16).astype(np.float32))
    sd["1.running_var"] = torch.from_numpy(
        rng.uniform(0.5, 2, 16).astype(np.float32))
    sd["1.num_batches_tracked"] = torch.tensor(7)
    return {prefix + k: v for k, v in sd.items()}, krsc


@pytest.mark.parametrize("layout", ["KRSC", "RSKC", "RSCK"])
def test_load_torch_state_dict_matches_jax(layout):
    """The same reference state dict through both packages'
    ``load_torch_state_dict``: every tensor equal, the conv weights the
    KRSC originals."""
    sd, krsc = _reference_state_dict(layout)
    jnet = JCK.load_torch_state_dict(_jax_seq(), sd, layout=layout)
    tnet = TCK.load_torch_state_dict(_port_seq(), sd, layout=layout)
    want = {k.replace("layers.", ""): v
            for k, v in JCK.state_dict(jnet).items()}
    got = {k: v.numpy() for k, v in tnet.state_dict().items()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, w in krsc.items():
        np.testing.assert_array_equal(got[k], w.astype(np.float32))
    w = krsc["0.weight"]
    for lay, moved in (("RSKC", np.moveaxis(w, 0, 3)),
                       ("RSCK", np.moveaxis(w, 0, 4))):
        assert np.array_equal(TCK.convert_torch_weight_layout(moved, lay, 3),
                              w)
        t = TCK.convert_torch_weight_layout(torch.from_numpy(moved), lay, 3)
        assert np.array_equal(t.numpy(), w)


def test_load_torch_state_dict_suffix_keys():
    """Keys nested under a prefix match by their one suffix at a dot; an
    unknown layout and a key without a match raise."""
    sd, krsc = _reference_state_dict("RSKC", prefix="backbone.")
    tnet = TCK.load_torch_state_dict(_port_seq(), sd, layout="RSKC")
    np.testing.assert_array_equal(tnet.state_dict()["3.weight"].numpy(),
                                  krsc["3.weight"].astype(np.float32))
    with pytest.raises(ValueError, match="unknown layout"):
        TCK.convert_torch_weight_layout(np.zeros((3, 3, 3, 2, 2)), "KCRS", 3)
    del sd["backbone.1.running_var"]
    with pytest.raises(KeyError, match="1.running_var"):
        TCK.load_torch_state_dict(_port_seq(), sd, layout="RSKC")


def _boxes(seed, n=40):
    """``n`` rotated boxes crowded into a 2 x 2 square, so that they
    overlap, nest and suppress one another (40 boxes in every test: the
    JAX ops compile once a shape)."""
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(0, 2, (n, 2)), rng.uniform(0.5, 3, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    return b.astype(np.float32)


def test_rotated_box_ops_match_jax():
    """Rotated intersection and IoU of 40 x 40 boxes within BOX_TOL of the
    JAX ops; a box against itself, or against a copy shrunk about its
    centre, gives the smaller box's area."""
    b1, b2 = _boxes(0), _boxes(1)
    b2[0] = b1[0]
    b2[1] = b1[1] * np.array([1, 1, 0.5, 0.5, 1], np.float32)
    for fn in ("rbbox_intersection", "rbbox_iou"):
        got = getattr(TB, fn)(torch.from_numpy(b1), torch.from_numpy(b2))
        ref = np.asarray(getattr(JB, fn)(jnp.asarray(b1), jnp.asarray(b2)))
        assert got.shape == ref.shape == (40, 40)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BOX_TOL
                                   * max(1.0, np.abs(ref).max()))
    inter = TB.rbbox_intersection(torch.from_numpy(b1[:2]),
                                  torch.from_numpy(b2[:2])).diagonal()
    areas = b2[:2, 2] * b2[:2, 3]
    np.testing.assert_allclose(inter.numpy(), areas, rtol=1e-5)


@pytest.mark.parametrize("rotated", [False, True])
def test_nms_matches_jax(rotated):
    """Greedy NMS of 40 crowded boxes, some marked invalid: the keep mask
    equal to the JAX op's."""
    rng = np.random.RandomState(5)
    b = _boxes(2)
    scores = rng.rand(40).astype(np.float32)
    valid = rng.rand(40) > 0.1
    if rotated:
        got = TB.rotate_nms(torch.from_numpy(b), torch.from_numpy(scores),
                            0.3, torch.from_numpy(valid))
        ref = JB.rotate_nms(jnp.asarray(b), jnp.asarray(scores), 0.3,
                            jnp.asarray(valid))
    else:
        ab = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:4]], 1)
        got = TB.nms(torch.from_numpy(ab), torch.from_numpy(scores), 0.3,
                     torch.from_numpy(valid))
        ref = JB.nms(jnp.asarray(ab), jnp.asarray(scores), 0.3,
                     jnp.asarray(valid))
    ref = np.asarray(ref)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < valid.sum()


@pytest.mark.parametrize("cols", [3, 4])
def test_pcc_writes_the_same_bytes(cols):
    """XYZ_8 and XYZI_8: the same stream as the JAX codec, decoded alike
    and within the error bound."""
    rng = np.random.RandomState(cols)
    pts = rng.uniform(-20, 20, (3000, cols)).astype(np.float32)
    data = TP.encode_xyz(pts, 0.02)
    assert data == JP.encode_xyz(pts, 0.02)
    back = TP.decode_xyz(data)
    np.testing.assert_array_equal(back, JP.decode_xyz(data))
    assert back.shape == pts.shape
    assert TP.EncodeType.XYZI_8.value == 1
    with pytest.raises(ValueError, match="pcc stream"):
        TP.decode_xyz(b"XXXX" + data[4:])


def test_voxel_gen_matches_jax():
    """``examples.voxel_gen``'s core (PointToVoxel with empty means, the
    voxel means, SubMConv3d(4, 16, 3) with the JAX example's weights, the
    features mapped back to the points) against the JAX example's steps
    on the same cloud."""
    pc = voxel_gen.make_points(0)
    jgen = JaxPointToVoxel([0.25] * 3, [-10, -10, -2, 10, 10, 2], 4, 20000,
                           5)
    voxels, coords, npv, vid, _ = jgen.generate_voxel_with_id(
        pc, empty_mean=True)
    feats = jnp.sum(voxels, axis=1) / jnp.maximum(npv[:, None], 1).astype(
        voxels.dtype)
    inds = jnp.concatenate([jnp.where(coords[:, :1] >= 0, 0, -1), coords], 1)
    feats = jnp.where((inds[:, 0] >= 0)[:, None], feats, 0)
    conv = spconv_tpu.SubMConv3d(4, 16, 3, indice_key="c1",
                                 key=jax.random.PRNGKey(0))
    y = conv(spconv_tpu.SparseConvTensor(feats, inds, jgen.grid_size, 1))
    ref = np.asarray(spconv_tpu.utils.gather_features_by_pc_voxel_id(
        y.features, vid))

    gen = voxel_gen.make_generator("cpu")
    x, _, _ = voxel_gen.voxel_tensor(gen, pc)
    np.testing.assert_array_equal(x.features.numpy(), np.asarray(feats))
    tconv = st.SubMConv3d(4, 16, 3, indice_key="c1", device="cpu")
    st.load_jax_state_dict(tconv, JCK.state_dict(conv))
    got = voxel_gen.run(tconv, gen, pc)
    assert got.shape == (20000, 16) and np.abs(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=NET_TOL * np.abs(ref).max())


def test_fuse_bn_act_matches_jax():
    """``examples.fuse_bn_act``: the same BN statistics and input drawn
    from the seed as the JAX example draws them; with the JAX net's
    weights, the fused net equals its unfused net and the JAX fused
    net's output."""
    rng = np.random.RandomState(0)
    jnet = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 16, 3, bias=False, indice_key="c1"),
        spconv_tpu.BatchNorm1d(16),
        spconv_tpu.SparseReLU(),
        spconv_tpu.SubMConv3d(16, 16, 3, bias=True, indice_key="c1"))
    bn = jnet.layers[1].replace(
        running_mean=jnp.asarray(rng.randn(16).astype(np.float32)) * 0.1,
        running_var=jnp.asarray(rng.uniform(0.5, 2, 16).astype(np.float32)))
    jnet = spconv_tpu.SparseSequential(jnet.layers[0], bn, *jnet.layers[2:])

    trng = np.random.RandomState(0)
    tnet = fuse_bn_act.make_net(trng, "cpu")
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(getattr(tnet[1], name).numpy(),
                                      np.asarray(getattr(bn, name)))
    st.load_jax_state_dict(tnet, JCK.state_dict(jnet))
    tx = fuse_bn_act.make_input(trng, device="cpu")
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(tx.features.numpy()),
                                     jnp.asarray(tx.indices.numpy()),
                                     fuse_bn_act.SHAPE, 1)
    fused = st.quantization.fuse_bn_act_in_sequential(tnet).eval()
    assert len(fused) == 2 and fused[0].act_type == "relu"
    with torch.no_grad():
        ref, out = tnet(tx).features, fused(tx).features
    want = np.asarray(jax_fuse(jnet)(jx).features)
    scale = np.abs(want).max()
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=NET_TOL * scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=NET_TOL * scale)
    _, out_main = fuse_bn_act.main(device="cpu")
    assert out_main.shape == (256, 16)


def _flat_scales(scales):
    """A scales dict's numbers in order."""
    out = [scales["in"], scales["cin"], *scales["down"], scales["out"]]
    for stage in scales["blocks"]:
        for pair in stage:
            out += list(pair)
    return np.array(out)


def test_int8_ptq_encoder_matches_jax():
    """``examples.int8_ptq_encoder``: the same scans from the seed as the
    JAX example; with the JAX example's weights (PRNGKey(0)) the scales
    observed on them within 1e-6 of the JAX ones, and from the JAX scales
    the int8 output within 2 output steps of the JAX CPU route's on all but
    1 % of the entries (its epilogue rounds ties another way, ROADMAP.md
    queue C), both L2 errors against the fp encoders under the example's
    0.1; ``main`` passes that bound on its own weights."""
    jenc = JaxEncoder(in_channels=4, base_channels=8, channels=(8, 16),
                      blocks_per_stage=1, out_channels=16, bn=False,
                      out_bounds=(512,), key=jax.random.PRNGKey(0))
    tenc = st.load_jax_state_dict(int8_ptq_encoder.make_encoder("cpu"),
                                  JCK.state_dict(jenc))
    calib = [int8_ptq_encoder.make_scan(np.random.RandomState(s),
                                        device="cpu") for s in range(4)]
    jcalib = [spconv_tpu.SparseConvTensor(
        jnp.asarray(t.features.numpy()), jnp.asarray(t.indices.numpy()),
        t.spatial_shape, 1, keys_sorted=True) for t in calib]
    jscales = jax_observe(jenc, jcalib)
    with torch.no_grad():
        scales = observe_encoder_scales(tenc, calib)
    want = _flat_scales(jscales)
    np.testing.assert_allclose(_flat_scales(scales), want, rtol=1e-6)
    x, jx = calib[0], jcalib[0]  # the example's scan: RandomState(0)
    jq = jax_quantize(jenc, scales=jscales)
    with torch.no_grad():
        tq = quantize_encoder(tenc, scales=jscales)
        out, fp = tq(x).features.numpy(), tenc(x).features.numpy()
    ref, jfp = np.asarray(jq(jx).features), np.asarray(jenc(jx).features)
    steps = np.abs(out - ref) / tq.out_scale
    assert steps.max() <= 2 + 1e-3 and (steps > 1e-3).mean() <= 0.01
    for got, base in ((out, fp), (ref, jfp)):
        assert np.linalg.norm(got - base) / np.linalg.norm(base) < 0.1
    _, _, l2, _ = int8_ptq_encoder.main(device="cpu")
    assert l2 < 0.1

