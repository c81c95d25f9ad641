"""The port's int8 kernel path against the JAX package on the CPU.

``dg_fwd_q`` (B7's wrapper, which takes its plain version on the CPU) is
held exactly against the Pallas int8 kernels run in interpret mode: the
subm conv ``dg_subm_conv_q`` with the fused residual, the inverse conv
``dg_regular_conv_q(inverse=True)``, and B8, ``sk_subm_conv_q``, which
computes the subm function through a one-hot join (the other modes, layer
by layer through an encoder, in ``test_torch_quant_encoder.py``).  The
observers, the tensor and per-channel weight quantizers, BN folding and the
int8 conv's folded scales are held exactly against the JAX package's, and
the module-level int8 convs (the stage's shared table, the strided record,
the inverse conv) and ``SparseSequential`` calibration against its
modules.  Each interpret-mode call costs ~10 s (compiling the kernel), so
the cases are few and small; the CUDA kernel is held against the plain
version in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import load_state_dict, state_dict
from spconv_tpu.ops.pallas.dg_conv import dg_regular_conv_q, dg_subm_conv_q
from spconv_tpu.ops.pallas.sorted_conv import sk_subm_conv_q
from spconv_tpu.quantization import fuse as jfuse
from spconv_tpu.quantization import quantize as jq

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.quantization import fuse as tfuse
from spconv_tpu_torch.quantization import quantize as tq

from test_torch_inverse import _keys
from test_torch_strided import _sorted_input

SHAPE = (9, 11, 13)
KSIZE = (3, 3, 3)
DIL = (1, 1, 1)
WINDOW = 128  # the JAX kernels' key window: the result does not depend on
              # it, and the smallest compiles fastest in interpret mode
ADD_SCALE = 0.37


def _int8(rng, shape, valid=None, lim=100):
    q = rng.randint(-lim, lim, shape)
    if valid is not None:
        q = np.where(valid[:, None], q, 0)
    return q.astype(np.int8)


def _vectors(rng, k_out):
    """A per-channel requant scale (acc of ~9 matched offsets x 8-16
    channels lands in and past +-127) and a bias, f32."""
    return (rng.uniform(0.001, 0.01, k_out).astype(np.float32),
            rng.uniform(-1, 1, k_out).astype(np.float32))


def _subm_case(seed, c, k_out, n=300, nbuf=384):
    _, inds = _sorted_input(seed, SHAPE, n, c, nbuf)
    rng = np.random.RandomState(seed + 100)
    valid = inds[:, 0] >= 0
    x = _int8(rng, (nbuf, c), valid)
    w = _int8(rng, (k_out, *KSIZE, c), lim=80)
    scale, bias = _vectors(rng, k_out)
    add = _int8(rng, (nbuf, k_out), valid, lim=90)
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    return x, w, scale, bias, add, keys


def _port_q(x, w, pos, scale, bias, path="subm", **kw):
    """``dg_fwd_q`` on CPU tensors (its plain version), launching nothing."""
    before = dict(TD.launch_counts)
    out = TD.dg_fwd_q(
        torch.from_numpy(x), TD.weight_krsc_to_kv(torch.from_numpy(w)), pos,
        torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias), path=path, **kw)
    assert TD.launch_counts == before and out.dtype == torch.int8
    return out.numpy()


def test_dg_fwd_q_subm_residual_matches_pallas():
    """The subm conv with the fused residual, no bias and no act, every
    row bit for bit against ``dg_subm_conv_q`` (a row without a match gets
    the epilogue of a zero sum on both sides).  The relu + bias modes, with
    and without the residual, and the strided conv are held layer by layer
    in ``test_torch_quant_encoder.py``."""
    x, w, scale, _, add, keys = _subm_case(0, 8, 16)
    pos = TD.build_dg_pos(keys, ksize=KSIZE, dilation=DIL,
                          spatial_shape=SHAPE, batch_size=1)
    got = _port_q(x, w, pos, scale, None, add=torch.from_numpy(add),
                  add_scale=ADD_SCALE)
    ref = np.asarray(dg_subm_conv_q(
        jnp.asarray(x), jnp.asarray(keys.numpy()), jnp.asarray(w),
        jnp.asarray(scale), None, spatial_shape=SHAPE, batch_size=1,
        dilation=DIL, add_features=jnp.asarray(add), add_scale=ADD_SCALE,
        window=WINDOW, interpret=True))
    assert (np.abs(ref) == 127).any() and (ref < 0).any()
    np.testing.assert_array_equal(got, ref)


def test_sk_subm_q_shares_b7():
    """B8: ``sk_subm_conv_q`` computes B7's subm function through a one-hot
    key join, so ``dg_fwd_q`` on the stage's table matches it bit for
    bit."""
    x, w, scale, bias, _, keys = _subm_case(1, 16, 8)
    pos = TD.build_dg_pos(keys, ksize=KSIZE, dilation=DIL,
                          spatial_shape=SHAPE, batch_size=1)
    got = _port_q(x, w, pos, scale, bias, act="relu")
    ref = np.asarray(sk_subm_conv_q(
        jnp.asarray(x), jnp.asarray(keys.numpy()), jnp.asarray(w),
        jnp.asarray(scale), jnp.asarray(bias), spatial_shape=SHAPE,
        batch_size=1, dilation=DIL, act="relu", window=WINDOW,
        interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_dg_fwd_q_inverse_matches_pallas():
    """The inverse conv (divide table, N_out source rows onto N_in) with
    bias and relu against ``dg_regular_conv_q(inverse=True)``, every
    output row, bit for bit."""
    _, _, out_inds, in_keys, out_keys, geom, _ = _keys("k3s2p1", c=8)
    rng = np.random.RandomState(3)
    x = _int8(rng, (out_inds.shape[0], 8), out_inds[:, 0] >= 0)
    w = _int8(rng, (16, *KSIZE, 8), lim=60)
    scale, bias = _vectors(rng, 16)
    pos = TD.build_dg_pos_divide(in_keys, out_keys, **geom)
    got = _port_q(x, w, pos, scale, bias, act="relu", path="inverse")
    jgeom = {k: v for k, v in geom.items() if k != "ksize"}
    ref, _ = dg_regular_conv_q(
        jnp.asarray(x), jnp.asarray(in_keys.numpy()),
        jnp.asarray(out_keys.numpy()), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), act="relu", inverse=True, window=WINDOW,
        interpret=True, **jgeom)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (in_keys.shape[0], 16)
    assert (ref != 0).any()
    np.testing.assert_array_equal(got, ref)


def test_dg_fwd_q_refusals():
    """Bad operands raise instead of computing something else."""
    x, w, scale, bias, add, keys = _subm_case(2, 8, 16, n=60, nbuf=64)
    pos = TD.build_dg_pos(keys, ksize=KSIZE, dilation=DIL,
                          spatial_shape=SHAPE, batch_size=1)
    tx, tw = torch.from_numpy(x), TD.weight_krsc_to_kv(torch.from_numpy(w))
    ts, tb, ta = (torch.from_numpy(v) for v in (scale, bias, add))
    with pytest.raises(ValueError, match="int8"):
        TD.dg_fwd_q(tx.float(), tw, pos, ts, tb)
    with pytest.raises(ValueError, match="act"):
        TD.dg_fwd_q(tx, tw, pos, ts, tb, act="sigmoid")
    with pytest.raises(ValueError, match="subm-only"):
        TD.dg_fwd_q(tx, tw, pos, ts, tb, add=ta, path="strided")
    with pytest.raises(ValueError, match="float32"):
        TD.dg_fwd_q(tx, tw, pos, ts.double(), tb)
    with pytest.raises(ValueError, match="add must be"):
        TD.dg_fwd_q(tx, tw, pos, ts, tb, add=ta[:, :8].contiguous())
    with pytest.raises(ValueError, match="path"):
        TD.dg_fwd_q(tx, tw, pos, ts, tb, path="transposed")


def test_observers_and_quantizers_match_jax():
    """Observers over the active rows, the per-channel weight observer,
    ``quantize_tensor`` (ties round half to even), the per-channel weight
    quantizer and ``dequantize``: all exactly the JAX package's."""
    rng = np.random.RandomState(4)
    feats = (rng.randn(200, 6) * 3).astype(np.float32)
    feats[150:] = 99.0  # inactive rows: the observer must not see them
    inds = np.full((200, 4), -1, np.int32)
    inds[:150] = np.stack([np.zeros(150), np.arange(150) // 25,
                           np.arange(150) % 25, np.zeros(150)], 1)
    jobs, tobs = jq.MinMaxObserver(), tq.MinMaxObserver()
    jobs.observe(spconv_tpu.SparseConvTensor(
        jnp.asarray(feats), jnp.asarray(inds), (6, 25, 1), 1))
    tobs.observe(st.SparseConvTensor(torch.from_numpy(feats),
                                     torch.from_numpy(inds), (6, 25, 1), 1))
    assert tobs.amax == jobs.amax < 99 and tobs.scale == jobs.scale
    w = (rng.randn(8, 3, 3, 3, 4) * 0.1).astype(np.float32)
    jw, tw = jq.PerChannelMinMaxObserver(), tq.PerChannelMinMaxObserver()
    jw.observe(jnp.asarray(w))
    tw.observe(torch.from_numpy(w))
    assert tw.scale.dtype == np.float32
    np.testing.assert_array_equal(tw.scale, jw.scale)
    # values on and beside the ties of the rounding, and past +-127
    s = 0.0123
    x = np.concatenate([(np.arange(-140, 140) + 0.5) * np.float32(s),
                        rng.randn(500) * 0.6]).astype(np.float32)
    q = tq.quantize_tensor(torch.from_numpy(x), s)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jq.quantize_tensor(jnp.asarray(x), s)))
    qw = tq.quantize_weight_per_channel(torch.from_numpy(w), tw.scale)
    np.testing.assert_array_equal(
        qw.numpy(),
        np.asarray(jq.quantize_weight_per_channel(jnp.asarray(w), jw.scale)))
    np.testing.assert_array_equal(
        tq.dequantize(qw, 0.3).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(qw.numpy()), 0.3)))


def _seeded_bn(rng, n):
    return dict(running_mean=rng.uniform(-1, 1, n).astype(np.float32),
                running_var=rng.uniform(0.5, 2, n).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, n).astype(np.float32),
                bias=rng.uniform(-1, 1, n).astype(np.float32))


@pytest.mark.parametrize("conv_bias", [False, True])
def test_fuse_conv_bn_matches_jax(conv_bias):
    """The folded weight and bias are bit-equal to the JAX package's; the
    original conv keeps its tensors."""
    rng = np.random.RandomState(5)
    jconv = spconv_tpu.SubMConv3d(4, 8, 3, bias=conv_bias, indice_key="c")
    jbn = load_state_dict(spconv_tpu.BatchNorm1d(8), _seeded_bn(rng, 8))
    tconv = load_jax_state_dict(
        st.SubMConv3d(4, 8, 3, bias=conv_bias, indice_key="c", device="cpu"),
        state_dict(jconv))
    tbn = load_jax_state_dict(st.BatchNorm1d(8, device="cpu"),
                              state_dict(jbn))
    jf = jfuse.fuse_conv_bn(jconv, jbn)
    tf = tfuse.fuse_conv_bn(tconv, tbn)
    np.testing.assert_array_equal(tf.weight.detach().numpy(),
                                  np.asarray(jf.weight))
    np.testing.assert_array_equal(tf.bias.detach().numpy(),
                                  np.asarray(jf.bias))
    np.testing.assert_array_equal(tconv.weight.detach().numpy(),
                                  np.asarray(jconv.weight))
    assert tf.indice_key == "c" and tf.subm


def test_fuse_bn_act_sequential_and_sparse_relu():
    """conv -> bn -> relu folds into one conv with a relu epilogue, the
    rest passes through, and the fused net computes what the unfused one
    does; ``SparseReLU`` keeps inactive rows at 0."""
    rng = np.random.RandomState(6)
    feats, inds = _sorted_input(6, SHAPE, 150, 4, 256)
    x = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                            SHAPE, 1, keys_sorted=True)
    bn = load_jax_state_dict(st.BatchNorm1d(8, device="cpu"),
                             _seeded_bn(rng, 8)).eval()
    seq = st.SparseSequential(
        st.SubMConv3d(4, 8, 3, bias=False, indice_key="c1", device="cpu"),
        bn, st.SparseReLU(),
        st.SubMConv3d(8, 8, 3, indice_key="c1", device="cpu"),
        st.SparseReLU())
    fused = tfuse.fuse_bn_act_in_sequential(seq)
    layers = list(fused.children())
    assert len(layers) == 3 and layers[0].act_type == "relu"
    assert isinstance(layers[2], st.SparseReLU)
    with torch.no_grad():
        want, got = seq(x).features, fused(x).features
    assert want.abs().max() > 0 and not want[150:].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())
    # SparseReLU against the JAX module, on f32 and int8 features
    for dt in (np.float32, np.int8):
        f = np.where(inds[:, :1] >= 0, rng.randint(-50, 50, (256, 3)),
                     0).astype(dt)
        ref = spconv_tpu.SparseReLU()(spconv_tpu.SparseConvTensor(
            jnp.asarray(f), jnp.asarray(inds), SHAPE, 1)).features
        out = st.SparseReLU()(st.SparseConvTensor(
            torch.from_numpy(f), torch.from_numpy(inds), SHAPE, 1)).features
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _conv_pair(cls_j, cls_t, *args, seed, **kw):
    jconv = cls_j(*args, **kw)
    tconv = load_jax_state_dict(cls_t(*args, device="cpu", **kw),
                                state_dict(jconv))
    wobs = jq.PerChannelMinMaxObserver()
    wobs.observe(jconv.weight)
    rng = np.random.RandomState(seed)
    s_in, s_out = rng.uniform(0.01, 0.1, 2)
    return (jq.QuantizedSparseConv(jconv, wobs.scale, s_in, s_out,
                                   act_type="relu"),
            tq.QuantizedSparseConv(tconv, wobs.scale, s_in, s_out,
                                   act_type="relu"))


def test_quantized_conv_state_matches_jax():
    """The int8 weights and the JAX leaves are equal, the folded kernel
    operands ``scale_q`` and ``bias_q`` are bit-equal to the JAX kernel
    route's ``input_scale * weight_scale / output_scale`` and ``bias /
    output_scale``, and the JAX state dict loads (its ``base.weight``
    placeholder skipped with a warning) and re-derives them."""
    jl, tl = _conv_pair(spconv_tpu.SubMConv3d, st.SubMConv3d, 8, 16, 3,
                        seed=7, bias=True, indice_key="s")
    sd = state_dict(jl)
    assert set(sd) - set(tl.state_dict()) == {"base.weight"}
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    want_s = np.asarray(jl.input_scale * jl.weight_scale / jl.output_scale)
    want_b = np.asarray(jl.bias / jl.output_scale)
    np.testing.assert_array_equal(tl.scale_q.numpy(), want_s)
    np.testing.assert_array_equal(tl.bias_q.numpy(), want_b)
    _, other = _conv_pair(spconv_tpu.SubMConv3d, st.SubMConv3d, 8, 16, 3,
                          seed=7, bias=True, indice_key="s")
    with torch.no_grad():
        other.weight_scale.mul_(2)
        other.refold()
    assert not torch.equal(other.scale_q, tl.scale_q)
    with pytest.warns(UserWarning, match="base.weight"):
        load_jax_state_dict(other, sd)
    np.testing.assert_array_equal(other.scale_q.numpy(), want_s)
    assert torch.equal(other.weight_kv,
                       TD.weight_krsc_to_kv(torch.from_numpy(
                           np.array(jl.weight_i8))))


def _int8_input(seed, c, n=300, nbuf=384, shape=SHAPE):
    _, inds = _sorted_input(seed, shape, n, c, nbuf)
    x = _int8(np.random.RandomState(seed), (nbuf, c), inds[:, 0] >= 0)
    return (st.SparseConvTensor(torch.from_numpy(x), torch.from_numpy(inds),
                                shape, 1, keys_sorted=True),
            spconv_tpu.SparseConvTensor(jnp.asarray(x), jnp.asarray(inds),
                                        shape, 1, keys_sorted=True))


def test_quantized_subm_pair_shares_stage_table():
    """Two int8 subm convs under one ``indice_key``: the second reuses the
    first one's match table (one table a stage), the residual rides the
    second's epilogue, and the result equals the JAX modules' on the
    active rows (the JAX package's CPU gather route; this input has no
    tie where its epilogue and the kernel route's differ)."""
    tx, jx = _int8_input(8, 8)
    j1, t1 = _conv_pair(spconv_tpu.SubMConv3d, st.SubMConv3d, 8, 8, 3,
                        seed=8, bias=True, indice_key="s")
    j2, t2 = _conv_pair(spconv_tpu.SubMConv3d, st.SubMConv3d, 8, 8, 3,
                        seed=9, bias=True, indice_key="s")
    with torch.no_grad():
        ty1 = t1(tx)
        ty2 = t2(ty1, add_input=tx, add_scale=0.05)
    rec = ty1.indice_dict["s"]
    assert isinstance(rec, st.DGData) and ty2.indice_dict["s"] is rec
    jy2 = j2(j1(jx), add_input=jx, add_scale=0.05)
    valid = tx.indices[:, 0].numpy() >= 0
    got = ty2.features.numpy()
    assert not got[~valid].any() and (got[valid] != 0).any()
    np.testing.assert_array_equal(got[valid],
                                  np.asarray(jy2.features)[valid])


def test_quantized_strided_and_inverse():
    """An int8 downsample writes the ``DGRegData`` record and the input
    indices under ``__dgreg__``/``__dgreg_in__<key>``; the paired int8
    inverse conv maps back onto the input sites through the record's
    divide table.  Both match the JAX modules on the active rows (its CPU
    route; no tie on this input)."""
    shape = (8, 10, 12)
    tx, jx = _int8_input(10, 4, n=150, nbuf=256, shape=shape)
    jd, td = _conv_pair(spconv_tpu.SparseConv3d, st.SparseConv3d, 4, 8, 3,
                        seed=10, stride=2, padding=1, indice_key="d0",
                        bias=True, out_bound=256)
    ji, ti = _conv_pair(spconv_tpu.SparseInverseConv3d,
                        st.SparseInverseConv3d, 8, 4, 3, seed=11,
                        indice_key="d0", bias=True)
    with torch.no_grad():
        ty = td(tx)
        rec = ty.indice_dict["__dgreg__d0"]
        assert rec.pos is not None and rec.pos_div is None
        assert ty.indice_dict["__dgreg_in__d0"] is tx.indices
        tz = ti(ty)
    assert rec.pos_div is not None
    jy = jd(jx)
    jz = ji(jy)
    np.testing.assert_array_equal(ty.indices.numpy(), np.asarray(jy.indices))
    valid = ty.indices[:, 0].numpy() >= 0
    np.testing.assert_array_equal(ty.features.numpy()[valid],
                                  np.asarray(jy.features)[valid])
    assert tz.spatial_shape == shape and tz.indices is tx.indices
    valid = tx.indices[:, 0].numpy() >= 0
    got = tz.features.numpy()
    assert not got[~valid].any() and (got[valid] != 0).any()
    np.testing.assert_array_equal(got[valid], np.asarray(jz.features)[valid])


def test_quantized_conv_refusals():
    """Float input and a strided residual still raise.  Input flagged as
    not key-sorted takes the native route: the same function as the
    kernel route on this (sorted) input, so bit-equal to it, and within
    one step on at most 1 % of entries of the JAX package's native route,
    whose epilogue rounds another way."""
    tx, jx = _int8_input(12, 4, n=60, nbuf=64)
    j, t = _conv_pair(spconv_tpu.SubMConv3d, st.SubMConv3d, 4, 4, 3,
                      seed=12, indice_key="s")
    _, td = _conv_pair(spconv_tpu.SparseConv3d, st.SparseConv3d, 4, 4, 3,
                       seed=13, stride=2, indice_key="d")
    with pytest.raises(TypeError, match="int8"):
        t(tx.replace_feature(tx.features.float()))
    unsorted = tx.replace_feature(tx.features)
    unsorted.keys_sorted = False
    jun = jx.replace_feature(jx.features)
    jun.keys_sorted = False
    with torch.no_grad():
        got, kernel_route = t(unsorted), t(tx)
    assert not got.keys_sorted
    assert isinstance(got.indice_dict["s"], st.IndiceData)
    assert torch.equal(got.features, kernel_route.features)
    diff = np.abs(got.features.numpy().astype(np.int32)
                  - np.asarray(j(jun).features, np.int32))
    print(f"unsorted int8 subm: {int((diff > 0).sum())} of {diff.size} "
          "entries differ from the JAX native route")
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    with pytest.raises(ValueError, match="subm-only"):
        td(tx, add_input=tx)
    conv = st.SubMConv3d(4, 4, 3, act_type="sigmoid", device="cpu")
    with pytest.raises(ValueError, match="relu"):
        tq.QuantizedSparseConv(conv, np.ones(4, np.float32), 0.1, 0.1)


def test_sequential_ptq_matches_jax():
    """``calibrate`` + ``convert_to_int8`` on a conv-BN-ReLU-conv-ReLU
    net: the observed scales match the JAX package's (f32 activations,
    summed in another order: 1e-6 relative), the int8 weights are equal,
    and the int8 net tracks the fused fp net as the JAX test requires
    (mean error < 0.1 of the mean output)."""
    rng = np.random.RandomState(14)
    jseq = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 16, 3, bias=False, indice_key="c1"),
        spconv_tpu.BatchNorm1d(16), spconv_tpu.SparseReLU(),
        spconv_tpu.SubMConv3d(16, 16, 3, bias=True, indice_key="c1"),
        spconv_tpu.SparseReLU())
    sd = state_dict(jseq)
    sd.update({f"layers.1.{k}": v for k, v in _seeded_bn(rng, 16).items()})
    jseq = load_state_dict(jseq, sd)
    tseq = st.SparseSequential(
        st.SubMConv3d(4, 16, 3, bias=False, indice_key="c1", device="cpu"),
        st.BatchNorm1d(16, device="cpu").eval(), st.SparseReLU(),
        st.SubMConv3d(16, 16, 3, bias=True, indice_key="c1", device="cpu"),
        st.SparseReLU())
    load_jax_state_dict(tseq, {k.replace("layers.", ""): v
                               for k, v in sd.items()})
    calib = [_sorted_input(s, SHAPE, 200, 4, 256) for s in range(2)]
    jfused, jobs = jq.calibrate(jseq, [spconv_tpu.SparseConvTensor(
        jnp.asarray(f), jnp.asarray(i), SHAPE, 1, keys_sorted=True)
        for f, i in calib])
    tx = [st.SparseConvTensor(torch.from_numpy(f), torch.from_numpy(i),
                              SHAPE, 1, keys_sorted=True) for f, i in calib]
    tfused, tobs = tq.calibrate(tseq, tx)
    assert len(tobs) == len(jobs) == 4
    for a, b in zip(tobs, jobs):
        assert abs(a.scale - b.scale) <= 1e-6 * b.scale
    tnet = tq.convert_to_int8(tfused, tobs)
    jnet = jq.convert_to_int8(jfused, jobs)
    kinds = [type(m).__name__ for m in tnet.children()]
    assert kinds == ["QuantizedSparseConv", "QuantizedSparseConv",
                     "SparseReLU"]
    for t, j in zip(list(tnet.children())[:2], jnet.layers[:2]):
        np.testing.assert_array_equal(t.weight_i8.numpy(),
                                      np.asarray(j.weight_i8))
    with torch.no_grad():
        want = tfused(tx[0]).features.numpy()
        got_q = tnet(tx[0].replace_feature(
            tq.quantize_tensor(tx[0].features, tobs[0].scale)))
    got = tq.dequantize(got_q.features,
                        list(tnet.children())[1].output_scale).numpy()
    valid = tx[0].indices[:, 0].numpy() >= 0
    rel = (np.abs(got - want)[valid].mean()
           / (np.abs(want[valid]).mean() + 1e-6))
    assert rel < 0.1, rel
