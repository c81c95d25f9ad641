"""Quantization-aware training in the port (``quantization.qat``,
``BatchNorm1d.updated``) against the JAX package on the CPU: fake
quantization and its straight-through gradient, the running-stat update,
the fused QAT conv's forward and gradients, the observation pass, the
whole-net rewrite, the conversion to int8 and its output, the strict
state-dict loads of whole JAX nets, and the three ADVICE r5 behaviours the
port keeps as the JAX package has them (ROADMAP.md queue C).

A fake-quantized output rounds ``y / s``: where the two libraries sum a
conv in another order, a value next to a rounding boundary can land one
step ``s`` apart.  Such outputs are compared entry by entry: within
``TOL`` of max|ref|, except at most ``FLIP_SHARE`` of the entries, each
within one step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
import spconv_tpu.quantization as jq
from spconv_tpu.checkpoint import load_state_dict, state_dict

import spconv_tpu_torch as st
import spconv_tpu_torch.quantization as tq
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.examples.mnist_sparse import make_batch
from spconv_tpu_torch.modules import conv as conv_mod

TOL = 1e-5        # f32 sums in another order, of max|ref|
GRAD_TOL = 5e-5   # ROADMAP.md's grad tolerance, of max|ref| per tensor
STAT_RTOL = 1e-5  # scales and running statistics, relative
FLIP_SHARE = 0.01
# the int8 net's dequantized output against the QAT net's own forward, in
# output steps (the last layer's act_scale): the JAX pair measured 0 steps
# on every entry (seeds 0-5 of this file's MNIST flow); a tie rounded the
# other way moves an entry by one step
QAT_INT8_STEPS = 1
QAT_INT8_SHARE = 0.01


def _jax_tensor(x):
    return spconv_tpu.SparseConvTensor(
        jnp.asarray(x.features.detach().numpy()),
        jnp.asarray(x.indices.numpy()), x.spatial_shape, x.batch_size,
        keys_sorted=True)


def _batch(seed, c=1):
    """An MNIST-flow batch (8 images, 2,048 rows, ~50 % padding) with
    ``c`` features (the first the image's, the rest seeded in [-1, 1])."""
    rng = np.random.RandomState(seed)
    x, _ = make_batch(rng, device="cpu")
    if c > 1:
        extra = torch.from_numpy(rng.uniform(
            -1, 1, (x.features.shape[0], c - 1)).astype(np.float32))
        x = x.replace_feature_masked(torch.cat([x.features, extra], 1))
    return x, _jax_tensor(x)


def _close_or_step(got, ref, step, what):
    """``got`` within TOL of max|ref| of ``ref``, except at most
    FLIP_SHARE of the entries, each within one ``step``."""
    got, ref = np.asarray(got), np.asarray(ref)
    d = np.abs(got - ref)
    off = d > TOL * max(np.abs(ref).max(), 1e-30)
    assert off.mean() <= FLIP_SHARE, f"{what}: {off.mean():.4f} off"
    assert (d[off] <= step * (1 + 1e-5)).all(), f"{what}: {d.max()}"


def _seeded_bn(rng, c):
    return dict(weight=rng.uniform(0.5, 2, c).astype(np.float32),
                bias=(0.3 * rng.randn(c)).astype(np.float32),
                running_mean=(0.3 * rng.randn(c)).astype(np.float32),
                running_var=rng.uniform(0.5, 2, c).astype(np.float32))


def _jax_float_net(seed, bn_seed=None, c_in=1, widths=(32, 64),
                   down_key=None):
    """``examples/mnist_qat.py``'s float encoder at ``widths`` (conv, BN,
    ReLU, strided conv, BN, ReLU), its BN state seeded from ``bn_seed``
    when given."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    net = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv2d(c_in, widths[0], 3, indice_key="s1",
                              bias=False, key=ks[0]),
        spconv_tpu.BatchNorm1d(widths[0]), spconv_tpu.SparseReLU(),
        spconv_tpu.SparseConv2d(widths[0], widths[1], 3, stride=2,
                                padding=1, bias=False, indice_key=down_key,
                                key=ks[1]),
        spconv_tpu.BatchNorm1d(widths[1]), spconv_tpu.SparseReLU())
    if bn_seed is None:
        return net
    rng = np.random.RandomState(bn_seed)
    sd = state_dict(net)
    for i, c in ((1, widths[0]), (4, widths[1])):
        sd.update({f"layers.{i}.{k}": v
                   for k, v in _seeded_bn(rng, c).items()})
    return load_state_dict(net, sd)


def _port_float_net(c_in=1, widths=(32, 64), down_key=None):
    return st.SparseSequential(
        st.SubMConv2d(c_in, widths[0], 3, indice_key="s1", bias=False,
                      device="cpu"),
        st.BatchNorm1d(widths[0], device="cpu"), st.SparseReLU(),
        st.SparseConv2d(widths[0], widths[1], 3, stride=2, padding=1,
                        bias=False, indice_key=down_key, device="cpu"),
        st.BatchNorm1d(widths[1], device="cpu"), st.SparseReLU())


# ---------------------------------------------------------------------------
# fake quantization


@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_matches_jax(per_channel):
    """Values bit-equal to the JAX function's, ties at .5 rounded half to
    even, clipped at +-127 steps, the scale floored at 1e-8; the gradient
    passes straight through to ``x`` (equal to ``jax.grad``'s) and none
    reaches the scale."""
    rng = np.random.RandomState(0)
    if per_channel:
        x = rng.randn(4, 3, 3, 5).astype(np.float32) * 0.3
        scale = np.array([0.25, 0.01, 2 ** -6, 0.0], np.float32)
        # ties: k + 0.5 steps of channel 0 and 2 (powers of two, exact)
        x[0, 0, 0, :4] = np.array([0.5, 1.5, -0.5, -2.5]) * 0.25
        x[2, 1, 1, :3] = np.array([2.5, -3.5, 0.5]) * 2 ** -6
        x[1, 2, 2, 0] = 50.0  # clipped
        fq_t = lambda a, s: tq.fake_quant_per_channel(a, s)
        fq_j = lambda a, s: jq.fake_quant_per_channel(a, s)
    else:
        x = rng.randn(64, 6).astype(np.float32)
        x[0, :6] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5]) * 0.125
        x[1, 0] = -40.0  # clipped
        scale = np.float32(0.125)
        fq_t, fq_j = tq.fake_quant, jq.fake_quant
    g = rng.randn(*x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    st_ = torch.tensor(scale, requires_grad=True)
    got = fq_t(xt, st_)
    (got * torch.from_numpy(g)).sum().backward()
    want = fq_j(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gx, gs = jax.grad(lambda a, s: jnp.sum(fq_j(a, s) * g), (0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx))
    assert not np.asarray(gs).any()
    assert st_.grad is None or not st_.grad.any()
    if not per_channel:
        np.testing.assert_array_equal(
            got.detach().numpy()[0], np.array([0, 2, 2, 0, -2, 126])
            * 0.125)
        assert float(got.detach()[1, 0]) == -127 * 0.125


# ---------------------------------------------------------------------------
# BatchNorm1d.updated


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_updated_matches_jax(dtype):
    """Three ``updated`` calls on tensors with padding rows (features in
    ``dtype``, statistics in f32) advance the running mean and unbiased
    variance as the JAX ``updated`` does, within STAT_RTOL; ``updated``
    works in place and returns the module; ``forward`` in training mode
    leaves the running statistics as they were."""
    tbn = st.BatchNorm1d(6, momentum=0.2, device="cpu")
    jbn = spconv_tpu.BatchNorm1d(6, momentum=0.2)
    for seed in range(3):
        x, _ = _batch(seed, c=6)
        x = x.replace_feature(x.features * (seed + 1) + seed)
        x = x.replace_feature_masked(x.features.to(getattr(torch, dtype)))
        jx = spconv_tpu.SparseConvTensor(
            jnp.asarray(x.features.float().numpy()).astype(dtype),
            jnp.asarray(x.indices.numpy()), x.spatial_shape, x.batch_size)
        before = tbn.running_mean.clone()
        tbn.train()(x)
        assert torch.equal(tbn.running_mean, before)
        assert tbn.updated(x) is tbn
        jbn = jbn.updated(jx)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tbn, name).numpy(),
                                   np.asarray(getattr(jbn, name)),
                                   rtol=STAT_RTOL, atol=1e-7, err_msg=name)
    assert tbn.running_mean.abs().min() > 0.05


# ---------------------------------------------------------------------------
# the QAT conv


QAT_CASES = [(True, True, True), (True, False, True), (False, True, True),
             (False, False, True), (True, True, False)]


@pytest.mark.parametrize("bn,relu,subm", QAT_CASES)
def test_qat_conv_matches_jax(bn, relu, subm):
    """``QATConvBnReLU`` (subm, or the strided conv) with seeded BN state
    and observed scales: the output as the JAX module's (``_close_or_step``
    at ``act_scale``), and the gradients of ``sum(out * g)`` for the conv
    weight and BN's ``weight`` and ``bias`` (through the fold) within
    GRAD_TOL of ``jax.grad``'s; the state dict loads strictly.  Its
    output does not depend on the module's mode (BN-frozen)."""
    rng = np.random.RandomState(7)
    x, jx = _batch(1, c=4)
    if subm:
        jconv = spconv_tpu.SubMConv2d(4, 8, 3, indice_key="s1",
                                      bias=not bn, key=jax.random.PRNGKey(2))
        tconv = st.SubMConv2d(4, 8, 3, indice_key="s1", bias=not bn,
                              device="cpu")
    else:
        jconv = spconv_tpu.SparseConv2d(4, 8, 3, stride=2, padding=1,
                                        bias=not bn,
                                        key=jax.random.PRNGKey(2))
        tconv = st.SparseConv2d(4, 8, 3, stride=2, padding=1, bias=not bn,
                                device="cpu")
    jbn = spconv_tpu.BatchNorm1d(8) if bn else None
    tbn = st.BatchNorm1d(8, device="cpu") if bn else None
    jm = jq.QATConvBnReLU(jconv, jbn, relu=relu)
    tm = tq.QATConvBnReLU(tconv, tbn, relu=relu)
    sd = state_dict(jm)
    if bn:
        sd.update({f"bn.{k}": v for k, v in _seeded_bn(rng, 8).items()})
    jm = load_state_dict(jm, sd)
    jm = jm.observe(jx)
    sd = state_dict(jm)
    load_jax_state_dict(tm, sd)
    assert set(tm.state_dict()) == set(sd)
    g = rng.randn(4096 if not subm else 2048, 8).astype(np.float32)

    def loss_j(m, t):
        out = m(t, training=True)
        return jnp.sum(out.features * g[:out.features.shape[0]]), out

    (lj, jout), jgrads = spconv_tpu.filter_value_and_grad(
        loss_j, has_aux=True)(jm, jx)
    out = tm.train()(x)
    (out.features * torch.from_numpy(g[:out.features.shape[0]])).sum() \
        .backward()
    step = float(tm.act_scale)
    _close_or_step(out.features.detach().numpy(), jout.features, step,
                   "output")
    assert not out.features[~out.valid_mask].any()
    with torch.no_grad():
        assert torch.equal(tm.eval()(x).features, out.features)
    ref_g = state_dict(jgrads)
    names = [n for n, _ in tm.named_parameters()]
    assert names == (["conv.weight", "bn.weight", "bn.bias"] if bn
                     else ["conv.weight", "conv.bias"])
    for name, p in tm.named_parameters():
        ref = ref_g[name]
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the whole-net flow


def _prepared_pair(seed=0, down_key=None, observe=0):
    """The MNIST QAT net, prepared in both packages from the same seeded
    float net, the port's loaded strictly from the JAX prepared net's
    state dict (keys ``layers.<i>.`` as the JAX container has them), then
    ``observe`` batches observed by the JAX net only."""
    jnet = jq.prepare_qat(_jax_float_net(seed, bn_seed=seed + 1,
                                         down_key=down_key))
    for s in range(observe):
        jnet, _ = jq.qat_observe(jnet, _batch(50 + s)[1])
    tnet = tq.prepare_qat(_port_float_net(down_key=down_key))
    load_jax_state_dict(tnet, state_dict(jnet))
    return jnet, tnet


def _qat_modules(net):
    layers = net.layers if hasattr(net, "layers") else list(net)
    return [m for m in layers if isinstance(m, (jq.QATConvBnReLU,
                                                tq.QATConvBnReLU))]


def test_qat_observe_matches_jax():
    """Two ``qat_observe`` passes: the stub's input scale, every QAT
    module's ``act_scale`` and ``w_scale`` and its BN running statistics
    within STAT_RTOL of the JAX pass's (which returns new modules), and
    the output as the JAX output (``_close_or_step``).  The port's pass
    works in place and returns ``(net, output)``; the output needs no
    gradient."""
    jnet, tnet = _prepared_pair(0)
    for seed in (3, 4):
        x, jx = _batch(seed)
        jnet, jout = jq.qat_observe(jnet, jx)
        net, out = tq.qat_observe(tnet, x)
        assert net is tnet and not out.features.requires_grad
        np.testing.assert_allclose(float(tnet[0].scale),
                                   float(jnet.layers[0].scale),
                                   rtol=STAT_RTOL)
        for t, j in zip(_qat_modules(tnet), _qat_modules(jnet)):
            for name in ("act_scale", "w_scale"):
                np.testing.assert_allclose(
                    getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                    rtol=STAT_RTOL, err_msg=name)
            for name in ("running_mean", "running_var"):
                np.testing.assert_allclose(
                    getattr(t.bn, name).numpy(),
                    np.asarray(getattr(j.bn, name)), rtol=STAT_RTOL,
                    atol=1e-7, err_msg=name)
        _close_or_step(out.features.numpy(), jout.features,
                       float(_qat_modules(tnet)[-1].act_scale), "output")


@pytest.mark.parametrize("down_key", [None, "d1"])
def test_observe_reuses_match_tables(monkeypatch, down_key):
    """One observe pass calls each BN-absorbing QAT conv twice on one
    input (the float conv for BN's statistics, then the QAT conv); the
    second call reuses the first one's records: one subm match table, and
    with a keyed downsample one output discovery.  A downsample without
    ``indice_key`` keeps no record (as in the JAX package) and discovers
    its outputs twice."""
    counts = dict(pos=0, discover=0)

    def counted(fn, key):
        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(conv_mod, "build_dg_pos",
                        counted(conv_mod.build_dg_pos, "pos"))
    monkeypatch.setattr(conv_mod, "build_conv_outputs",
                        counted(conv_mod.build_conv_outputs, "discover"))
    _, tnet = _prepared_pair(0, down_key=down_key)
    tq.qat_observe(tnet, _batch(3)[0])
    assert counts == dict(pos=1, discover=1 if down_key else 2)


def test_prepare_qat_structure():
    """``prepare_qat`` gives the JAX function's structure: a leading
    ``QATQuantStub``, then one ``QATConvBnReLU`` per conv -> BN -> ReLU
    chain (BN and ReLU absorbed), other layers as they are; initial
    scales 0.05.  The prepared net holds copies: observing and training it
    leaves the float net as it was."""
    jfloat = _jax_float_net(0)
    tfloat = _port_float_net()
    extra = dict(j=spconv_tpu.SparseIdentity(), t=st.SparseIdentity())
    jnet = jq.prepare_qat(spconv_tpu.SparseSequential(
        *jfloat.layers, extra["j"]))
    tnet = tq.prepare_qat(st.SparseSequential(*tfloat, extra["t"]))
    kinds = [type(m).__name__ for m in tnet]
    assert kinds == [type(m).__name__ for m in jnet.layers] == [
        "QATQuantStub", "QATConvBnReLU", "QATConvBnReLU", "SparseIdentity"]
    for t, j in zip(_qat_modules(tnet), _qat_modules(jnet)):
        assert t.relu == j.relu is True
        assert type(t.bn).__name__ == type(j.bn).__name__ == "BatchNorm1d"
        assert type(t.conv).__name__ == type(j.conv).__name__
        assert torch.equal(t.w_scale, torch.full_like(t.w_scale, 0.05))
        assert float(t.act_scale) == float(np.float32(0.05))
    assert float(tnet[0].scale) == float(np.float32(0.05))
    before = {k: v.clone() for k, v in tfloat.state_dict().items()}
    tq.qat_observe(tnet, _batch(3)[0])
    assert all(torch.equal(v, before[k])
               for k, v in tfloat.state_dict().items())
    assert tnet[1].conv is not tfloat[0]


def _int8_pair(seed=0, observe=4):
    """The observed MNIST QAT net in both packages (the port's loaded from
    the JAX one) and each converted to int8."""
    jnet, tnet = _prepared_pair(seed, observe=observe)
    return jnet, tnet, jq.convert_qat(jnet), tq.convert_qat(tnet)


def test_convert_qat_matches_jax():
    """``convert_qat``'s scale chain equals the JAX one's (input scale =
    the stub's, each conv from its predecessor's ``act_scale``, output =
    the last one's), the int8 weights and folded biases are the JAX
    ones', and ``QuantizedSequential`` sets and clears ``q_scale``.  Its
    dequantized output is within the int8 bound of the JAX int8 net's
    (whose CPU route rounds the requantization differently at a tie:
    2 steps on at most 1 % of the entries, as
    ``tests/test_torch_quant_encoder.py``) and within QAT_INT8_STEPS on at
    most QAT_INT8_SHARE of the entries of the QAT net's own forward, the
    bound the JAX pair meets (measured here too)."""
    jnet, tnet, j8, t8 = _int8_pair(0)
    assert isinstance(t8, tq.QuantizedSequential)
    jmods = _qat_modules(jnet)
    assert t8.input_scale == j8.input_scale == float(jnet.layers[0].scale)
    assert t8.out_scale == j8.out_scale == float(jmods[-1].act_scale)
    scales_in = [j8.input_scale, float(jmods[0].act_scale)]
    for t, j, s_in, m in zip(t8.layers, j8.layers, scales_in, jmods):
        assert isinstance(t, tq.QuantizedSparseConv)
        assert t.input_scale == j.input_scale == s_in
        assert t.output_scale == j.output_scale == float(m.act_scale)
        assert t.act_type == j.act_type == "relu"
        np.testing.assert_array_equal(t.weight_i8.numpy(),
                                      np.asarray(j.weight_i8))
        np.testing.assert_array_equal(t.weight_scale.numpy(),
                                      np.asarray(j.weight_scale))
        np.testing.assert_allclose(t.bias.numpy(), np.asarray(j.bias),
                                   rtol=1e-6, atol=1e-7)
    seen = []
    t8.layers[0].register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].q_scale))
    x, jx = _batch(9)
    with torch.no_grad():
        out = t8(x)
        qat_out = tnet(x)
    assert out.q_scale is None and float(seen[0]) == t8.input_scale
    step = t8.out_scale
    jout = np.asarray(j8(jx).features)
    jqat = np.asarray(jnet(jx, training=True).features)
    valid = out.valid_mask.numpy()
    for got, ref, bound, share in (
            (out.features.numpy(), jout, 2, 0.01),
            (out.features.numpy(), qat_out.features.numpy(), QAT_INT8_STEPS,
             QAT_INT8_SHARE),
            (jout, jqat, QAT_INT8_STEPS, QAT_INT8_SHARE)):
        steps = np.abs(got - ref)[valid] / step
        assert steps.max() <= bound + 1e-3
        assert (steps > 0.5).mean() <= share
    assert not out.features[~out.valid_mask].any()
    assert np.abs(jout).max() > 0


def test_load_jax_sequential_strictly():
    """A JAX ``SparseSequential`` state dict (``layers.<i>.`` keys: a QAT
    net, and a float net with a named layer) and a JAX
    ``QuantizedSequential`` one load strictly into the port's nets as they
    are: no key renamed by hand, every tensor equal; a key truly missing
    or extra still raises."""
    jnet, tnet, j8, t8 = _int8_pair(1, observe=2)
    sd = state_dict(jnet)
    assert all(k.startswith("layers.") for k in sd)
    fresh = tq.prepare_qat(_port_float_net())
    load_jax_state_dict(fresh, sd)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd["layers." + k],
                                      err_msg=k)
    sd8 = state_dict(j8)
    assert any(k.endswith("base.weight") for k in sd8)
    fresh8 = tq.convert_qat(tq.prepare_qat(_port_float_net()))
    with pytest.warns(UserWarning, match="placeholder"):
        load_jax_state_dict(fresh8, sd8)
    for k, v in fresh8.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd8[k], err_msg=k)
    named_j = spconv_tpu.SparseSequential(spconv_tpu.SparseReLU(),
                                          head=spconv_tpu.BatchNorm1d(3))
    named_t = st.SparseSequential(st.SparseReLU(),
                                  head=st.BatchNorm1d(3, device="cpu"))
    load_jax_state_dict(named_t, state_dict(named_j))
    assert list(named_t.state_dict()) == [
        "head.weight", "head.bias", "head.running_mean", "head.running_var"]
    bad = dict(sd)
    bad.pop("layers.1.w_scale")
    with pytest.raises(KeyError, match="missing"):
        load_jax_state_dict(fresh, bad)
    bad = dict(sd, **{"layers.7.w_scale": sd["layers.1.w_scale"]})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state_dict(fresh, bad)


# ---------------------------------------------------------------------------
# the ADVICE r5 behaviours, kept as the JAX package has them


def test_convert_qat_passes_other_layers_through():
    """ADVICE r5 (``qat.py:267``): a layer that is not a QAT module goes
    into the int8 net as it is, and the scale chain runs past it as if it
    kept the scale: here a bare ``BatchNorm1d`` between the convs, which
    then normalizes int8 values in both packages."""
    jfloat = _jax_float_net(0, bn_seed=1)
    layers = list(jfloat.layers)
    jmid = spconv_tpu.BatchNorm1d(32)
    jnet = jq.prepare_qat(spconv_tpu.SparseSequential(
        *layers[:3], jmid, *layers[3:]))
    tnet = tq.prepare_qat(st.SparseSequential(
        *list(_port_float_net())[:3], st.BatchNorm1d(32, device="cpu"),
        *list(_port_float_net())[3:]))
    load_jax_state_dict(tnet, state_dict(jnet))
    x, jx = _batch(2)
    jnet, _ = jq.qat_observe(jnet, jx)
    tq.qat_observe(tnet, x)
    j8, t8 = jq.convert_qat(jnet), tq.convert_qat(tnet)
    assert [type(m).__name__ for m in t8.layers] == [
        type(m).__name__ for m in j8.layers] == [
        "QuantizedSparseConv", "BatchNorm1d", "QuantizedSparseConv"]
    assert t8.layers[1] is tnet[2]
    first = _qat_modules(tnet)[0]
    assert t8.layers[2].input_scale == float(first.act_scale)
    assert j8.layers[2].input_scale == float(_qat_modules(jnet)[0].act_scale)


def test_qat_fold_uses_running_stats_only():
    """ADVICE r5 (``qat.py:51``): the fold takes BN's running statistics
    in training mode too (BN-frozen QAT), in both packages: the output
    with the batch statistics far from the running ones equals a conv run
    with the running-stat fold done by hand, and equals the JAX output."""
    rng = np.random.RandomState(5)
    x, jx = _batch(6, c=4)
    jm = jq.QATConvBnReLU(spconv_tpu.SubMConv2d(
        4, 8, 3, indice_key="s1", bias=False, key=jax.random.PRNGKey(11)),
        spconv_tpu.BatchNorm1d(8))
    sd = state_dict(jm)
    sd.update({f"bn.{k}": v for k, v in _seeded_bn(rng, 8).items()})
    sd["bn.running_mean"] = sd["bn.running_mean"] - 1.0
    jm = load_state_dict(jm, sd).observe(jx)
    sd = state_dict(jm)
    tm = load_jax_state_dict(tq.QATConvBnReLU(
        st.SubMConv2d(4, 8, 3, indice_key="s1", bias=False, device="cpu"),
        st.BatchNorm1d(8, device="cpu")), sd).train()
    with torch.no_grad():
        out = tm(x).features
        w, b = tm.folded_weight_bias()
        conv = st.SubMConv2d(4, 8, 3, indice_key="s1", device="cpu")
        conv.weight.copy_(tq.fake_quant_per_channel(w, tm.w_scale))
        conv.bias.copy_(b)
        ref = tq.fake_quant(torch.relu(conv(x).features), tm.act_scale)
        ref = torch.where(x.valid_mask[:, None], ref, 0.0)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert (out[x.valid_mask] > 0).float().mean() > 0.2
    batch_mean = tm.conv(x).features[x.valid_mask].mean(0)
    assert (batch_mean - tm.bn.running_mean).abs().min() > 0.4
    _close_or_step(out.numpy(), jm(jx, training=True).features,
                   float(tm.act_scale), "output")


def test_qat_observe_keeps_bare_bn_stats():
    """ADVICE r5 (``qat.py:217``): ``qat_observe`` runs a bare
    ``BatchNorm1d`` (one that no QAT module absorbed) with its batch
    statistics but does not advance its running statistics, in both
    packages; its mode is restored after the pass."""
    jnet = jq.prepare_qat(spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv2d(1, 8, 3, indice_key="s1", bias=False,
                              key=jax.random.PRNGKey(4)),
        spconv_tpu.SparseReLU(), spconv_tpu.BatchNorm1d(8)))
    tnet = tq.prepare_qat(st.SparseSequential(
        st.SubMConv2d(1, 8, 3, indice_key="s1", bias=False, device="cpu"),
        st.SparseReLU(), st.BatchNorm1d(8, device="cpu")))
    assert [type(m).__name__ for m in tnet] == [
        "QATQuantStub", "QATConvBnReLU", "BatchNorm1d"]
    load_jax_state_dict(tnet, state_dict(jnet))
    tnet.eval()
    x, jx = _batch(4)
    jnet, jout = jq.qat_observe(jnet, jx)
    _, out = tq.qat_observe(tnet, x)
    bare_j, bare_t = jnet.layers[2], tnet[2]
    assert not tnet[2].training
    np.testing.assert_array_equal(np.asarray(bare_j.running_mean), 0.0)
    np.testing.assert_array_equal(np.asarray(bare_j.running_var), 1.0)
    assert not bare_t.running_mean.any() and (bare_t.running_var == 1).all()
    feats = out.features[out.valid_mask]
    assert abs(float(feats.mean())) < 1e-4  # batch statistics, not (0, 1)
    ref = np.asarray(jout.features)
    np.testing.assert_allclose(out.features.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
