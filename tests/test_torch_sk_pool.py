"""The sorted-key pool (B6's plain version, its backward and the modules on
both pool routes) against the JAX package on the CPU.

The JAX sorted-key pool runs its Pallas kernel in interpret mode (each call
compiles: a few seconds), so the cases here are few and small.  Max picks
an input value, so it is exact; a mean sums in f32 in child order on both
sides, within 1e-6*max|ref| in f32 and one bf16 rounding in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas import sorted_pool as SP
from spconv_tpu.ops.pool import indice_avgpool, indice_maxpool
from spconv_tpu.ops.rulebook import build_pool2_outputs as jax_pool2_outputs
from spconv_tpu.ops.rulebook import build_pool2_rulebook

import spconv_tpu_torch as st
from spconv_tpu_torch import constants
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import sorted_pool as TS
from spconv_tpu_torch.ops.pool import global_pool
from spconv_tpu_torch.ops.rulebook import build_pool2_outputs

from utils import generate_sparse_data

F32_MEAN_TOL = 1e-6  # of max|ref|: f32 sums of up to 2**ndim children
GRAD_TOL = 1e-6      # of max|ref|: one f32 division at most
NET_FWD_TOL = 1e-5   # the whole-slice net, f32, of max|ref|
NET_GRAD_TOL = 5e-5  # its grads, f32, of max|ref| per tensor


def _sorted_input(seed, shape, n, c, nbuf, batch=1, grid=False):
    """Key-sorted rows padded to ``nbuf`` with invalid rows; ``grid`` puts
    the features on a grid of 0.5, so that children tie."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n, c, batch_size=batch,
                                       rng=rng)
    if grid:
        feats = np.round(feats * 2) / 2
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, len(shape) + 1), -1, np.int32)
    fb[:len(order)] = feats[order]
    ib[:len(order)] = inds[order]
    return fb, ib


def _out_shape(shape):
    return tuple(s // 2 for s in shape)


def _port_keys(inds, shape, batch, bound):
    ti = torch.from_numpy(inds)
    _, out_keys, _, _ = build_pool2_outputs(ti, spatial_shape=shape,
                                            batch_size=batch, out_bound=bound)
    in_keys, _ = TC.linearize(ti, shape, batch)
    return in_keys, out_keys


def _port_sk(feats, inds, shape, batch, bound, mode):
    """The port's ``SKPool2Fn`` on the case's keys: ``(out, input)``."""
    in_keys, out_keys = _port_keys(inds, shape, batch, bound)
    x = torch.from_numpy(feats).requires_grad_()
    out = TS.SKPool2Fn.apply(x, in_keys, out_keys,
                             (shape, _out_shape(shape), batch, mode))
    return out, x


def _jax_sk(feats, inds, shape, batch, bound, mode):
    """``f(features)`` of the JAX ``sk_pool2_ad`` in interpret mode."""
    ji = jnp.asarray(inds)
    _, out_keys, _, _ = jax_pool2_outputs(ji, spatial_shape=shape,
                                          batch_size=batch, out_bound=bound)
    in_keys, _ = JC.linearize(ji, shape, batch)
    geom = (tuple(shape), _out_shape(shape), batch, mode, 128, 512, True,
            True)
    return lambda f: SP.sk_pool2_ad(f, in_keys, out_keys, ji, geom)


@pytest.mark.parametrize("shape,batch,bound", [
    ((9, 21), 2, 256), ((9, 21, 17), 2, 512), ((5, 7, 6, 9), 1, 512)])
def test_pool2_child_keys_match_jax(shape, batch, bound):
    """The child keys of every parent equal the JAX ``pool2_row_probes``
    where it marks them valid and are -1 elsewhere (odd edges, sentinel
    parents); the output discovery matches too."""
    _, inds = _sorted_input(0, shape, 300, 1, 640, batch)
    ti, ji = torch.from_numpy(inds), jnp.asarray(inds)
    got = build_pool2_outputs(ti, spatial_shape=shape, batch_size=batch,
                              out_bound=bound)
    ref = jax_pool2_outputs(ji, spatial_shape=shape, batch_size=batch,
                            out_bound=bound)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    out_shape = _out_shape(shape)
    probes = TS.pool2_child_keys(got[1], in_shape=shape, out_shape=out_shape,
                                 batch_size=batch)
    sent_out = int(np.prod(out_shape)) * batch
    jp, jv = SP.pool2_row_probes(ref[1], out_shape, shape, sent_out)
    want = np.where(np.asarray(jv), np.asarray(jp), -1)
    assert probes.dtype == torch.int32
    assert tuple(probes.shape) == (2 ** len(shape), bound)
    np.testing.assert_array_equal(probes.numpy(), want)
    np.testing.assert_array_equal(TS.pool_offsets(len(shape)),
                                  SP._pool_offsets(len(shape)))


# (shape, batch, n, c, nbuf, bound, mode, dtype)
_CASES = {
    "3d-max": ((9, 21, 17), 2, 700, 6, 1536, 1024, "max", "float32"),
    "3d-mean": ((9, 21, 17), 2, 700, 6, 1536, 1024, "mean", "float32"),
    "3d-mean-bf16": ((9, 21, 17), 2, 700, 6, 1536, 1024, "mean", "bfloat16"),
    "2d-max": ((13, 21), 1, 150, 5, 256, 256, "max", "float32"),
    "4d-max": ((5, 7, 6, 9), 1, 600, 4, 640, 512, "max", "float32"),
    # a bound below the output count: the smallest parent keys are kept
    "3d-max-cut": ((9, 21, 17), 2, 700, 6, 1536, 128, "max", "float32"),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_sk_pool2_matches_jax(name):
    """``sk_pool2`` (B6's plain version on the CPU) against the JAX
    ``sk_pool2_ad`` (the Pallas kernel in interpret mode)."""
    shape, batch, n, c, nbuf, bound, mode, dtype = _CASES[name]
    feats, inds = _sorted_input(1, shape, n, c, nbuf, batch)
    tdt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    in_keys, out_keys = _port_keys(inds, shape, batch, bound)
    got = TS.sk_pool2(torch.from_numpy(feats).to(tdt), in_keys, out_keys,
                      in_shape=shape, out_shape=_out_shape(shape),
                      batch_size=batch, mode=mode)
    assert got.dtype == tdt and tuple(got.shape) == (bound, c)
    ref = np.asarray(_jax_sk(feats, inds, shape, batch, bound, mode)(
        jnp.asarray(feats, jdt)).astype(jnp.float32))
    got = got.float().numpy()
    live = out_keys.numpy() != int(np.prod(_out_shape(shape))) * batch
    assert live.any() and not got[~live].any()
    if mode == "max":
        np.testing.assert_array_equal(got, ref)
    elif dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=F32_MEAN_TOL * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2**-7, atol=0)
    if name == "3d-max-cut":
        _, _, n_out, n_tot = build_pool2_outputs(
            torch.from_numpy(inds), spatial_shape=shape, batch_size=batch,
            out_bound=bound)
        assert int(n_tot) > int(n_out) == bound


@pytest.mark.parametrize("mode", ["max", "mean"])
def test_sk_pool2_nonfinite_follows_the_rulebook_route(mode):
    """NaN and +-inf features.  Per parent, a max that is not finite is 0
    and a mean keeps its NaN or inf: the JAX package's definition of the
    function, which its rulebook fallback (``indice_maxpool`` /
    ``indice_avgpool`` over ``build_pool2_rulebook``) computes.  The
    Pallas kernel gathers with one-hot products, so on the TPU one
    non-finite feature turns the channel of every parent in its tile to NaN
    (0 * NaN): where its window holds none, the kernel and the port agree
    exactly."""
    shape, batch, bound = (9, 21, 17), 1, 512
    feats, inds = _sorted_input(2, shape, 400, 4, 512)
    feats[5, 1], feats[50, 2], feats[80, 3] = np.nan, np.inf, -np.inf
    in_keys, out_keys = _port_keys(inds, shape, batch, bound)
    got = TS.sk_pool2(torch.from_numpy(feats), in_keys, out_keys,
                      in_shape=shape, out_shape=_out_shape(shape),
                      batch_size=batch, mode=mode).numpy()
    data = build_pool2_rulebook(jnp.asarray(inds), spatial_shape=shape,
                                batch_size=batch, out_bound=bound)
    pool = indice_maxpool if mode == "max" else indice_avgpool
    ref = np.asarray(pool(jnp.asarray(feats), data.pair_fwd))
    if mode == "max":
        np.testing.assert_array_equal(got, ref)
        assert np.isfinite(got).all()
    else:
        np.testing.assert_allclose(got, ref, rtol=0, equal_nan=True,
                                   atol=F32_MEAN_TOL
                                   * np.abs(ref[np.isfinite(ref)]).max())
        assert np.isnan(got[:, 1]).sum() == 1
        assert np.isinf(got[:, 2:]).sum() == 2
    kern = np.asarray(_jax_sk(feats, inds, shape, batch, bound, mode)(
        jnp.asarray(feats)))
    np.testing.assert_allclose(got[:, 0], kern[:, 0], rtol=0,
                               atol=F32_MEAN_TOL * np.abs(kern[:, 0]).max())


@pytest.mark.parametrize("mode", ["max", "mean"])
def test_sk_pool2_grad_matches_jax(mode):
    """``SKPool2Fn``'s backward against ``jax.grad`` through the JAX
    ``sk_pool2_ad`` (``_sk_pool2_ad_bwd``), f32, features on a grid of 0.5
    and a bound below the output count.  Max: every child equal to its
    parent's max gets the parent's full gradient (ties are not split), so
    some parent has two children that each hold all of it.  Children of
    cut parents, odd edges and invalid rows get 0."""
    shape, batch, bound = (9, 21, 17), 2, 256
    feats, inds = _sorted_input(3, shape, 1500, 4, 3200, batch, grid=True)
    cot = np.random.RandomState(4).randn(bound, 4).astype(np.float32)
    out, x = _port_sk(feats, inds, shape, batch, bound, mode)
    (out * torch.from_numpy(cot)).sum().backward()
    fn = _jax_sk(feats, inds, shape, batch, bound, mode)
    ref = np.asarray(jax.grad(lambda f: jnp.sum(fn(f) * cot))(
        jnp.asarray(feats)))
    got = x.grad.numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=GRAD_TOL * np.abs(ref).max())
    assert not got[inds[:, 0] < 0].any()
    if mode == "max":
        # the parent of every input row, and whose max each row equals
        parent = TS._parent_rows(*_port_keys(inds, shape, batch, bound),
                                 shape, batch).numpy()
        kept = parent < bound
        full = kept[:, None] & (got == cot[np.minimum(parent, bound - 1)])
        full &= got != 0
        tied = np.zeros((bound, 4), np.int64)
        np.add.at(tied, parent[kept], full[kept].astype(np.int64))
        assert (tied >= 2).any()


def _module_case(ndim):
    """(shape, batch, points per batch element, channels, buffer): more
    than 128 output sites at every ndim."""
    return {1: ((600,), 2, 300, 3, 640), 2: ((29, 41), 2, 200, 4, 512),
            3: ((9, 21, 17), 1, 500, 5, 512),
            4: ((7, 9, 8, 9), 1, 600, 3, 640)}[ndim]


@pytest.mark.parametrize("cls,algo", [
    ("SparseMaxPool3d", "sk"), ("SparseAvgPool3d", "sk"),
    ("SparseMaxPool3d", "seg"), ("SparseAvgPool3d", "seg"),
    ("SparseMaxPool1d", "seg"), ("SparseAvgPool1d", "sk"),
    ("SparseMaxPool2d", "sk"), ("SparseAvgPool2d", "seg"),
    ("SparseMaxPool4d", "seg"), ("SparseMaxPool4d", "sk"),
])
def test_pool_modules_match_jax(cls, algo):
    """Each pool module against the JAX module of the same name and algo,
    f32, a bound below the output count: coordinates, counts and spatial
    shape exactly, features exactly (max) or within 1e-6*max|ref| (mean),
    and the input gradient of ``sum(out * cot)`` against ``jax.grad``
    within 1e-6*max|ref|."""
    ndim = int(cls[-2])
    shape, batch, n, c, nbuf = _module_case(ndim)
    feats, inds = _sorted_input(5, shape, n, c, nbuf, batch, grid=True)
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, batch, keys_sorted=True)
    jpool = getattr(spconv_tpu, cls)(2, 2, algo=algo, out_bound=128)
    tpool = getattr(st, cls)(2, 2, algo=algo, out_bound=128)
    ref = jpool(jx)
    x = st.SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                            torch.from_numpy(inds), shape, batch,
                            keys_sorted=True)
    out = tpool(x)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(ref.indices))
    assert int(out.num_voxels) == int(ref.num_voxels) == 128
    assert int(out.num_out_total) == int(ref.num_out_total) > 128
    assert out.spatial_shape == tuple(ref.spatial_shape) and out.keys_sorted
    want = np.asarray(ref.features)
    tol = 0 if cls.startswith("SparseMax") else F32_MEAN_TOL
    np.testing.assert_allclose(out.features.detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())

    cot = np.random.RandomState(6).randn(128, c).astype(np.float32)
    (out.features * torch.from_numpy(cot)).sum().backward()
    g_ref = np.asarray(jax.grad(lambda f: jnp.sum(
        jpool(jx.replace_feature(f)).features * cot))(jnp.asarray(feats)))
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(x.features.grad.numpy(), g_ref, rtol=0,
                               atol=GRAD_TOL * np.abs(g_ref).max())


@pytest.mark.parametrize("mode", ["max", "mean"])
def test_global_pools_match_jax(mode):
    """``SparseGlobalMaxPool`` / ``SparseGlobalAvgPool`` against the JAX
    modules, f32, three batch elements of which one has no site (it pools
    to 0), features on a grid of 0.5 (the max's gradient splits among tied
    rows on both sides); outputs and ``jax.grad`` within 1e-6*max|ref|."""
    shape, batch = (9, 21, 17), 3
    feats, inds = _sorted_input(7, shape, 200, 4, 768, 2, grid=True)
    name = "SparseGlobalMaxPool" if mode == "max" else "SparseGlobalAvgPool"
    jpool, tpool = getattr(spconv_tpu, name)(), getattr(st, name)()
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, batch)
    x = st.SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                            torch.from_numpy(inds), shape, batch)
    out = tpool(x)
    ref = np.asarray(jpool(jx))
    assert tuple(out.shape) == (batch, 4) and not ref[2].any()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=F32_MEAN_TOL * np.abs(ref).max())
    cot = np.random.RandomState(8).randn(batch, 4).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    g_ref = np.asarray(jax.grad(lambda f: jnp.sum(
        jpool(jx.replace_feature(f)) * cot))(jnp.asarray(feats)))
    np.testing.assert_allclose(x.features.grad.numpy(), g_ref, rtol=0,
                               atol=GRAD_TOL * np.abs(g_ref).max())
    bf = global_pool(torch.from_numpy(feats).bfloat16(),
                     torch.from_numpy(inds), batch, mode)
    assert bf.dtype == torch.bfloat16


def _slice_nets(c=(4, 8, 12)):
    """The slice at narrow widths: two SubMConv3d pairs with a sorted-key
    max pool between them, then a sorted-key average pool; the JAX net and
    the port's with its weights."""
    def layers(m, **kw):
        return [m.SubMConv3d(c[0], c[1], 3, indice_key="a", **kw),
                m.SubMConv3d(c[1], c[1], 3, indice_key="a", **kw),
                m.SparseMaxPool3d(2, 2, algo="sk", out_bound=256),
                m.SubMConv3d(c[1], c[2], 3, indice_key="b", **kw),
                m.SubMConv3d(c[2], c[2], 3, indice_key="b", **kw),
                m.SparseAvgPool3d(2, 2, algo="sk", out_bound=128)]

    jnet = spconv_tpu.SparseSequential(*layers(spconv_tpu))
    tnet = st.SparseSequential(*layers(st, device="cpu"))
    sd = {k.replace("layers.", ""): v for k, v in state_dict(jnet).items()}
    return jnet, load_jax_state_dict(tnet, sd)


def test_whole_slice_net_matches_jax():
    """The slice's net, then ``SparseGlobalAvgPool``, against the JAX net
    with the same weights, f32: every sparse stage's coordinates exactly,
    the pooled output within 1e-5*max|ref|, and every weight's gradient of
    ``sum(out ** 2)`` within 5e-5*max|ref|."""
    shape = (16, 24, 24)
    feats, inds = _sorted_input(9, shape, 900, 4, 1024)
    jnet, tnet = _slice_nets()
    jgp, tgp = spconv_tpu.SparseGlobalAvgPool(), st.SparseGlobalAvgPool()
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, 1, keys_sorted=True)
    x = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                            shape, 1, keys_sorted=True)
    j_mid, t_mid = jnet(jx), tnet(x)
    np.testing.assert_array_equal(t_mid.indices.numpy(),
                                  np.asarray(j_mid.indices))
    assert int(t_mid.num_voxels) == int(j_mid.num_voxels) > 0

    def loss(m, t):
        return jnp.sum(jgp(m(t)).astype(jnp.float32) ** 2)

    loss_j, grads = spconv_tpu.filter_value_and_grad(loss)(jnet, jx)
    out = tgp(t_mid)
    ref = np.asarray(jgp(j_mid))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=NET_FWD_TOL * np.abs(ref).max())
    loss_t = (out ** 2).sum()
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * float(loss_j)
    g_ref = {k.replace("layers.", ""): v
             for k, v in state_dict(grads).items()}
    for name, p in tnet.named_parameters():
        want = g_ref[name]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=NET_GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)


def test_overflow_check_is_opt_in(monkeypatch):
    """With ``SPCONV_CHECK_OVERFLOW`` set, a pool on either route and a
    strided conv whose output bound cuts sites raise; without it they keep
    the smallest keys and say so only through ``overflowed``."""
    shape = (9, 21, 17)
    feats, inds = _sorted_input(10, shape, 500, 4, 512)
    x = st.SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                            shape, 1, keys_sorted=True)
    layers = [st.SparseMaxPool3d(2, 2, out_bound=128),
              st.SparseAvgPool3d(2, 2, algo="sk", out_bound=128),
              st.SparseConv3d(4, 4, 3, stride=2, padding=1, out_bound=128,
                              device="cpu")]
    with torch.no_grad():
        for layer in layers:
            assert bool(layer(x).overflowed)
        monkeypatch.setattr(constants, "SPCONV_CHECK_OVERFLOW", True)
        for layer in layers:
            with pytest.raises(ValueError, match="SPCONV_TPU_CHECK_OVERFLOW"):
                layer(x)
        assert not bool(st.SparseMaxPool3d(2, 2)(x).overflowed)


def test_sk_pool_refusals():
    """Input that is not key-sorted under ``algo="sk"`` takes the JAX
    route's fallback branch (the native pool over the 2x pool rulebook),
    not the seg route: sites, features and the grad against the JAX
    ``SparseAvgPool3d(algo="sk")`` on the same rows (its ``lax.cond``
    fallback, in interpret mode), within 1e-6 of max|ref|.  ``sk_pool2``
    checks its operands and has no route off the CPU but its kernel."""
    shape = (9, 21, 17)
    feats, inds = _sorted_input(11, shape, 100, 4, 128)
    perm = np.random.RandomState(12).permutation(128)
    feats, inds = feats[perm], inds[perm]
    x = st.SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                            torch.from_numpy(inds), shape, 1)
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, 1)
    jpool = spconv_tpu.SparseAvgPool3d(2, 2, algo="sk")
    y = st.SparseAvgPool3d(2, 2, algo="sk")(x)
    cot = np.random.RandomState(13).randn(*y.features.shape).astype(
        np.float32)
    (y.features * torch.from_numpy(cot)).sum().backward()

    def pool(f):
        out = jpool(jx.replace_feature(f))
        return out.features, out.indices

    ref, vjp, ref_inds = jax.vjp(pool, jnp.asarray(feats), has_aux=True)
    grad, = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref_inds))
    assert y.keys_sorted
    for got, want in ((y.features, ref), (x.features.grad, grad)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert st.SparseAvgPool3d(2, 2, algo="sk")(
        x.sort_by_key()).keys_sorted
    in_keys, out_keys = _port_keys(inds, shape, 1, 128)
    kw = dict(in_shape=shape, out_shape=_out_shape(shape), batch_size=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TS.sk_pool2(torch.zeros((128, 4), dtype=torch.float64), in_keys,
                    out_keys, **kw)
    with pytest.raises(ValueError, match="int32"):
        TS.sk_pool2(torch.zeros((128, 4)), in_keys.long(), out_keys, **kw)
    with pytest.raises(ValueError, match="mode"):
        TS.sk_pool2(torch.zeros((128, 4)), in_keys, out_keys, mode="sum",
                    **kw)
    with pytest.raises(NotImplementedError, match="no sk_pool kernel"):
        TS.sk_pool2(torch.zeros((128, 4), device="meta"),
                    in_keys.to("meta"), out_keys.to("meta"), **kw)
