"""The port's table-free subm conv (the search mode of the DG kernels: S1-S4
in ``ops/dg_conv.py``) against the JAX package on the CPU.

A subm conv without an ``indice_key`` takes the JAX package's search mode:
``dg_subm_conv(pos=None)`` and its VJP run ``_dg_fwd_kernel`` and
``_dg_bwd_kernel`` with ``posmode=False``, searching each row's matches
inside the kernel; the int8 conv runs ``dg_subm_conv_q(pos=None)``.  Those
run here in interpret mode (5-15 s a call, compiling), so the cases are few
and small.  On the CPU the port's search wrappers take their plain versions
(B1's plain table, then the table mode's plain product); the CUDA kernels
are held against those plain versions, and bit for bit against B1 and the
table-mode kernels, in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv as jax_dg_subm_conv
from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv_q

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.quantization import quantize as tq

from test_torch_strided import _sorted_input

WINDOW = 128  # the JAX kernels' key window: the result does not depend on
              # it, and the smallest compiles fastest in interpret mode
F32_TOL = 1e-6    # forward, of max|ref|: f32 sums in another order
BF16_TOL = 1.6e-2  # one bf16 rounding of each output (2**-7), plus order
GRAD_TOL = 5e-5   # of max|ref|: the Pallas backward sums in window order

# (grid, kernel size, dilation): 3-d and 2-d kernel 3, and a dilation 2
GEOMETRIES = {
    "3d_k3": ((6, 17, 23), (3, 3, 3), (1, 1, 1)),
    "2d_k3": ((29, 31), (3, 3), (1, 1)),
    "3d_k3_dil2": ((9, 14, 16), (3, 3, 3), (2, 2, 2)),
}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    TD.reset_launch_counts()
    yield
    assert not any(TD.launch_counts.values())


def _case(geometry, c, k_out, seed, n=500, nbuf=640):
    """Key-sorted features with an invalid tail, their keys, KRSC weights
    and a cotangent, from ``seed``."""
    shape, ksize, dil = GEOMETRIES[geometry]
    feats, inds = _sorted_input(seed, shape, n, c, nbuf)
    rng = np.random.RandomState(seed + 50)
    kv = int(np.prod(ksize))
    w = (rng.randn(k_out, *ksize, c) / np.sqrt(kv * c)).astype(np.float32)
    cot = rng.randn(nbuf, k_out).astype(np.float32)
    keys, _ = TC.linearize(torch.from_numpy(inds), shape, 1)
    return shape, dil, feats, inds, keys, w, cot


def _jax_conv(shape, dil, keys):
    def conv(f, w):
        return jax_dg_subm_conv(
            f, jnp.asarray(keys.numpy()), w, spatial_shape=shape,
            batch_size=1, dilation=dil, window=WINDOW, interpret=True)
    return conv


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_search_conv_matches_pallas_search_mode(geometry):
    """``dg_subm_conv_search`` against the Pallas conv with no table, f32:
    the forward within 1e-6 of max|ref|, and both gradients (``DGSearchFn``:
    dgrad and wgrad on the reversed probes) against ``jax.vjp``, whose VJP
    runs ``_dg_bwd_kernel`` in search mode, within 5e-5.  Invalid rows get
    exactly zero output and gradient."""
    shape, dil, feats, inds, keys, w, cot = _case(geometry, 6, 10, seed=1)
    out_j, vjp = jax.vjp(_jax_conv(shape, dil, keys), jnp.asarray(feats),
                         jnp.asarray(w))
    gx_j, gw_j = vjp(jnp.asarray(cot))

    x = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = TD.dg_subm_conv_search(x, keys, wt, spatial_shape=shape,
                                 batch_size=1, dilation=dil)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), out_j, F32_TOL)
    _close(x.grad, gx_j, GRAD_TOL)
    _close(wt.grad, gw_j, GRAD_TOL)
    assert not out[500:].any() and not x.grad[500:].any()


def test_search_conv_bf16_matches_pallas_search_mode():
    """The bf16 forward against the Pallas conv with no table, within
    1.6e-2 of max|ref|."""
    shape, dil, feats, inds, keys, w, _ = _case("3d_k3", 12, 20, seed=2)
    ref = _jax_conv(shape, dil, keys)(jnp.asarray(feats, jnp.bfloat16),
                                      jnp.asarray(w, jnp.bfloat16))
    with torch.no_grad():
        out = TD.dg_subm_conv_search(
            torch.from_numpy(feats).bfloat16(), keys,
            torch.from_numpy(w).bfloat16(), spatial_shape=shape,
            batch_size=1, dilation=dil)
    assert out.dtype == torch.bfloat16
    _close(out.float(), ref.astype(jnp.float32), BF16_TOL)


def test_quantized_no_key_conv_matches_pallas_search_mode():
    """An int8 ``QuantizedSparseConv`` of a no-key ``SubMConv3d`` with the
    fused residual (``dg_fwd_q_search``) bit for bit against
    ``dg_subm_conv_q(pos=None)`` on the valid rows, with the module's own
    int8 weights and folded scales; the invalid rows are 0."""
    shape = GEOMETRIES["3d_k3"][0]
    _, inds = _sorted_input(3, shape, 300, 8, 384)
    rng = np.random.RandomState(4)
    valid = inds[:, 0] >= 0
    x = np.where(valid[:, None], rng.randint(-100, 100, (384, 8)), 0)
    add = np.where(valid[:, None], rng.randint(-90, 90, (384, 16)), 0)
    x, add = x.astype(np.int8), add.astype(np.int8)
    conv = st.SubMConv3d(8, 16, 3, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    obs = tq.PerChannelMinMaxObserver()
    obs.observe(conv.weight)
    q = tq.QuantizedSparseConv(conv, obs.scale, 0.02, 0.03, act_type="relu")
    tx = st.SparseConvTensor(torch.from_numpy(x), torch.from_numpy(inds),
                             shape, 1, keys_sorted=True)
    with torch.no_grad():
        got = q(tx, add_input=tx.replace_feature(torch.from_numpy(add)),
                add_scale=0.05)
    assert got.indice_dict == {}
    keys, _ = TC.linearize(tx.indices, shape, 1)
    ref = np.asarray(dg_subm_conv_q(
        jnp.asarray(x), jnp.asarray(keys.numpy()),
        jnp.asarray(q.weight_i8.numpy()), jnp.asarray(q.scale_q.numpy()),
        jnp.asarray(q.bias_q.numpy()), spatial_shape=shape, batch_size=1,
        dilation=(1, 1, 1), act="relu", add_features=jnp.asarray(add),
        add_scale=0.05 / q.output_scale, window=WINDOW, interpret=True))
    got = got.features.numpy()
    assert (np.abs(ref[valid]) == 127).any() and (ref[valid] == 0).any()
    np.testing.assert_array_equal(got[valid], ref[valid])
    assert not got[~valid].any()


def _no_key_nets(c=(4, 8, 16, 12)):
    """Two ``SubMConv3d``, a ``SparseMaxPool3d``, one more ``SubMConv3d``,
    none with an ``indice_key``: the JAX net and the port's with its
    weights."""
    def layers(m, **kw):
        return [m.SubMConv3d(c[0], c[1], 3, **kw),
                m.SubMConv3d(c[1], c[2], 3, **kw),
                m.SparseMaxPool3d(2, 2, out_bound=256),
                m.SubMConv3d(c[2], c[3], 3, **kw)]

    jnet = spconv_tpu.SparseSequential(*layers(spconv_tpu))
    tnet = st.SparseSequential(*layers(st, device="cpu"))
    sd = {k.replace("layers.", ""): v for k, v in state_dict(jnet).items()}
    return jnet, load_jax_state_dict(tnet, sd)


def test_no_key_net_matches_jax():
    """The small no-key net against the JAX net (its CPU route), f32: the
    output's coordinates exactly, its features within 1e-5 of max|ref|
    (f32 sums in another order, through three convs), every weight's and
    the input's gradient of ``sum(out ** 2)`` within 5e-5; no record is
    cached anywhere."""
    shape = (12, 20, 18)
    feats, inds = _sorted_input(5, shape, 900, 4, 1024)
    jnet, tnet = _no_key_nets()
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, 1, keys_sorted=True)
    x = st.SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                            torch.from_numpy(inds), shape, 1,
                            keys_sorted=True)
    out = tnet(x)
    j_out = jnet(jx)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(j_out.indices))
    assert out.indice_dict == {} and int(out.num_voxels) > 0
    _close(out.features.detach(), j_out.features, 1e-5)

    def loss(m, f):
        return jnp.sum(m(jx.replace_feature(f)).features ** 2)

    loss_t = (out.features ** 2).sum()
    loss_t.backward()
    loss_j, grads = spconv_tpu.filter_value_and_grad(
        lambda m: loss(m, jnp.asarray(feats)))(jnet)
    gx_j = jax.grad(lambda f: loss(jnet, f))(jnp.asarray(feats))
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * float(loss_j)
    g_ref = {k.replace("layers.", ""): v
             for k, v in state_dict(grads).items()}
    for name, p in tnet.named_parameters():
        _close(p.grad, g_ref[name], GRAD_TOL)
    _close(x.features.grad, gx_j, GRAD_TOL)


@pytest.mark.parametrize("algo", ["dg", "sk"])
def test_no_key_conv_caches_nothing_and_equals_keyed(algo):
    """A no-key conv (``algo="dg"``, and ``"sk"``, which shares its
    route) adds no record to ``indice_dict``, keeps the records it was
    given, and computes what the keyed route computes: output, input and
    weight gradients equal.  So does its int8 conv."""
    shape = GEOMETRIES["3d_k3"][0]
    feats, inds = _sorted_input(6, shape, 400, 5, 512)
    g = torch.Generator().manual_seed(6)
    keyed = st.SubMConv3d(5, 7, 3, indice_key="k", algo=algo, device="cpu",
                          generator=g)
    free = st.SubMConv3d(5, 7, 3, algo=algo, device="cpu")
    free.load_state_dict(keyed.state_dict())
    results = []
    for conv in (keyed, free):
        x = st.SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                                torch.from_numpy(inds), shape, 1,
                                indice_dict={"other": "kept"},
                                keys_sorted=True)
        y = conv(x)
        (y.features ** 2).sum().backward()
        results.append((y, x.features.grad, conv.weight.grad, conv.bias.grad))
    (yk, *gk), (yf, *gf) = results
    assert set(yk.indice_dict) == {"other", "k"}
    assert yf.indice_dict == {"other": "kept"}
    assert torch.equal(yk.features, yf.features)
    assert all(torch.equal(a, b) for a, b in zip(gk, gf))

    q = [tq.QuantizedSparseConv(c, np.full(7, 0.01, np.float32), 0.05, 0.1)
         for c in (keyed, free)]
    x8 = st.SparseConvTensor(
        (torch.from_numpy(feats) * 100).to(torch.int8), torch.from_numpy(inds),
        shape, 1, keys_sorted=True)
    with torch.no_grad():
        qk, qf = (m(x8) for m in q)
    assert set(qk.indice_dict) == {"k"} and qf.indice_dict == {}
    assert torch.equal(qk.features, qf.features) and qf.features.any()


def test_search_wrappers_equal_the_table_wrappers():
    """Each search wrapper computes its table-mode sibling on B1's table
    (reversed for dgrad and wgrad), here at kernel 5 (125 offsets: four of
    the CUDA kernels' search groups) and a dilation, f32, bf16 and int8;
    ``DGSearchFn`` skips the input gradient when the features need none."""
    shape, ksize, dil = (9, 13, 11), (5, 3, 5), (1, 2, 1)
    feats, inds = _sorted_input(7, shape, 300, 6, 384)
    keys, _ = TC.linearize(torch.from_numpy(inds), shape, 1)
    geom = TD.SearchGeom.of(ksize, dil, shape, 1)
    tab = dict(ksize=ksize, dilation=dil, spatial_shape=shape, batch_size=1)
    pos = TD.build_dg_pos(keys, **tab)
    rev = TD.build_dg_pos(keys, reverse=True, **tab)
    g = torch.Generator().manual_seed(7)
    w = torch.randn((75, 6, 9), generator=g) * 0.1
    x = torch.from_numpy(feats)
    dout = torch.randn((384, 9), generator=g)
    for dt in (torch.float32, torch.bfloat16):
        xd, wd, dd = x.to(dt), w.to(dt), dout.to(dt)
        assert torch.equal(TD.dg_fwd_search(xd, wd, keys, geom),
                           TD.dg_fwd(xd, wd, pos))
        assert torch.equal(TD.dg_dgrad_search(dd, wd, keys, geom),
                           TD.dg_dgrad(dd, wd, rev))
        assert torch.equal(TD.dg_wgrad_search(xd, dd, keys, geom),
                           TD.dg_wgrad(xd, dd, rev))
    x8 = (x * 100).to(torch.int8)
    w8 = (w * 300).to(torch.int8)
    scale = torch.full((9,), 0.002)
    add = (dout * 30).to(torch.int8)
    kw = dict(act="relu", add=add, add_scale=0.3)
    got = TD.dg_fwd_q_search(x8, w8, keys, scale, None, geom, **kw)
    assert torch.equal(got, TD.dg_fwd_q(x8, w8, pos, scale, None, **kw))
    assert got.any()

    wt = w.clone().requires_grad_()
    out = TD.DGSearchFn.apply(x, wt, keys, geom)
    out.backward(dout)
    assert torch.equal(wt.grad, TD.dg_wgrad(x, dout, rev))


def test_search_wrappers_refuse_bad_operands():
    """A geometry that is not a ``SearchGeom``, keys of another length or
    dtype, and weights of another kernel raise instead of computing
    something else."""
    shape = (6, 17, 23)
    feats, inds = _sorted_input(8, shape, 60, 4, 64)
    keys, _ = TC.linearize(torch.from_numpy(inds), shape, 1)
    geom = TD.SearchGeom.of((3, 3, 3), (1, 1, 1), shape, 1)
    x = torch.from_numpy(feats)
    w = torch.zeros((27, 4, 8))
    with pytest.raises(ValueError, match="SearchGeom"):
        TD.dg_fwd_search(x, w, keys, tuple(geom))
    with pytest.raises(ValueError, match="rows"):
        TD.dg_fwd_search(x, w, keys[:32], geom)
    with pytest.raises(ValueError, match="int32"):
        TD.dg_fwd_search(x, w, keys.long(), geom)
    with pytest.raises(ValueError, match="offsets"):
        TD.dg_dgrad_search(torch.zeros((64, 8)), w[:9], keys, geom)
    with pytest.raises(ValueError, match="ndim"):
        TD.SearchGeom.of((3, 3), (1, 1, 1), shape, 1)
    with pytest.raises(ValueError, match="int8"):
        TD.dg_fwd_q_search(x, w, keys, torch.ones(8), None, geom)


_NDIM_SHAPES = {1: (61,), 2: (23, 19), 4: (5, 7, 6, 8)}


@pytest.mark.parametrize("kind", ["SubMConv", "SparseConv"])
@pytest.mark.parametrize("ndim", sorted(_NDIM_SHAPES))
def test_ndim_exports_match_jax(ndim, kind):
    """``SubMConv1d``/``2d``/``4d`` (no key: the search route) and
    ``SparseConv1d``/``2d``/``4d`` (kernel 3, stride 2, padding 1)
    construct and run, against the JAX modules with the same weights (their
    CPU route): coordinates exactly, features within 1e-5 of max|ref|."""
    shape = _NDIM_SHAPES[ndim]
    feats, inds = _sorted_input(ndim, shape, 40, 3, 64)
    kw = dict(stride=2, padding=1, out_bound=128) if kind == "SparseConv" \
        else {}
    jconv = getattr(spconv_tpu, f"{kind}{ndim}d")(3, 5, 3, **kw)
    tconv = load_jax_state_dict(
        getattr(st, f"{kind}{ndim}d")(3, 5, 3, device="cpu", **kw),
        state_dict(jconv))
    assert tconv.ndim == ndim and tconv.subm == (kind == "SubMConv")
    jy = jconv(spconv_tpu.SparseConvTensor(jnp.asarray(feats),
                                           jnp.asarray(inds), shape, 1,
                                           keys_sorted=True))
    with torch.no_grad():
        y = tconv(st.SparseConvTensor(torch.from_numpy(feats),
                                      torch.from_numpy(inds), shape, 1,
                                      keys_sorted=True))
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(jy.indices))
    assert tuple(y.spatial_shape) == tuple(jy.spatial_shape)
    _close(y.features, jy.features, 1e-5)
