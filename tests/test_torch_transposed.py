"""The port's transposed conv against the JAX package on the CPU.

A transposed conv discovers its output sites (``build_deconv_outputs``) and
runs as the inverse conv with the two spaces swapped: the divide table over
its expanded output rows forward, the affine table over its input rows
backward (``spconv_tpu/modules/conv.py:816-826``).  Here: the discovery
bit for bit against the JAX function; ``SparseConvTranspose3d`` against the
JAX module on its ``"dg"`` and ``"sk"`` routes (the Pallas kernels in
interpret mode, 5-15 s a call, so the cases are few and small) and its
``"native"`` route, forward and grads; the record's reuse rules; the
default buffer and ``output_padding`` (as ``tests/test_more_coverage.py``
pins them for the JAX module); the 1/2/4-d exports; and the decoder chain of
``docs/USAGE.md`` as a whole.  On the CPU the port's wrappers take their
plain versions; the CUDA kernels are held against those on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import spconv_tpu
from spconv_tpu.checkpoint import state_dict
from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.rulebook import build_deconv_outputs as jax_deconv

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import rulebook as TR
from spconv_tpu_torch.ops.rulebook import build_deconv_outputs
from spconv_tpu_torch.quantization import quantize as tq

from test_torch_strided import _sorted_input
from utils import dense_from_sparse

F32_TOL = 1e-6     # f32 forward, of max|ref|: sums in another order
BF16_TOL = 1.6e-2  # one bf16 rounding of each output (2**-7), plus order
GRAD_TOL = 5e-5    # f32 grads, of max|ref| per tensor (ROADMAP.md)

# name: (grid, ksize, stride, padding, dilation, output_padding, batch,
# out_bound): the chain's k2 s2, the general k3 s2 p1 op1 (an offset's
# divisibility depends on the row's parity), a stride-1 one, dilation 2
# (no dilation term in the output size, so candidates past the grid drop),
# two batches, a cut bound, and 2-d, 4-d and 1-d
GEOMS = {
    "k2s2p0": ((6, 7, 8), (2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1),
               (0, 0, 0), 1, None),
    "k3s2p1op1": ((6, 7, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1),
                  (1, 1, 1), 1, None),
    "k3s1p1": ((6, 7, 8), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1),
               (0, 0, 0), 1, None),
    "k3s2p1d2": ((6, 7, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1), (2, 2, 2),
                 (0, 0, 0), 1, None),
    "batch2": ((5, 6, 7), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1),
               (0, 0, 0), 2, None),
    "cut": ((6, 7, 8), (2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1),
            (0, 0, 0), 1, 300),
    "2d": ((9, 11), (3, 3), (2, 2), (1, 1), (1, 1), (1, 1), 1, None),
    "4d": ((4, 5, 3, 6), (2, 2, 2, 2), (2, 2, 2, 2), (0, 0, 0, 0),
           (1, 1, 1, 1), (0, 0, 0, 0), 1, None),
    "1d": ((40,), (3,), (2,), (1,), (1,), (1,), 1, None),
}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    TD.reset_launch_counts()
    yield
    assert not any(TD.launch_counts.values())


def _case(name, c=4, seed=0, n=60, nbuf=80):
    """Key-sorted input of ``n`` voxels per batch in ``nbuf`` rows per
    batch, and the geometry's discovery arguments."""
    shape, ksize, stride, pad, dil, opad, batch, bound = GEOMS[name]
    feats, inds = _sorted_input(seed, shape, n, c, nbuf * batch, batch)
    geom = dict(spatial_shape=shape, batch_size=batch, ksize=ksize,
                stride=stride, padding=pad, dilation=dil, out_padding=opad)
    return feats, inds, geom, bound


@pytest.mark.parametrize("name", list(GEOMS))
def test_build_deconv_outputs_matches_jax(name):
    """Equal sites, keys and counts, bit for bit, the cut included (the
    smallest keys are kept), and the default bound ``N * prod(stride)``."""
    _, inds, geom, bound = _case(name)
    want = jax_deconv(jnp.asarray(inds), out_bound=bound, **geom)
    got = build_deconv_outputs(torch.from_numpy(inds), out_bound=bound,
                               **geom)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == got[1].dtype == torch.int32
    buf = bound or inds.shape[0] * int(np.prod(geom["stride"]))
    assert got[1].shape[0] == buf
    assert int(got[2]) == min(int(got[3]), buf) > 0
    if name == "cut":
        assert int(got[3]) > bound


def test_deconv_output_size_matches_jax():
    """``(in - 1) * s - 2p + k + output_padding`` per axis, no dilation term,
    as the JAX function; a size <= 0 raises in discovery."""
    for shape, ks, s, p, d, op, _, _ in GEOMS.values():
        assert TC.get_deconv_output_size(shape, ks, s, p, d, op) == \
            JC.get_deconv_output_size(shape, ks, s, p, d, op)
    inds = torch.tensor([[0, 0, 0, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="reached zero"):
        build_deconv_outputs(inds, spatial_shape=(1, 1, 1), batch_size=1,
                             ksize=(1, 1, 1), stride=(1, 1, 1),
                             padding=(1, 1, 1), dilation=(1, 1, 1),
                             out_padding=(0, 0, 0))


def _modules(name, c, k_out, algo, jdtype=jnp.float32, tdtype=torch.float32,
             indice_key=None):
    """The JAX module and the port's with its weights (loaded strictly)."""
    shape, ksize, stride, pad, dil, opad, _, bound = GEOMS[name]
    kw = dict(stride=stride, padding=pad, dilation=dil, output_padding=opad,
              out_bound=bound, indice_key=indice_key)
    ndim = len(shape)
    jm = getattr(spconv_tpu, f"SparseConvTranspose{ndim}d")(
        c, k_out, ksize, algo=algo, dtype=jdtype, **kw)
    tm = getattr(st, f"SparseConvTranspose{ndim}d")(
        c, k_out, ksize, dtype=tdtype, device="cpu",
        algo="sk" if algo == "sk" else "dg", **kw)
    sd = state_dict(jm)
    assert set(sd) == set(tm.state_dict()) == {"weight", "bias"}
    return jm, load_jax_state_dict(tm, sd)


def _tensors(feats, inds, geom, tdtype=torch.float32, jdtype=jnp.float32):
    shape, batch = geom["spatial_shape"], geom["batch_size"]
    return (spconv_tpu.SparseConvTensor(
                jnp.asarray(feats, jdtype), jnp.asarray(inds), shape, batch,
                keys_sorted=True),
            st.SparseConvTensor(torch.from_numpy(feats).to(tdtype),
                                torch.from_numpy(inds), shape, batch,
                                keys_sorted=True))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


# dg and sk run the Pallas kernels in interpret mode (5-15 s a call)
@pytest.mark.parametrize("algo,name,dtype", [
    ("dg", "k2s2p0", "bfloat16"),
    ("sk", "k2s2p0", "float32"), ("native", "k3s2p1op1", "float32"),
    ("native", "batch2", "float32")])
def test_transposed_conv_matches_jax(algo, name, dtype):
    """``SparseConvTranspose3d`` against the JAX module with the same
    weights, on its ``algo`` route: the output sites, grid and counts
    exactly, the features within 1e-6 (f32) or 1.6e-2 (bf16) of max|ref|,
    0 on the rows without a site.  (The f32 ``"dg"`` case runs in
    :func:`test_transposed_grads_match_jax`, on one interpret-mode
    compile.)"""
    c, k_out = 5, 7
    feats, inds, geom, _ = _case(name, c=c, seed=1)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jm, tm = _modules(name, c, k_out, algo, jdt, tdt)
    jx, tx = _tensors(feats, inds, geom, tdt, jdt)
    ref = jm(jx)
    with torch.no_grad():
        y = tm(tx)
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    assert tuple(y.spatial_shape) == tuple(ref.spatial_shape)
    assert int(y.num_voxels) == int(ref.num_voxels) and y.keys_sorted
    assert y.features.dtype == tdt
    _close(y.features, ref.features, F32_TOL if dtype == "float32"
           else BF16_TOL)
    assert not y.features[~y.valid_mask].any()


@pytest.mark.parametrize("algo,name", [("dg", "k3s2p1op1"),
                                       ("native", "k2s2p0")])
def test_transposed_grads_match_jax(algo, name):
    """din, dW and db of ``sum(out * cot)`` against ``jax.grad`` of the JAX
    module (its ``_dg_reg_conv_bwd`` with affine probes on the swapped
    spaces, in interpret mode, or the native route), f32 within
    5e-5*max|ref| per tensor, and the forward within 1e-6 of max|ref|.
    Rows without a site get a zero din."""
    c, k_out = 5, 6
    feats, inds, geom, _ = _case(name, c=c, seed=2)
    jm, tm = _modules(name, c, k_out, algo)
    jx, tx = _tensors(feats, inds, geom)
    tx = tx.replace_feature(tx.features.clone().requires_grad_())
    y = tm(tx)
    cot = np.random.RandomState(3).randn(*y.features.shape)
    cot = (cot * (y.indices.numpy()[:, :1] >= 0)).astype(np.float32)
    (y.features * torch.from_numpy(cot)).sum().backward()

    def loss(tree):
        m, f = tree
        out = m(jx.replace_feature(f))
        return jnp.sum(out.features * cot), out

    (_, ref), (gm, gf) = spconv_tpu.filter_value_and_grad(
        loss, has_aux=True)((jm, jnp.asarray(feats)))
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    _close(y.features, ref.features, F32_TOL)
    g_ref = state_dict(gm)
    for got, want in ((tx.features.grad, gf), (tm.weight.grad,
                                                g_ref["weight"]),
                      (tm.bias.grad, g_ref["bias"])):
        assert tuple(got.shape) == tuple(np.shape(want))
        _close(got, want, GRAD_TOL)
    assert not tx.features.grad[~tx.valid_mask].any()


def test_transposed_record_reuse_and_refusals():
    """A second transposed conv of the same geometry under the same key
    reuses the record and its tables; a regular conv whose hyperparameters
    and output grid are the same (k3 s1 p1) does not read it, nor does a
    transposed conv read a regular record; an inverse conv under a
    transposed record raises; ``algo="native"`` runs the native path,
    held against the JAX module's."""
    feats, inds, geom, _ = _case("k3s1p1", c=4, seed=4)
    _, x = _tensors(feats, inds, geom)
    kw = dict(stride=1, padding=1, indice_key="t", device="cpu")
    first = st.SparseConvTranspose3d(4, 4, 3, **kw)
    second = st.SparseConvTranspose3d(4, 4, 3, **kw)
    regular = st.SparseConv3d(4, 4, 3, **kw)
    fresh = st.SparseConv3d(4, 4, 3, stride=1, padding=1, device="cpu")
    fresh.load_state_dict(regular.state_dict())
    y = first(x)  # grad mode: the backward's table is built too
    rec = y.indice_dict["__dgreg__t"]
    assert rec.transposed and rec.pos is not None and rec.pos_div is not None
    assert rec.pos_div.shape == (27, rec.out_keys.shape[0])
    assert rec.pos.shape == (27, x.indices.shape[0])
    x_rec = x.shadow_copy()
    x_rec.indice_dict.update(y.indice_dict)
    y2 = second(x_rec)
    assert y2.indice_dict["__dgreg__t"] is rec
    with torch.no_grad():
        got, want = regular(x_rec), fresh(x)
        assert tuple(got.spatial_shape) == tuple(y.spatial_shape)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      want.indices.numpy())
        assert torch.equal(got.features, want.features)
        assert got.indice_dict["__dgreg__t"] is rec
        # a transposed conv on a regular record
        y_reg = regular(x)
        x_reg = x.shadow_copy()
        x_reg.indice_dict.update(y_reg.indice_dict)
        np.testing.assert_array_equal(second(x_reg).indices.numpy(),
                                      y.indices.numpy())
        with pytest.raises(ValueError, match="transposed"):
            st.SparseInverseConv3d(4, 4, 3, indice_key="t",
                                   device="cpu")(y)
        jm, native = _modules("k3s1p1", 4, 4, "native")
        native.algo = "native"
        got, ref = native(x), jm(_tensors(feats, inds, geom)[0])
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(ref.indices))
        _close(got.features, ref.features, F32_TOL)
    assert "transposed=True" in repr(first)


def test_int8_transposed_conv_refused():
    """The int8 transposed conv runs the native route (B7 on its
    rulebook's ``pair_fwd``): ``convert_to_int8`` converts a chain that
    holds one, and an int8 ``SparseConvTranspose3d`` is bit-equal to the
    kernel route's formula on the rulebook and within one step on at most
    1 % of entries of the JAX package's native route.  ``dg_fwd_q`` still
    refuses the transposed path, and the table builders and
    ``dg_regular_conv`` take only the regular conv's three paths."""
    from spconv_tpu.quantization import quantize as jq

    feats, inds, geom, _ = _case("k2s2p0", c=4, seed=9)
    _, x = _tensors(feats, inds, geom)
    seq = st.SparseSequential(
        st.SubMConv3d(4, 4, 3, indice_key="s", device="cpu"),
        st.SparseConvTranspose3d(4, 4, 2, stride=2, device="cpu"))
    fused, observers = tq.calibrate(seq, [x])
    qseq = tq.convert_to_int8(fused, observers)
    with torch.no_grad():
        y = qseq(x.replace_feature(tq.quantize_tensor(x.features,
                                                      observers[0].scale)))
    assert y.features.dtype == torch.int8 and y.keys_sorted

    jc = spconv_tpu.SparseConvTranspose3d(8, 16, 2, stride=2)
    tc = load_jax_state_dict(
        st.SparseConvTranspose3d(8, 16, 2, stride=2, device="cpu"),
        state_dict(jc))
    rng = np.random.RandomState(10)
    w_scale = (np.abs(rng.randn(16)) / 100 + 1e-3).astype(np.float32)
    jq8 = jq.QuantizedSparseConv(jc, w_scale, 0.05, 0.04)
    tq8 = tq.QuantizedSparseConv(tc, w_scale, 0.05, 0.04)
    q_in = rng.randint(-127, 128, size=(inds.shape[0], 8)).astype(np.int8)
    q_in[inds[:, 0] < 0] = 0
    jx, tx = _tensors(q_in, inds, geom, torch.int8, jnp.int8)
    ref = jq8(jx)
    with torch.no_grad():
        got = tq8(tx)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    pf = TR.build_conv_rulebook(
        torch.from_numpy(inds), ksize=(2, 2, 2), stride=(2, 2, 2),
        padding=(0, 0, 0), dilation=(1, 1, 1), transposed=True,
        out_bound=got.indices.shape[0], spatial_shape=geom["spatial_shape"],
        batch_size=1).pair_fwd.numpy()
    wkv = tq8.weight_kv.numpy().astype(np.int64)
    acc = np.zeros((pf.shape[1], 16), np.int64)
    for k in range(8):
        hit = pf[k] >= 0
        acc[hit] += q_in[pf[k, hit]].astype(np.int64) @ wkv[k]
    want = np.clip(np.rint((acc.astype(np.float32) * tq8.scale_q.numpy())
                           + tq8.bias_q.numpy()), -127, 127).astype(np.int8)
    want[got.indices.numpy()[:, 0] < 0] = 0
    np.testing.assert_array_equal(got.features.numpy(), want)
    diff = np.abs(got.features.numpy().astype(np.int32)
                  - np.asarray(ref.features, np.int32))
    print(f"int8 transposed: {int((diff > 0).sum())} of {diff.size} "
          "entries differ from the JAX native route")
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01

    x8 = torch.zeros((4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="transposed"):
        TD.dg_fwd_q(x8, torch.zeros((8, 4, 4), dtype=torch.int8),
                    torch.full((8, 4), -1, dtype=torch.int32),
                    torch.ones(4), None, path="transposed")
    keys = torch.zeros(1, dtype=torch.int32)
    table = dict(ksize=(2,) * 3, stride=(2,) * 3, padding=(0,) * 3,
                 dilation=(1,) * 3, in_shape=(4,) * 3, out_shape=(2,) * 3,
                 batch_size=1)
    for build in (TD.build_dg_pos_affine, TD.build_dg_pos_divide):
        with pytest.raises(ValueError, match="path"):
            build(keys, keys, path="subm", **table)
    with pytest.raises(ValueError, match="path"):
        TD.dg_regular_conv(torch.zeros((1, 4)), keys, keys,
                           torch.zeros((4, 2, 2, 2, 4)), path="subm",
                           **{k: v for k, v in table.items()
                              if k != "ksize"})


def test_transposed_output_padding():
    """``output_padding=1`` widens the grid by one row per axis; no
    candidate lands in the padded rows.  Every output site's features equal
    PyTorch's dense ``conv_transpose3d`` there, with the KRSC weight moved
    to ``[C, K, *ksize]`` unflipped (``tests/test_more_coverage.py:42-59``
    pins the JAX module the same way)."""
    feats, inds, geom, _ = _case("k2s2p0", c=4, seed=5)
    _, x = _tensors(feats, inds, geom)
    m = st.SparseConvTranspose3d(4, 6, 2, stride=2, bias=False,
                                 output_padding=1, out_bound_ratio=8.0,
                                 device="cpu")
    with torch.no_grad():
        y = m(x)
    shape = geom["spatial_shape"]
    assert tuple(y.spatial_shape) == tuple((s - 1) * 2 + 2 + 1 for s in shape)
    oi = y.indices.numpy()
    valid = oi[:, 0] >= 0
    assert not (oi[valid][:, 1:] == np.array(y.spatial_shape) - 1).any()
    xd = torch.tensor(dense_from_sparse(feats, inds, shape, 1))
    wt = m.weight.detach().permute(4, 0, 1, 2, 3)
    yd = F.conv_transpose3d(xd, wt, stride=2, output_padding=1).numpy()
    want = np.stack([yd[r[0], :, r[1], r[2], r[3]] for r in oi[valid]])
    np.testing.assert_allclose(y.features.numpy()[valid], want, rtol=1e-5,
                               atol=1e-5)
    # every active dense output site is one of the outputs
    assert valid.sum() == int((np.abs(yd).sum(1) > 0).sum())


def test_transposed_default_bound_no_truncation():
    """The default buffer, ``max(out_bound_ratio, 2 * prod(stride))`` times
    the input's, holds the expansion: at k2 s2 every input spawns exactly 8
    disjoint outputs (``tests/test_more_coverage.py:138-145``)."""
    feats, inds, geom, _ = _case("k2s2p0", c=4, seed=6, n=50, nbuf=128)
    _, x = _tensors(feats, inds, geom)
    m = st.SparseConvTranspose3d(4, 4, 2, stride=2, bias=False,
                                 device="cpu")
    assert m._resolve_out_bound(128) == 16 * 128
    with torch.no_grad():
        y = m(x)
    assert y.indices.shape[0] == 16 * 128
    n_in = int((inds[:, 0] >= 0).sum())
    assert int((y.indices[:, 0] >= 0).sum()) == int(y.num_voxels) == 8 * n_in
    assert int(y.num_out_total) == 8 * n_in
    # a stride-1 transposed conv keeps the stride-1 floor of 2
    assert st.SparseConvTranspose3d(4, 4, 3, device="cpu") \
        ._resolve_out_bound(128) == 256


@pytest.mark.parametrize("ndim", [1, 2, 4])
def test_ndim_exports_match_jax(ndim):
    """``SparseConvTranspose1d``/``2d``/``4d`` construct and run, against
    the JAX modules (their native route) with the same weights: coordinates
    exactly, features within 1e-6 of max|ref|; kernel 1 at stride 1 stays
    the 1x1 matmul."""
    name = f"{ndim}d"
    feats, inds, geom, _ = _case(name, c=3, seed=7, n=20, nbuf=32)
    jm, tm = _modules(name, 3, 5, "native")
    assert tm.ndim == ndim and tm.transposed and not tm.conv1x1
    jx, tx = _tensors(feats, inds, geom)
    ref = jm(jx)
    with torch.no_grad():
        y = tm(tx)
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    assert tuple(y.spatial_shape) == tuple(ref.spatial_shape)
    _close(y.features, ref.features, F32_TOL)
    one = getattr(st, f"SparseConvTranspose{ndim}d")(3, 2, 1, device="cpu")
    assert one.conv1x1
    with torch.no_grad():
        z = one(tx)
    assert torch.equal(z.indices, tx.indices)


def _chain(mod, **kw):
    """The decoder chain of ``docs/USAGE.md:34-38``."""
    return mod.SparseSequential(
        mod.SubMConv3d(32, 64, 3, indice_key="c0", **kw),
        mod.SparseConv3d(64, 128, 3, stride=2, padding=1,
                         indice_key="down1", **kw),
        mod.SparseInverseConv3d(128, 64, 3, indice_key="down1", **kw),
        mod.SparseConvTranspose3d(64, 32, 2, stride=2, **kw))


def test_usage_chain_matches_jax():
    """The USAGE.md chain at its documented widths on a small scan: the
    output's sites exactly the JAX chain's (on its native route), the
    features within 1e-5 of max|ref| through four convs, and every
    parameter's and the input's gradient of ``sum(out ** 2)`` within
    5e-5 of max|ref| per tensor."""
    shape = (10, 16, 16)
    feats, inds = _sorted_input(8, shape, 150, 32, 192)
    geom = dict(spatial_shape=shape, batch_size=1)
    jnet = _chain(spconv_tpu, algo="native")
    tnet = load_jax_state_dict(
        _chain(st, device="cpu"),
        {k.replace("layers.", ""): v for k, v in state_dict(jnet).items()})
    jx, tx = _tensors(feats, inds, geom)
    tx = tx.replace_feature(tx.features.clone().requires_grad_())
    ref = jnet(jx)
    y = tnet(tx)
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    assert tuple(y.spatial_shape) == tuple(ref.spatial_shape) == (20, 32, 32)
    assert int(y.num_voxels) == 8 * 150
    _close(y.features, ref.features, 1e-5)
    (y.features ** 2).sum().backward()

    def loss(tree):
        m, f = tree
        return jnp.sum(m(jx.replace_feature(f)).features ** 2)

    _, (gm, gf) = spconv_tpu.filter_value_and_grad(loss)(
        (jnet, jnp.asarray(feats)))
    g_ref = {k.replace("layers.", ""): v for k, v in state_dict(gm).items()}
    _close(tx.features.grad, gf, GRAD_TOL)
    for k, p in tnet.named_parameters():
        _close(p.grad, g_ref[k], GRAD_TOL)


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
def test_load_jax_state_dict_carries_transposed_weights(ndim):
    """A JAX ``SparseConvTranspose*d``'s KRSC weight ``[K, *ksize, C]`` and
    bias move across unchanged, f32 and bf16 (the layout is not flipped:
    the divide probes read ``W[k]`` as it is)."""
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jm = getattr(spconv_tpu, f"SparseConvTranspose{ndim}d")(
            3, 5, 2, stride=2, dtype=jdt)
        tm = load_jax_state_dict(getattr(st, f"SparseConvTranspose{ndim}d")(
            3, 5, 2, stride=2, dtype=tdt, device="cpu"), state_dict(jm))
        assert tuple(tm.weight.shape) == (5,) + (2,) * ndim + (3,)
        for k, v in state_dict(jm).items():
            np.testing.assert_array_equal(
                getattr(tm, k).detach().float().numpy(),
                np.asarray(v, np.float32))


def test_expanded_grid_past_int32_keys_raises():
    """The chain's transposed conv at batch 4: the input grid ``[80, 1024,
    1024]`` fits int32 keys, its expanded ``[160, 2048, 2048]`` grid
    (671,088,640 keys a batch item) does not, so the conv takes the native
    path on int64 keys, as the JAX module takes it on two-word keys: sites
    and features against it.  At batch 1 the DG path serves it."""
    inds = np.array([[b, 3, 5, 7] for b in range(4)], np.int32)
    feats = np.random.RandomState(11).randn(4, 2).astype(np.float32)
    geom = dict(spatial_shape=(80, 1024, 1024), batch_size=4)
    jm, conv = _modules("k2s2p0", 2, 2, "native")
    jx, x = _tensors(feats, inds, geom)
    with torch.no_grad():
        y = conv(x)
        ref = jm(jx)
        assert y.spatial_shape == (160, 2048, 2048)
        np.testing.assert_array_equal(y.indices.numpy(),
                                      np.asarray(ref.indices))
        _close(y.features, ref.features, F32_TOL)
        x1 = st.SparseConvTensor(x.features[:1], x.indices[:1],
                                 (80, 1024, 1024), 1, keys_sorted=True)
        assert conv(x1).spatial_shape == (160, 2048, 2048)
