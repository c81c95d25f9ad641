"""The port's regular (strided) conv against the JAX package on the CPU:
output discovery (``build_conv_outputs``), the affine match table (against
a brute-force enumeration of its definition), and the forward against
``dg_regular_conv`` and ``sk_regular_conv`` run in interpret mode.  The
CUDA kernels are held against these plain versions in
``test_torch_cuda.py``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas.dg_conv import dg_regular_conv as jax_dg_regular
from spconv_tpu.ops.pallas.sorted_conv import \
    sk_regular_conv as jax_sk_regular
from spconv_tpu.ops.rulebook import build_conv_outputs as jax_outputs

from spconv_tpu_torch import IndiceData, SparseConv3d, SparseConvTensor
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops.rulebook import build_conv_outputs

from utils import generate_sparse_data

# (shape, ksize, stride, padding, dilation, batch, out_bound): the
# CenterPoint downsample and conv_out, an even kernel, a dilated one, two
# batches, and a bound below the true count (truncation)
GEOMS = {
    "k3s2p1": ((13, 14, 15), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), 1,
               None),
    "k311s211p0": ((13, 14, 15), (3, 1, 1), (2, 1, 1), (0, 0, 0),
                   (1, 1, 1), 1, None),
    "k2s2p0": ((13, 14, 15), (2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1), 1,
               None),
    "k3s2p1d2": ((13, 14, 15), (3, 3, 3), (2, 2, 2), (1, 1, 1), (2, 1, 2),
                 1, None),
    "batch2": ((9, 12, 10), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), 2,
               None),
    "truncated": ((13, 14, 15), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1),
                  1, 100),
}


def _sorted_input(seed, shape, n, c, nbuf, batch=1):
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n, c, batch_size=batch,
                                       rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, inds.shape[1]), -1, np.int32)
    fb[:len(inds)] = feats[order]
    ib[:len(inds)] = inds[order]
    return fb, ib


def _case(name, c=8, seed=0, n=400, nbuf=512):
    """Input of ``n`` voxels per batch in ``nbuf`` rows per batch; the
    output buffer is as large, or the geometry's bound."""
    shape, ksize, stride, padding, dil, batch, bound = GEOMS[name]
    feats, inds = _sorted_input(seed, shape, n, c, nbuf * batch, batch)
    geom = dict(spatial_shape=shape, batch_size=batch, ksize=ksize,
                stride=stride, padding=padding, dilation=dil)
    out_shape = tuple(TC.get_conv_output_size(shape, ksize, stride, padding,
                                              dil))
    return feats, inds, geom, bound or nbuf * batch, out_shape


@pytest.mark.parametrize("name", list(GEOMS))
def test_build_conv_outputs_matches_jax(name):
    """Equal sites, keys and counts, the cut included: bounded discovery
    keeps the smallest keys."""
    _, inds, geom, bound, _ = _case(name)
    want = jax_outputs(jnp.asarray(inds), out_bound=bound, **geom)
    got = build_conv_outputs(torch.from_numpy(inds), out_bound=bound,
                             **geom)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == got[1].dtype == torch.int32
    if name == "truncated":
        assert int(got[3]) > bound == int(got[2])
    else:
        assert int(got[3]) == int(got[2]) > 0


def _brute_force_table(inds, out_inds, shape, ksize, stride, padding, dil):
    """Row of the input site at ``o * stride + off_k * dil - pad`` for
    every output site ``o`` and offset ``k``, by a dictionary of input
    sites: the table's definition, written out."""
    rows = {tuple(r): i for i, r in enumerate(inds) if r[0] >= 0}
    offs = list(itertools.product(*[range(k) for k in ksize]))
    table = np.full((len(offs), len(out_inds)), -1, np.int32)
    for o, oc in enumerate(out_inds):
        if oc[0] < 0:
            continue
        for k, off in enumerate(offs):
            ic = tuple(int(oc[a + 1]) * stride[a] + off[a] * dil[a]
                       - padding[a] for a in range(len(shape)))
            if all(0 <= v < s for v, s in zip(ic, shape)):
                table[k, o] = rows.get((int(oc[0]),) + ic, -1)
    return table


@pytest.mark.parametrize("name", list(GEOMS))
def test_affine_table_matches_definition(name):
    """The affine table equals its definition exactly (the displacement is
    ``off * dil - pad``, not the subm kernel's centred one)."""
    _, inds, geom, bound, out_shape = _case(name)
    out_inds, out_keys, _, _ = build_conv_outputs(
        torch.from_numpy(inds), out_bound=bound, **geom)
    in_keys, _ = TC.linearize(torch.from_numpy(inds), geom["spatial_shape"],
                              geom["batch_size"])
    pos = TD.build_dg_pos_affine(
        in_keys, out_keys, ksize=geom["ksize"], stride=geom["stride"],
        padding=geom["padding"], dilation=geom["dilation"],
        in_shape=geom["spatial_shape"], out_shape=out_shape,
        batch_size=geom["batch_size"])
    want = _brute_force_table(inds, out_inds.numpy(), geom["spatial_shape"],
                              geom["ksize"], geom["stride"], geom["padding"],
                              geom["dilation"])
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), want)
    # every active output site is reached by some input row
    live = out_inds[:, 0].numpy() >= 0
    assert ((want >= 0).any(axis=0) == live).all()


def _jax_regular(fn, feats, inds, w, geom, bound, out_shape, jdt, **kw):
    out_inds, out_keys, _, _ = jax_outputs(jnp.asarray(inds),
                                           out_bound=bound, **geom)
    in_keys, _ = JC.linearize(jnp.asarray(inds), geom["spatial_shape"],
                              geom["batch_size"])
    out, _, _ = fn(
        jnp.asarray(feats, jdt), in_keys, out_keys, jnp.asarray(w, jdt),
        in_shape=geom["spatial_shape"], out_shape=out_shape,
        batch_size=geom["batch_size"], stride=geom["stride"],
        padding=geom["padding"], dilation=geom["dilation"], interpret=True,
        **kw)
    # the JAX layer masks the output by its sites the same way
    out = jnp.where((out_inds[:, 0] >= 0)[:, None], out, 0)
    return np.asarray(out.astype(jnp.float32))


def _port_layer(c, k_out, geom, bound, w, algo, dtype):
    conv = SparseConv3d(c, k_out, geom["ksize"], stride=geom["stride"],
                        padding=geom["padding"], dilation=geom["dilation"],
                        bias=False, indice_key="d", algo=algo,
                        out_bound=bound, dtype=dtype, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).to(dtype))
    return conv


# each case runs the Pallas kernel in interpret mode (5-15 s on the CPU):
# bf16 at the two CenterPoint geometries, f32 also at the even kernel and
# a cut output
@pytest.mark.parametrize("name,dtype", [
    ("k3s2p1", "float32"), ("k3s2p1", "bfloat16"),
    ("k311s211p0", "float32"), ("k311s211p0", "bfloat16"),
    ("k2s2p0", "float32"), ("truncated", "float32")])
def test_strided_conv_matches_jax_dg_regular(name, dtype):
    """``SparseConv3d`` against ``dg_regular_conv`` in interpret mode, at
    C = 5 (the CenterPoint input width).  f32 within 2e-5*max|ref| (sums
    in another order); bf16 within 1.6e-2*max|ref| (one bf16 rounding of
    the output, 2**-7 relative, plus order).  Sites and counts equal,
    including a cut by the output bound."""
    c, k_out = 5, 16
    # small: the Pallas kernel in interpret mode walks every tile
    feats, inds, geom, bound, out_shape = _case(name, c=c, seed=1, n=200,
                                                nbuf=256)
    w = (np.random.RandomState(2).randn(k_out, *geom["ksize"], c)
         / np.sqrt(c * np.prod(geom["ksize"]))).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = _jax_regular(jax_dg_regular, feats, inds, w, geom, bound,
                       out_shape, jdt)
    tdt = getattr(torch, dtype)
    x = SparseConvTensor(torch.from_numpy(feats).to(tdt),
                         torch.from_numpy(inds), geom["spatial_shape"],
                         geom["batch_size"], keys_sorted=True)
    with torch.no_grad():
        y = _port_layer(c, k_out, geom, bound, w, "dg", tdt)(x)
    want = jax_outputs(jnp.asarray(inds), out_bound=bound, **geom)
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(want[0]))
    assert int(y.num_voxels) == int(want[2])
    assert int(y.num_out_total) == int(want[3])
    assert y.spatial_shape == out_shape and y.keys_sorted
    assert y.features.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(y.features.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    assert not y.features[~y.valid_mask].any()
    assert bool(y.overflowed) == (int(want[3]) > bound)
    assert bool(y.overflowed) or name != "truncated"


@pytest.mark.parametrize("name", ["k3s2p1", "k311s211p0"])
def test_strided_sk_conv_matches_jax_sk_regular(name):
    """``SparseConv3d(algo="sk")`` against ``sk_regular_conv`` in
    interpret mode, f32 within 2e-5*max|ref|, and bit-equal to
    ``algo="dg"`` (the same table and kernel)."""
    c, k_out = 8, 16
    feats, inds, geom, bound, out_shape = _case(name, c=c, seed=3, n=200,
                                                nbuf=256)
    w = (np.random.RandomState(4).randn(k_out, *geom["ksize"], c)
         / np.sqrt(c * np.prod(geom["ksize"]))).astype(np.float32)
    ref = _jax_regular(jax_sk_regular, feats, inds, w, geom, bound,
                       out_shape, jnp.float32)
    outs = {}
    for algo in ("sk", "dg"):
        x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                             geom["spatial_shape"], 1, keys_sorted=True)
        with torch.no_grad():
            outs[algo] = _port_layer(c, k_out, geom, bound, w, algo,
                                     torch.float32)(x)
    assert "__skreg__d" in outs["sk"].indice_dict
    assert "__dgreg__d" in outs["dg"].indice_dict
    assert torch.equal(outs["sk"].features, outs["dg"].features)
    np.testing.assert_allclose(outs["sk"].features.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


def test_regular_record_reuse_and_refusals():
    """A second layer under the same key reuses the record only on equal
    geometry and leaves it as it is otherwise; the cached encoder input is
    there for an inverse conv; input not flagged key-sorted takes the
    native path (held against the JAX module within 1e-5 of max|ref|).
    With a gradient wanted the layer also caches the divide table, the
    exact inverse of the affine one, and its backward runs through it."""
    feats, inds, geom, bound, _ = _case("k3s2p1", c=4, seed=5)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         geom["spatial_shape"], 1, keys_sorted=True)
    g = torch.Generator().manual_seed(0)
    a = SparseConv3d(4, 8, 3, stride=2, padding=1, indice_key="d",
                     generator=g, device="cpu")
    with torch.no_grad():
        y = a(x)
        rec = y.indice_dict["__dgreg__d"]
        assert torch.equal(y.indice_dict["__dgreg_in__d"], x.indices)
        # same geometry on a tensor carrying the record: reused
        x_rec = x.shadow_copy()
        x_rec.indice_dict.update(y.indice_dict)
        z = a(x_rec)
        assert z.indice_dict["__dgreg__d"] is rec
        assert torch.equal(z.features, y.features)
        # other geometry under the same key: rebuilt, record untouched
        b = SparseConv3d(4, 8, 2, stride=2, indice_key="d", generator=g,
                         device="cpu")
        w = b(x_rec)
        assert w.indice_dict["__dgreg__d"] is rec
        assert rec.pos_div is None  # no gradient was wanted
        assert w.spatial_shape == (6, 7, 7)
        # the table's rows must index the features
        with pytest.raises(ValueError, match="in_keys has"):
            TD.dg_regular_conv(
                x.features[:256], rec.in_keys, rec.out_keys, a.weight,
                in_shape=rec.in_shape, out_shape=rec.out_shape,
                batch_size=1, stride=rec.stride, padding=rec.padding,
                dilation=rec.dilation)
    xg = x.replace_feature(x.features.clone().requires_grad_())
    yg = a(xg)
    rec_g = yg.indice_dict["__dgreg__d"]
    assert torch.equal(yg.features, y.features)
    div = rec_g.pos_div.numpy()
    aff = rec_g.pos.numpy()
    assert div.shape == (27, x.indices.shape[0])
    for k in range(27):
        inv = np.full(div.shape[1], -1, np.int32)
        hit = aff[k] >= 0
        inv[aff[k, hit]] = np.nonzero(hit)[0]
        np.testing.assert_array_equal(div[k], inv)
    (yg.features ** 2).sum().backward()
    assert a.weight.grad.abs().max() > 0
    assert xg.features.grad.abs().max() > 0
    assert not xg.features.grad[~x.valid_mask].any()
    import spconv_tpu
    from spconv_tpu.checkpoint import load_state_dict

    perm = torch.from_numpy(np.random.RandomState(6).permutation(
        x.indices.shape[0]))
    unsorted = SparseConvTensor(x.features[perm], x.indices[perm],
                                x.spatial_shape, 1)
    jm = load_state_dict(
        spconv_tpu.SparseConv3d(4, 8, 3, stride=2, padding=1,
                                indice_key="d"),
        {k: v.detach().numpy() for k, v in a.state_dict().items()})
    ref = jm(spconv_tpu.SparseConvTensor(
        jnp.asarray(unsorted.features.numpy()),
        jnp.asarray(unsorted.indices.numpy()), x.spatial_shape, 1))
    with torch.no_grad():
        got = a(unsorted)
    assert isinstance(got.indice_dict["d"], IndiceData)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    want = np.asarray(ref.features)
    np.testing.assert_allclose(got.features.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
