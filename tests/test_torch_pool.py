"""The port's ``pool2_seg`` (the segment route) and ``SparseMaxPool3d``
against the JAX package's ``pool2_seg``: max outputs, coordinates and
counts must be exactly equal (a max picks an input value, so no rounding
enters), and so must the gradients up to f32 rounding; means within f32
(or one bf16) rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops.pool import pool2_seg as jax_pool2_seg

from spconv_tpu_torch import SparseConvTensor, SparseMaxPool3d
from spconv_tpu_torch.ops.pool import pool2_seg

from utils import generate_sparse_data


def _input(seed, shape, n, c, nbuf, batch_size):
    """Unsorted rows with inactive rows mixed in (pool2_seg needs no
    order)."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n, c, batch_size=batch_size,
                                       rng=rng)
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, inds.shape[1]), -1, np.int32)
    fb[:len(inds)] = feats
    ib[:len(inds)] = inds
    perm = rng.permutation(nbuf)
    return fb[perm], ib[perm]


@pytest.mark.parametrize(
    "shape,batch,out_bound,dtype",
    [
        # odd edges on every axis: the last plane of inputs is dropped
        ((9, 21, 17), 1, 1024, "float32"),
        # a bound below the output count: the smallest keys are kept
        ((9, 21, 17), 2, 128, "float32"),
        ((8, 16, 16), 2, 1024, "bfloat16"),
    ],
)
def test_pool2_seg_matches_jax(shape, batch, out_bound, dtype):
    feats, inds = _input(0, shape, 500, 6, 1100, batch)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jf, ji, jn, jt = jax_pool2_seg(
        jnp.asarray(feats, jdt), jnp.asarray(inds), spatial_shape=shape,
        batch_size=batch, out_bound=out_bound)
    tf, ti, tn, tt = pool2_seg(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(inds), spatial_shape=shape, batch_size=batch,
        out_bound=out_bound)
    assert tf.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tf.float().numpy(),
                                  np.asarray(jf.astype(jnp.float32)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn) and int(tt) == int(jt)
    if out_bound == 128:
        assert int(tt) > int(tn) == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_bound", [2048, 256])
def test_pool2_seg_grad_matches_jax(dtype, out_bound):
    """Autograd through the port's scatter-max against ``jax.grad`` through
    the JAX package's ``.at[seg].max``.  Features on a grid of 0.5 make
    exact ties: both split an output's gradient evenly among its tied
    children.  The -inf fill takes none (each kept output's children carry
    exactly its gradient), and children of outputs cut by ``out_bound``
    (256 here, below the output count) or of no output (odd edges,
    inactive rows) get none.  f32: equal up to f32 rounding (the even split
    divides by the tie count).  bf16: within one bf16 rounding (rtol
    2**-7), since JAX multiplies by a bf16-rounded 1/n where torch divides
    by n."""
    shape, batch, c = (9, 21, 17), 2, 4
    feats, inds = _input(2, shape, 1500, c, 3200, batch)
    feats = np.round(feats * 2) / 2
    cot = np.random.RandomState(3).randn(out_bound, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def loss(f):
        out = jax_pool2_seg(f, jnp.asarray(inds), spatial_shape=shape,
                            batch_size=batch, out_bound=out_bound)[0]
        return jnp.sum(out.astype(jnp.float32) * cot)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats, jdt))
                     .astype(jnp.float32))
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    out, _, n_out, n_tot = pool2_seg(x, torch.from_numpy(inds),
                                     spatial_shape=shape, batch_size=batch,
                                     out_bound=out_bound)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == tdt
    got = x.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2**-7, atol=0)

    # ties were split: some child holds a fraction of its output's gradient
    oc = inds[:, 1:] // 2
    inside = (inds[:, 0] >= 0) & (oc < np.array(shape) // 2).all(axis=1)
    parent = np.where(inside,
                      ((inds[:, 0] * 4 + oc[:, 0]) * 10 + oc[:, 1]) * 8
                      + oc[:, 2], -1)
    keys = np.unique(parent[parent >= 0])
    slot = np.searchsorted(keys, parent)
    kept = (parent >= 0) & (slot < out_bound)
    assert int(n_tot) == len(keys) and int(n_out) == min(len(keys), out_bound)
    assert not got[~kept].any()
    mass = np.zeros((out_bound, c), np.float32)
    np.add.at(mass, slot[kept], got[kept])
    np.testing.assert_allclose(mass[:int(n_out)], cot[:int(n_out)],
                               rtol=0, atol=1e-2 if dtype == "bfloat16"
                               else 1e-5)
    frac = np.abs(got[kept]) / np.maximum(np.abs(cot[slot[kept]]), 1e-30)
    assert ((frac > 0.01) & (frac < 0.99)).any()
    if out_bound == 256:
        assert int(n_tot) > 256 and (parent >= 0).sum() > kept.sum()


def test_max_pool_module_keeps_sorted_and_counts():
    shape = (9, 21, 17)
    feats, inds = _input(1, shape, 400, 4, 512, 1)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         shape, 1)
    y = SparseMaxPool3d(2, 2)(x)
    assert y.spatial_shape == (4, 10, 8)
    assert y.keys_sorted and y.features.shape[0] == 512
    valid = y.valid_mask
    n = int(y.num_voxels)
    assert int(valid.sum()) == n == int(y.num_out_total)
    assert valid[:n].all() and not valid[n:].any()
    key = (y.indices[:n, 1] * 10 + y.indices[:n, 2]) * 8 + y.indices[:n, 3]
    assert (key[1:] > key[:-1]).all()
    assert not y.features[n:].any()


@pytest.mark.parametrize("kwargs", [
    dict(kernel_size=3, stride=2), dict(kernel_size=2, stride=1),
    dict(kernel_size=2, stride=2, indice_key="p"),
    dict(kernel_size=2, stride=2, subm=True),
    dict(kernel_size=2, stride=2, algo="native"),
])
def test_other_pools_raise(kwargs):
    """The pools the JAX package sends to its native rulebook path now run
    it in the port too, on integer-valued features (so maxima tie): sites,
    counts and ``keys_sorted`` exactly, features and the grads of
    ``sum(out * cot)`` within 1e-6 of max|ref| (ties split as ``jnp.max``
    and ``jnp.maximum`` split them).  A subm pool of even kernel size
    raises in both packages."""
    import spconv_tpu

    shape = (9, 10, 11)
    feats, inds = _input(7, shape, 150, 3, 384, 1)
    feats = np.round(feats * 2).astype(np.float32)
    jm, tm = spconv_tpu.SparseMaxPool3d(**kwargs), SparseMaxPool3d(**kwargs)
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     shape, 1)
    tx = SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                          torch.from_numpy(inds), shape, 1)
    if kwargs.get("subm"):
        with pytest.raises(AssertionError, match="odd"):
            jm(jx)
        with pytest.raises(ValueError, match="odd"):
            tm(tx)
        return
    y = tm(tx)
    ref = jm(jx)
    np.testing.assert_array_equal(y.indices.numpy(), np.asarray(ref.indices))
    assert int(y.num_voxels) == int(ref.num_voxels)
    assert y.keys_sorted == ref.keys_sorted
    if "indice_key" in kwargs:
        assert y.indice_dict["p"].rank_slots
    cot = np.random.RandomState(8).randn(*y.features.shape).astype(
        np.float32)
    (y.features * torch.from_numpy(cot)).sum().backward()
    grad = jax.grad(lambda f: jnp.sum(
        jm(jx.replace_feature(f)).features * cot))(jnp.asarray(feats))
    for got, want in ((y.features, ref.features), (tx.features.grad, grad)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize(
    "shape,batch,out_bound,dtype",
    [
        ((9, 21, 17), 1, 1024, "float32"),
        ((9, 21, 17), 2, 128, "float32"),
        ((8, 16, 16), 2, 1024, "bfloat16"),
    ],
)
def test_pool2_seg_mean_matches_jax(shape, batch, out_bound, dtype):
    """``pool2_seg(mode="mean")`` against the JAX package's: coordinates and
    counts exactly; the f32 sums over the children divided by their number
    within 1e-6*max|ref| (f32) or one bf16 rounding (bf16)."""
    feats, inds = _input(4, shape, 500, 6, 1100, batch)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jf, ji, jn, jt = jax_pool2_seg(
        jnp.asarray(feats, jdt), jnp.asarray(inds), spatial_shape=shape,
        batch_size=batch, out_bound=out_bound, mode="mean")
    tf, ti, tn, tt = pool2_seg(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(inds), spatial_shape=shape, batch_size=batch,
        out_bound=out_bound, mode="mean")
    assert tf.dtype == getattr(torch, dtype)
    ref = np.asarray(jf.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(tf.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(tf.float().numpy(), ref, rtol=2**-7,
                                   atol=0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn) and int(tt) == int(jt)


@pytest.mark.parametrize("out_bound", [2048, 256])
def test_pool2_seg_mean_grad_matches_jax(out_bound):
    """The mean's gradient (each child gets its output's over the number
    of children; children of no kept output get 0) against ``jax.grad``,
    f32 within 1e-6*max|ref|."""
    shape, batch, c = (9, 21, 17), 2, 4
    feats, inds = _input(5, shape, 1500, c, 3200, batch)
    cot = np.random.RandomState(6).randn(out_bound, c).astype(np.float32)

    def loss(f):
        out = jax_pool2_seg(f, jnp.asarray(inds), spatial_shape=shape,
                            batch_size=batch, out_bound=out_bound,
                            mode="mean")[0]
        return jnp.sum(out * cot)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    x = torch.from_numpy(feats).requires_grad_()
    out = pool2_seg(x, torch.from_numpy(inds), spatial_shape=shape,
                    batch_size=batch, out_bound=out_bound, mode="mean")[0]
    (out * torch.from_numpy(cot)).sum().backward()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert not x.grad[torch.from_numpy(inds[:, 0] < 0)].any()
