"""The port's ``pool2_seg`` and ``SparseMaxPool3d`` against the JAX
package's ``pool2_seg``: outputs, coordinates and counts must be exactly
equal (a max picks an input value, so no rounding enters)."""

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
    dict(kernel_size=2, stride=2, algo="sk"),
])
def test_other_pools_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        SparseMaxPool3d(**kwargs)
