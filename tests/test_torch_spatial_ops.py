"""The port's smaller ops against the JAX package on the CPU:
``sparse_add`` (sites and ``num_voxels`` exact, f32 features within
1e-6*max|ref|, bf16 at a stated bound), ``RemoveDuplicate`` (exact), and
``HashTable`` (int32 keys exact against the JAX table, int64 keys against
a Python dict, since JAX needs x64 on for them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu

import spconv_tpu_torch as st
from spconv_tpu_torch.functional import sparse_add, sparse_add_hash_based

from utils import generate_sparse_data

SHAPE = (6, 9, 11)
# f32 features of a site summed from up to three rows, in another order
TOL_F32 = 1e-6
# bf16: the JAX scatter-add and index_add_ both sum in bf16, in orders that
# differ where three rows meet; each of the two roundings that can then
# differ moves the sum by at most half a bf16 step of its magnitude
TOL_BF16 = 2 ** -7


def _operand(seed, n, nbuf, c=4, batch=2, shuffle=True, dtype=np.float32):
    """``n`` random sites of each batch item in a buffer of ``nbuf`` rows
    with invalid rows in the middle and at the tail, as (port, JAX)
    tensors."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(SHAPE, n, c, batch_size=batch,
                                       rng=rng)
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, 4), -1, np.int32)
    rows = rng.permutation(nbuf)[:len(inds)] if shuffle else \
        np.arange(len(inds))
    fb[rows], ib[rows] = feats, inds
    fb = fb.astype(dtype)
    return (st.SparseConvTensor(torch.from_numpy(fb.astype(np.float32)).to(
                torch.bfloat16 if dtype != np.float32 else torch.float32),
                torch.from_numpy(ib), SHAPE, batch),
            spconv_tpu.SparseConvTensor(jnp.asarray(fb), jnp.asarray(ib),
                                        SHAPE, batch))


def _check_same_tensor(t, j, tol):
    assert t.keys_sorted and t.spatial_shape == tuple(j.spatial_shape)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    assert int(t.num_voxels) == int(j.num_voxels)
    assert t.num_voxels.dtype == torch.int32 and t.num_voxels.dim() == 0
    ref = np.asarray(j.features).astype(np.float32)
    np.testing.assert_allclose(t.features.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("n_ops,out_bound", [(2, None), (3, None), (3, 160),
                                             (1, None)])
def test_sparse_add_matches_jax(n_ops, out_bound):
    """The union of two or three overlapping site sets (and one tensor
    alone), in key order, cut at ``out_bound`` where given: sites and
    counts exact, features within TOL_F32*max|ref|."""
    ops = [_operand(s, 70 + 15 * s, 200 + 20 * s) for s in range(n_ops)]
    got = sparse_add(*[t for t, _ in ops], out_bound=out_bound)
    want = spconv_tpu.sparse_add(*[j for _, j in ops], out_bound=out_bound)
    assert got.features.shape == tuple(want.features.shape)
    _check_same_tensor(got, want, TOL_F32)
    assert sparse_add_hash_based is sparse_add
    if out_bound is not None:
        assert int(got.num_voxels) == out_bound


def test_sparse_add_bf16_matches_jax():
    """Three bf16 operands on largely shared sites (150 of the 594 sites
    of each batch item each), summed in bf16 by both: within
    TOL_BF16*max|ref|."""
    ops = [_operand(s, 150, 400, dtype=jnp.bfloat16) for s in range(3)]
    got = sparse_add(*[t for t, _ in ops])
    want = spconv_tpu.sparse_add(*[j for _, j in ops])
    assert got.features.dtype == torch.bfloat16
    _check_same_tensor(got, want, TOL_BF16)


def test_sparse_add_rejects_mismatched_operands():
    a, _ = _operand(0, 40, 128)
    b, _ = _operand(1, 40, 128, c=5)
    with pytest.raises(ValueError, match="channel"):
        sparse_add(a, b)
    with pytest.raises(ValueError, match="at least one"):
        sparse_add()


def _with_duplicates(seed, n=120, dup=40, nbuf=256, batch=2):
    """``n`` sites, ``dup`` of them repeated with other features (twice
    for some), rows shuffled with invalid rows among them."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(SHAPE, n // batch, 3,
                                       batch_size=batch, rng=rng)
    pick = rng.randint(0, len(inds), dup)
    inds = np.concatenate([inds, inds[pick]])
    feats = np.concatenate([feats, rng.randn(dup, 3).astype(np.float32)])
    rows = rng.permutation(nbuf)[:len(inds)]
    fb = np.zeros((nbuf, 3), np.float32)
    ib = np.full((nbuf, 4), -1, np.int32)
    fb[rows], ib[rows] = feats, inds
    return (st.SparseConvTensor(torch.from_numpy(fb), torch.from_numpy(ib),
                                SHAPE, batch),
            spconv_tpu.SparseConvTensor(jnp.asarray(fb), jnp.asarray(ib),
                                        SHAPE, batch))


@pytest.mark.parametrize("seed", [0, 1])
def test_remove_duplicate_matches_jax(seed):
    """The first row of each site in input order kept, the rest
    invalidated and moved to the tail: features, indices and the count
    exact; then a subm conv runs on the result on the DG path."""
    tx, jx = _with_duplicates(seed)
    got = st.RemoveDuplicate()(tx)
    want = spconv_tpu.RemoveDuplicate()(jx)
    _check_same_tensor(got, want, 0.0)
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))
    keys = got.indices[:int(got.num_voxels)].long()
    keys = ((keys[:, 0] * SHAPE[0] + keys[:, 1]) * SHAPE[1]
            + keys[:, 2]) * SHAPE[2] + keys[:, 3]
    assert (keys[1:] > keys[:-1]).all()
    conv = st.SubMConv3d(3, 8, 3, indice_key="s", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = conv(got)
    assert "s" in y.indice_dict and type(y.indice_dict["s"]).__name__ \
        == "DGData"


def test_hash_table_int32_matches_jax():
    """Inserts with keys repeated within a call and across calls (existing
    entries win), past the capacity, and of the empty key; queries of
    present and absent keys; ``insert_exist_keys``, ``assign_arange_`` and
    ``items``: every result equal to the JAX table's."""
    rng = np.random.RandomState(0)
    k1 = rng.randint(0, 500, 300).astype(np.int32)
    v1 = rng.randint(-1000, 1000, 300).astype(np.int32)
    k2 = rng.randint(0, 700, 200).astype(np.int32)
    k2[:3] = np.iinfo(np.int32).max
    v2 = rng.randint(-1000, 1000, 200).astype(np.int32)
    q = rng.randint(-50, 800, 400).astype(np.int32)
    t = st.HashTable(320, device="cpu")
    j = spconv_tpu.HashTable(320)
    t = t.insert(torch.from_numpy(k1), torch.from_numpy(v1))
    j = j.insert(jnp.asarray(k1), jnp.asarray(v1))
    t = t.insert(torch.from_numpy(k2), torch.from_numpy(v2))
    j = j.insert(jnp.asarray(k2), jnp.asarray(v2))
    for a, b in zip(t.items(), j.items()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(t.query(torch.from_numpy(q)), j.query(jnp.asarray(q))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    upd = np.unique(q)
    t2, miss_t = t.insert_exist_keys(torch.from_numpy(upd),
                                     torch.from_numpy(-upd))
    j2, miss_j = j.insert_exist_keys(jnp.asarray(upd), jnp.asarray(-upd))
    np.testing.assert_array_equal(miss_t.numpy(), np.asarray(miss_j))
    np.testing.assert_array_equal(t2.values.numpy(), np.asarray(j2.values))
    t3, cnt_t = t2.assign_arange_()
    j3, cnt_j = j2.assign_arange_()
    assert int(cnt_t) == int(cnt_j) == 320 and t3.size == 320
    np.testing.assert_array_equal(t3.values.numpy(), np.asarray(j3.values))
    # no insert or update changed the table it was called on
    assert int(st.HashTable(8, device="cpu").items()[2]) == 0
    assert not torch.equal(t2.values, t.values)


def test_hash_table_int64_matches_dict():
    """int64 keys past 2**32 (f32 values): the table against a Python dict
    filled in the same order with first-writer-wins."""
    rng = np.random.RandomState(1)
    keys = [(rng.randint(0, 400, n) * 2 ** 33 + 7).astype(np.int64)
            for n in (150, 150)]
    vals = [rng.randn(150).astype(np.float32) for _ in range(2)]
    t = st.HashTable(1000, key_dtype=torch.int64, value_dtype=torch.float32,
                     device="cpu")
    ref = {}
    for k, v in zip(keys, vals):
        t = t.insert(torch.from_numpy(k), torch.from_numpy(v))
        for kk, vv in zip(k.tolist(), v.tolist()):
            ref.setdefault(kk, vv)
    tk, tv, cnt = t.items()
    assert int(cnt) == len(ref)
    assert tk[:len(ref)].tolist() == sorted(ref)
    np.testing.assert_array_equal(
        tv[:len(ref)].numpy(),
        np.array([ref[k] for k in sorted(ref)], np.float32))
    q = np.concatenate([keys[0][:50], keys[0][:50] + 1]).astype(np.int64)
    val, empty = t.query(torch.from_numpy(q))
    assert empty.tolist() == [k not in ref for k in q.tolist()]
    np.testing.assert_array_equal(
        val.numpy(), np.array([ref.get(k, 0.0) for k in q.tolist()],
                              np.float32))
