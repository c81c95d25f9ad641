"""The native path's rulebooks and keys in the PyTorch port against the JAX
package, integer for integer.

Every builder of ``spconv_tpu_torch.ops.rulebook`` (subm, regular and
transposed conv, the 2x pool, ``get_indice_pairs``) on one seeded input of
two batch items whose rows are in no key order, at the JAX test suite's
geometries, an ``out_bound`` below the true count included; then the int64
keys of a grid past ``_KEY32_LIMIT`` (lowered in both packages, as
``tests/test_round2_fixes.py`` lowers the JAX one, and a real
``[160, 2048, 2048]`` grid) against the JAX package's two-word keys.  The
JAX builders are jitted per static shape, so every case shares one buffer
size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops import rulebook as JR

from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import rulebook as TR

from utils import generate_sparse_data

SHAPE = (9, 10, 11)
BATCH = 2
NBUF = 200
FIELDS = ("pair_fwd", "pair_bwd", "out_indices", "num_out", "num_out_total")

SUBM = {
    "k3": ((3, 3, 3), (1, 1, 1)),
    "k5": ((5, 5, 5), (1, 1, 1)),
    "k313": ((3, 1, 3), (1, 1, 1)),
    "dil2": ((3, 3, 3), (2, 2, 2)),
}
# (ksize, stride, padding, dilation, output_padding, transposed, out_bound)
CONV = {
    "k3s2p1": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), None, False,
               None),
    "k2s2p0": ((2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1), None, False,
               None),
    "k311s211": ((3, 1, 1), (2, 1, 1), (0, 0, 0), (1, 1, 1), None, False,
                 None),
    "dilated": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (2, 2, 2), None, False,
                None),
    "t_k2s2": ((2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1), (0, 0, 0), True,
               1600),
    "t_k3s2p1op1": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), (1, 1, 1),
                    True, 1600),
    "cut": ((3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), None, False, 50),
}


def _rows(seed=0, shape=SHAPE, batch=BATCH, n=80, nbuf=NBUF):
    """``[nbuf, ndim+1]`` int32 coordinates of ``n`` sites per batch item,
    -1 rows mixed in, in a seeded random row order."""
    rng = np.random.RandomState(seed)
    _, inds = generate_sparse_data(shape, n, 3, batch_size=batch, rng=rng)
    ib = np.full((nbuf, len(shape) + 1), -1, np.int32)
    ib[:len(inds)] = inds
    return ib[rng.permutation(nbuf)]


def _equal(jax_rec, port_rec):
    for f in FIELDS:
        want = np.asarray(getattr(jax_rec, f))
        got = getattr(port_rec, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert port_rec.pair_fwd.dtype == port_rec.pair_bwd.dtype == torch.int32
    for f in ("is_subm", "spatial_shape", "out_spatial_shape", "ksize",
              "stride", "padding", "dilation", "transposed"):
        assert getattr(port_rec, f) == getattr(jax_rec, f), f


@pytest.mark.parametrize("name", list(SUBM))
def test_subm_rulebook_matches_jax(name):
    """Pairs, sites and counts bit for bit; the centre offset is the
    identity of the active rows and ``pair_bwd`` the offset-reversed
    ``pair_fwd``."""
    ksize, dil = SUBM[name]
    inds = _rows()
    kw = dict(spatial_shape=SHAPE, batch_size=BATCH, ksize=ksize,
              dilation=dil)
    got = TR.build_subm_rulebook(torch.from_numpy(inds), **kw)
    _equal(JR.build_subm_rulebook(jnp.asarray(inds), **kw), got)
    assert torch.equal(got.pair_bwd, got.pair_fwd.flip(0))
    with pytest.raises(ValueError, match="odd"):
        TR.build_subm_rulebook(torch.from_numpy(inds), spatial_shape=SHAPE,
                               batch_size=BATCH, ksize=(2, 2, 2),
                               dilation=dil)


@pytest.mark.parametrize("name", list(CONV))
def test_conv_rulebook_matches_jax(name):
    """Regular and transposed rulebooks bit for bit; with ``cut`` the bound
    keeps the smallest output keys and drops the rest's pairs, and
    ``pair_bwd`` is ``pair_fwd``'s mirror at every offset."""
    ks, st_, pad, dil, opad, transposed, bound = CONV[name]
    inds = _rows()
    kw = dict(spatial_shape=SHAPE, batch_size=BATCH, ksize=ks, stride=st_,
              padding=pad, dilation=dil, out_padding=opad,
              transposed=transposed, out_bound=bound)
    got = TR.build_conv_rulebook(torch.from_numpy(inds), **kw)
    _equal(JR.build_conv_rulebook(jnp.asarray(inds), **kw), got)
    fwd, bwd = got.pair_fwd.numpy(), got.pair_bwd.numpy()
    for k in range(fwd.shape[0]):
        mirror = np.full(bwd.shape[1], -1, np.int32)
        hit = fwd[k] >= 0
        mirror[fwd[k, hit]] = np.nonzero(hit)[0]
        np.testing.assert_array_equal(bwd[k], mirror)
    if name == "cut":
        assert int(got.num_out_total) > bound == int(got.num_out)


@pytest.mark.parametrize("bound", [None, 40])
def test_pool2_rulebook_matches_jax(bound):
    """The 2x pool's rulebook bit for bit: ``pair_fwd`` slots in rank
    order (the stable sort's), ``pair_bwd`` only in row 0, and
    ``rank_slots`` set."""
    inds = _rows(1)
    kw = dict(spatial_shape=SHAPE, batch_size=BATCH, out_bound=bound)
    got = TR.build_pool2_rulebook(torch.from_numpy(inds), **kw)
    _equal(JR.build_pool2_rulebook(jnp.asarray(inds), **kw), got)
    assert got.rank_slots and not (got.pair_bwd[1:] >= 0).any()


@pytest.mark.parametrize("subm,transpose", [(True, False), (False, False),
                                            (False, True)])
def test_get_indice_pairs_matches_jax(subm, transpose):
    inds = _rows(2)
    args = (BATCH, SHAPE, (3, 3, 3), (2, 2, 2) if not subm else (1, 1, 1),
            (1, 1, 1), (1, 1, 1))
    kw = dict(subm=subm, transpose=transpose,
              out_bound=1600 if transpose else None)
    _equal(JR.get_indice_pairs(jnp.asarray(inds), *args, **kw),
           TR.get_indice_pairs(torch.from_numpy(inds), *args, **kw))


def test_sort_with_ids_is_stable():
    keys = torch.tensor([3, 1, 3, 0, 1, 3], dtype=torch.int64)
    sk, order = TC.sort_with_ids(keys)
    jk, jo = JC.sort_with_ids(jnp.asarray(keys.numpy(), jnp.int32))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))


def _pair_key(jkeys, shape, batch):
    """The JAX package's ``[N, 2]`` (hi, lo) keys read as one number."""
    _, lo_prod, _ = JC._split_dims(shape, batch)
    jkeys = np.asarray(jkeys).astype(np.int64)
    return jkeys[:, 0] * lo_prod + jkeys[:, 1]


@pytest.fixture
def low_key_limit(monkeypatch):
    """Both packages switch to their large-grid keys past 2**10 sites."""
    monkeypatch.setattr(JC, "_KEY32_LIMIT", 2 ** 10)
    monkeypatch.setattr(TC, "_KEY32_LIMIT", 2 ** 10)


def test_int64_keys_match_jax_pair_keys(low_key_limit):
    """Past the limit the port's key is one int64, the JAX package's
    two-word key read as ``hi * lo_prod + lo``: equal numbers, so the same
    order; the sentinel the same; delinearize inverts it."""
    inds = _rows(3)
    assert TC.use_int64_keys(SHAPE, BATCH) and JC.use_pair_keys(SHAPE, BATCH)
    jk, js = JC.linearize(jnp.asarray(inds), SHAPE, BATCH)
    tk, ts = TC.linearize(torch.from_numpy(inds), SHAPE, BATCH)
    assert tk.dtype == torch.int64 and jk.ndim == 2
    np.testing.assert_array_equal(tk.numpy(), _pair_key(jk, SHAPE, BATCH))
    assert ts == int(_pair_key(np.asarray(js)[None], SHAPE, BATCH)[0])
    valid = torch.from_numpy(inds[:, 0] >= 0)
    np.testing.assert_array_equal(TC.delinearize(tk, SHAPE, valid).numpy(),
                                  inds)


@pytest.mark.parametrize("kind", ["subm", "conv", "pool2"])
def test_rulebooks_past_key_limit_match_jax(low_key_limit, kind):
    """Each builder on int64 keys against the JAX builder on two-word
    keys, bit for bit."""
    inds = _rows(4)
    j, t = jnp.asarray(inds), torch.from_numpy(inds)
    geo = dict(spatial_shape=SHAPE, batch_size=BATCH)
    if kind == "subm":
        kw = dict(geo, ksize=(3, 3, 3), dilation=(1, 1, 1))
        _equal(JR.build_subm_rulebook(j, **kw),
               TR.build_subm_rulebook(t, **kw))
    elif kind == "conv":
        kw = dict(geo, ksize=(3, 3, 3), stride=(2, 2, 2),
                  padding=(1, 1, 1), dilation=(1, 1, 1), out_bound=60)
        _equal(JR.build_conv_rulebook(j, **kw),
               TR.build_conv_rulebook(t, **kw))
    else:
        _equal(JR.build_pool2_rulebook(j, **geo),
               TR.build_pool2_rulebook(t, **geo))


def test_key_capacity_matches_jax():
    """A real ``[160, 2048, 2048]`` grid of batch 4 (2.7e9 sites) has int64
    keys equal to the JAX pair keys read as one number; where the JAX
    package's two-word keys run out, both raise."""
    shape, batch = (160, 2048, 2048), 4
    rng = np.random.RandomState(5)
    inds = np.stack([rng.randint(0, s, 50) for s in (batch, *shape)],
                    axis=1).astype(np.int32)
    jk, _ = JC.linearize(jnp.asarray(inds), shape, batch)
    tk, ts = TC.linearize(torch.from_numpy(inds), shape, batch)
    assert ts == batch * 160 * 2048 * 2048
    np.testing.assert_array_equal(tk.numpy(), _pair_key(jk, shape, batch))
    huge = (2 ** 20, 2 ** 20, 2 ** 20)
    with pytest.raises(NotImplementedError, match="two-word"):
        JC.linearize(jnp.zeros((1, 4), jnp.int32), huge, 1)
    with pytest.raises(NotImplementedError, match="two-word"):
        TC.linearize(torch.zeros((1, 4), dtype=torch.int32), huge, 1)
