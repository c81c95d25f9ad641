"""The port's DG conv (match table B1 and gather-GEMM B2) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.  The CUDA
kernels are held against these plain versions in ``test_torch_cuda.py``.

The JAX match table is ``[n_tiles, round8(kv), 128]``; the port's
``[kv, N]`` equals ``pos_jax[:, :kv, :].transpose(1, 0, 2)
.reshape(kv, -1)[:, :N]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas import sorted_conv as SK
from spconv_tpu.ops.pallas.dg_conv import build_dg_pos as jax_build_dg_pos
from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv as jax_dg_subm_conv

from spconv_tpu_torch import SparseConvTensor, SubMConv3d
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD

from utils import generate_sparse_data

SHAPE = (6, 17, 23)
KSIZE = (3, 3, 3)
DIL = (1, 1, 1)
KV = 27


def _sorted_input(seed, n, c, nbuf, shape=SHAPE):
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n, c, rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, inds.shape[1]), -1, np.int32)
    fb[:n] = feats[order]
    ib[:n] = inds[order]
    return fb, ib


def _jax_plans(keys, window):
    deltas, _ = SK.subm_key_deltas(KSIZE, DIL, SHAPE)
    groups = SK.sk_groups(KSIZE, include_center=True)
    sent = int(np.prod(SHAPE))
    np_t, n_pad = SK._n_pad_for(keys.shape[0], 128, window)
    return SK.build_sk_plans(
        SK._pad_rows(keys, np_t, sent), sent, deltas, groups, tile=128,
        window=window, n_pad=n_pad, align=128)


def _jax_pos_to_port(pos_jax, n):
    p = np.asarray(pos_jax)[:, :KV, :]
    return p.transpose(1, 0, 2).reshape(KV, -1)[:, :n]


def _port_pos_to_jax(pos_t):
    """Inverse of :func:`_jax_pos_to_port` (N a multiple of 128); the
    offset rows that pad kv to a multiple of 8 match nothing."""
    kv, n = pos_t.shape
    p = np.full((-(-kv // 8) * 8, n), -1, np.int32)
    p[:kv] = pos_t.numpy()
    return jnp.asarray(p.reshape(p.shape[0], n // 128, 128)
                       .transpose(1, 0, 2))


def _port_pos(inds):
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    return TD.build_dg_pos(keys, ksize=KSIZE, dilation=DIL,
                           spatial_shape=SHAPE, batch_size=1)


def test_subm_key_deltas_match_jax():
    d_j, disp_j = SK.subm_key_deltas((3, 1, 5), (1, 2, 1), (7, 9, 11))
    d_t, disp_t = TD.subm_key_deltas((3, 1, 5), (1, 2, 1), (7, 9, 11))
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(disp_t, disp_j)


@pytest.mark.parametrize("window", [384, 128])
def test_dg_pos_plain_matches_jax(window):
    """B1's plain version is exactly the Pallas match table; window 128
    forces the JAX kernel's multi-window sweep."""
    _, inds = _sorted_input(0, 900, 4, 1024)
    keys_j, _ = JC.linearize(jnp.asarray(inds), SHAPE, 1)
    plans = _jax_plans(keys_j, window)
    if window == 128:
        assert int(np.max(np.asarray(plans[0].nw))) > 1
    pos_j = jax_build_dg_pos(
        keys_j, plans[0], ksize=KSIZE, dilation=DIL, spatial_shape=SHAPE,
        batch_size=1, window=window, interpret=True)
    pos_t = _port_pos(inds)
    assert pos_t.dtype == torch.int32 and tuple(pos_t.shape) == (KV, 1024)
    np.testing.assert_array_equal(pos_t.numpy(),
                                  _jax_pos_to_port(pos_j, 1024))
    # sentinel rows match nothing
    assert (pos_t[:, 900:] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 12])
def test_dg_fwd_plain_matches_jax(c, dtype):
    """B2's plain version against the posmode Pallas forward, at C = 3 (the
    first layer) and a C that is not a multiple of 8.  f32 within
    1e-5*max|ref| + 1e-6 (summation order); bf16 within 1.6e-2*max|ref|
    (one bf16 rounding of the output, 2**-7 relative, plus order)."""
    k_out = 20
    feats, inds = _sorted_input(1, 700, c, 768)
    rng = np.random.RandomState(2)
    w = (rng.randn(k_out, *KSIZE, c) / np.sqrt(KV * c)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    # the match table (held equal to the JAX one above) feeds both sides
    pos_t = _port_pos(inds)
    keys_j, _ = JC.linearize(jnp.asarray(inds), SHAPE, 1)
    ref = jax_dg_subm_conv(
        jnp.asarray(feats, jdt), keys_j, jnp.asarray(w, jdt),
        spatial_shape=SHAPE, batch_size=1, dilation=DIL, window=384,
        plans=_jax_plans(keys_j, 384), pos=_port_pos_to_jax(pos_t),
        interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))

    with torch.no_grad():
        out = TD.dg_subm_conv(torch.from_numpy(feats).to(tdt),
                              torch.from_numpy(w).to(tdt), pos_t)
    assert out.dtype == tdt and tuple(out.shape) == (768, k_out)
    out = out.float().numpy()
    scale = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * scale + 1e-6)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1.6e-2 * scale)
    assert not out[700:].any()


def test_stage_reuses_match_table():
    """The second conv of an indice_key stage reuses the first's table;
    a layer whose geometry differs under the same key raises."""
    feats, inds = _sorted_input(3, 500, 4, 512)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         SHAPE, 1, keys_sorted=True)
    g = torch.Generator().manual_seed(0)
    a = SubMConv3d(4, 8, 3, indice_key="s", generator=g)
    b = SubMConv3d(8, 8, 3, indice_key="s", generator=g)
    with torch.no_grad():
        y = a(x)
        rec = y.indice_dict["s"]
        z = b(y)
        assert z.indice_dict["s"] is rec
        np.testing.assert_array_equal(rec.pos.numpy(), _port_pos(inds).numpy())
        with pytest.raises(ValueError, match="reuse mismatch"):
            SubMConv3d(8, 8, 5, indice_key="s", generator=g)(z)
        with pytest.raises(ValueError, match="reuse mismatch"):
            SubMConv3d(8, 8, 3, dilation=2, indice_key="s", generator=g)(z)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_subm_conv_epilogue_matches_jax(act):
    """Bias, residual add and activation after the conv, against the JAX
    layer with the same weights (its CPU route, the native gather)."""
    import spconv_tpu
    from spconv_tpu.checkpoint import state_dict

    from spconv_tpu_torch.checkpoint import load_jax_state_dict

    feats, inds = _sorted_input(7, 400, 5, 512)
    add = np.random.RandomState(8).randn(512, 6).astype(np.float32)
    add[400:] = 0
    kw = dict(act_type=act, act_alpha=0.1, indice_key="e")
    jconv = spconv_tpu.SubMConv3d(5, 6, 3, **kw)
    tconv = SubMConv3d(5, 6, 3, **kw)
    load_jax_state_dict(tconv, state_dict(jconv))
    jx = spconv_tpu.SparseConvTensor(jnp.asarray(feats), jnp.asarray(inds),
                                     SHAPE, 1, keys_sorted=True)
    ref = np.asarray(jconv(jx, jx.replace_feature(jnp.asarray(add)))
                     .features)
    tx = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                          SHAPE, 1, keys_sorted=True)
    with torch.no_grad():
        got = tconv(tx, SparseConvTensor(torch.from_numpy(add),
                                         tx.indices, SHAPE, 1)).features
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max() + 1e-6)
    assert not got[400:].any()


def test_wrappers_refuse_grad_and_bad_inputs():
    feats, inds = _sorted_input(4, 100, 4, 128)
    pos = _port_pos(inds)
    w = torch.zeros((KV, 4, 8))
    x = torch.from_numpy(feats)
    with pytest.raises(NotImplementedError, match="backward"):
        TD.dg_fwd(x.requires_grad_(), w, pos)
    x = x.detach()
    with pytest.raises(ValueError, match="dtype"):
        TD.dg_fwd(x, w.double(), pos)
    with pytest.raises(ValueError, match="pos is"):
        TD.dg_fwd(x, w, pos[:, :64])
    with pytest.raises(ValueError, match="int32"):
        TD.build_dg_pos(torch.zeros(8, dtype=torch.int64), ksize=KSIZE,
                        dilation=DIL, spatial_shape=SHAPE, batch_size=1)
