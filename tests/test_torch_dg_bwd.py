"""The backward of the port's DG conv against the JAX package's Pallas
kernels, run in interpret mode on the CPU: the reversed match table (B1 with
``reverse=True``) and the conv's gradients (dgrad and wgrad, B3).  The CUDA
kernels are held against these plain versions in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas.dg_conv import build_dg_pos as jax_build_dg_pos
from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv as jax_dg_subm_conv

from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD

from test_torch_dg_conv import (DIL, KSIZE, KV, SHAPE, _jax_plans,
                                _jax_pos_to_port, _port_pos,
                                _port_pos_to_jax, _sorted_input)


@pytest.mark.parametrize("window", [384, 128])
def test_dg_pos_reverse_matches_jax(window):
    """B1 with ``reverse=True`` is exactly the Pallas table built from the
    backward plan (window 128 forces its sweep), and for this odd, so
    symmetric, kernel it is the forward table with its offset axis
    flipped."""
    _, inds = _sorted_input(0, 900, 4, 1024)
    keys_j, _ = JC.linearize(jnp.asarray(inds), SHAPE, 1)
    plans = _jax_plans(keys_j, window)
    if window == 128:
        assert int(np.max(np.asarray(plans[1].nw))) > 1
    pos_j = jax_build_dg_pos(
        keys_j, plans[1], ksize=KSIZE, dilation=DIL, spatial_shape=SHAPE,
        batch_size=1, window=window, reverse=True, interpret=True)
    rev = _port_pos(inds, reverse=True)
    assert rev.dtype == torch.int32 and tuple(rev.shape) == (KV, 1024)
    np.testing.assert_array_equal(rev.numpy(), _jax_pos_to_port(pos_j, 1024))
    assert torch.equal(rev, _port_pos(inds).flip(0))
    assert (rev[:, 900:] == -1).all()


@pytest.mark.parametrize("ksize,dilation", [((3, 3, 3), (1, 2, 1)),
                                            ((2, 3, 1), (1, 1, 1))])
def test_dg_pos_reverse_inverts_forward(ksize, dilation):
    """The reversed table inverts the forward one at every offset:
    ``pos[k, i] == j`` iff ``pos_rev[k, j] == i``.  Flipping the offset
    axis gives the same table only for an odd kernel; the even one here
    (not a subm kernel) shows that ``reverse`` negates displacements and
    does not reorder offsets."""
    _, inds = _sorted_input(5, 900, 4, 1024)
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    geom = dict(ksize=ksize, dilation=dilation, spatial_shape=SHAPE,
                batch_size=1)
    pos = TD.build_dg_pos(keys, **geom).numpy()
    rev = TD.build_dg_pos(keys, reverse=True, **geom).numpy()
    for k in range(pos.shape[0]):
        inv = np.full(pos.shape[1], -1, np.int32)
        hit = pos[k] >= 0
        inv[pos[k, hit]] = np.nonzero(hit)[0]
        np.testing.assert_array_equal(rev[k], inv)
    assert (pos >= 0).sum() > 900
    assert np.array_equal(rev, pos[::-1]) == all(k % 2 for k in ksize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 12])
def test_dg_conv_grads_match_jax(c, dtype):
    """The conv's autograd (``DGConvFn``: dgrad and wgrad through the
    reversed table) against ``jax.grad`` of the posmode Pallas conv, whose
    VJP runs ``_dg_bwd_kernel`` in interpret mode on its own reversed table.
    f32 within 5e-5*max|ref| (sums in another order); bf16 within
    1.6e-2*max|ref| (one bf16 rounding of each result, 2**-7 relative, plus
    order).  Invalid rows get exactly zero gradient."""
    k_out = 20
    feats, inds = _sorted_input(1, 700, c, 768)
    rng = np.random.RandomState(3)
    w = (rng.randn(k_out, *KSIZE, c) / np.sqrt(KV * c)).astype(np.float32)
    cot = rng.randn(768, k_out).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    pos_t = _port_pos(inds)
    keys_j, _ = JC.linearize(jnp.asarray(inds), SHAPE, 1)
    plans = _jax_plans(keys_j, 384)
    pos_j = _port_pos_to_jax(pos_t)

    def loss(f, ww):
        o = jax_dg_subm_conv(
            f, keys_j, ww, spatial_shape=SHAPE, batch_size=1, dilation=DIL,
            window=384, plans=plans, pos=pos_j, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(feats, jdt), jnp.asarray(w, jdt))

    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    out = TD.dg_subm_conv(x, wt, pos_t, _port_pos(inds, reverse=True))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == tdt and wt.grad.dtype == tdt
    tol = 5e-5 if dtype == "float32" else 1.6e-2
    for got, ref in ((x.grad, gx_j), (wt.grad, gw_j)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    assert not x.grad[700:].any()


def test_dg_wgrad_splits_fill_the_card():
    """Row splits: many at the wide stage-0 layers, few at the narrow late
    ones (one at 512 rows: a split holds at least 512), and at most 64 MB
    of f32 partials."""
    assert TD.wgrad_splits(125_952, 27, 64, 64) == 79
    assert TD.wgrad_splits(512, 27, 256, 256) == 1
    for n, c, k in ((125_952, 3, 64), (62_464, 96, 96), (4_608, 192, 192),
                    (10**6, 256, 256)):
        s = TD.wgrad_splits(n, 27, c, k)
        assert s >= 1 and s * 27 * c * k * 4 <= 64 << 20
