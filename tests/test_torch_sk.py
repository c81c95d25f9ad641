"""``SubMConv3d(algo="sk")`` in the port against the JAX package's sorted-key
conv (``sk_subm_conv``: ``_sk_fwd_kernel`` forward, ``_sk_bwd_kernel``
backward), run in interpret mode on the CPU.  The port computes the same
function through the DG match tables and kernels, so ``"sk"`` and ``"dg"``
agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas.sorted_conv import sk_subm_conv

from spconv_tpu_torch import SparseConvTensor, SubMConv3d

from utils import generate_sparse_data


def _sorted_input(seed, shape, n, c, nbuf, batch):
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
    return fb, ib, len(inds)


def _port_conv(c, k_out, ksize, dilation, w, algo):
    conv = SubMConv3d(c, k_out, ksize, dilation=dilation, bias=False,
                      indice_key="s", algo=algo, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    return conv


def _port_fwd_bwd(conv, feats, inds, shape, batch, cot):
    x = SparseConvTensor(torch.from_numpy(feats).requires_grad_(),
                         torch.from_numpy(inds), shape, batch,
                         keys_sorted=True)
    out = conv(x).features
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), x.features.grad, conv.weight.grad


@pytest.mark.parametrize(
    "shape,ksize,dilation,batch",
    [
        ((11, 13, 17), (3, 3, 3), (1, 1, 1), 1),
        ((11, 13, 17), (3, 1, 3), (1, 1, 1), 1),
        ((15, 15, 15), (3, 3, 3), (2, 1, 2), 1),
        ((9, 40, 40), (3, 3, 3), (1, 1, 1), 2),
    ],
)
def test_sk_conv_matches_jax(shape, ksize, dilation, batch):
    """Forward, input and weight gradients against ``sk_subm_conv`` and its
    ``jax.grad``, at the shapes of ``tests/test_sorted_conv.py``.  f32:
    forward within 1e-5*max|ref|, gradients within 5e-5*max|ref| (sums in
    another order).  Invalid rows get zero gradient."""
    c, k_out = 8, 8
    feats, inds, n = _sorted_input(0, shape, 250, c, 384 * batch, batch)
    rng = np.random.RandomState(1)
    w = (rng.randn(k_out, *ksize, c) * 0.1).astype(np.float32)
    cot = rng.randn(feats.shape[0], k_out).astype(np.float32)
    inds_j = jnp.asarray(inds)
    keys_j, _ = JC.linearize(inds_j, shape, batch)
    valid = jnp.asarray(inds[:, :1] >= 0)

    def fwd(f, ww):
        # the JAX layer's own epilogue masks invalid rows the same way
        return jnp.where(valid, sk_subm_conv(
            f, inds_j, keys_j, ww, spatial_shape=shape, batch_size=batch,
            dilation=dilation, tile=128, window=256, interpret=True,
            fallback=False), 0)

    out_j, vjp = jax.vjp(fwd, jnp.asarray(feats), jnp.asarray(w))
    gx_j, gw_j = vjp(jnp.asarray(cot))

    conv = _port_conv(c, k_out, ksize, dilation, w, "sk")
    out, gx, gw = _port_fwd_bwd(conv, feats, inds, shape, batch, cot)
    for got, ref, tol in ((out, out_j, 1e-5), (gx, gx_j, 5e-5),
                          (gw, gw_j, 5e-5)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    assert not gx[n:].any()


def test_sk_and_dg_are_bit_equal():
    """``"sk"`` runs the DG tables and kernels: same output and same
    gradients, bit for bit."""
    shape, c, k_out = (11, 13, 17), 8, 12
    feats, inds, _ = _sorted_input(2, shape, 300, c, 384, 1)
    rng = np.random.RandomState(3)
    w = (rng.randn(k_out, 3, 3, 3, c) * 0.1).astype(np.float32)
    cot = rng.randn(384, k_out).astype(np.float32)
    runs = []
    for algo in ("sk", "dg"):
        conv = _port_conv(c, k_out, 3, 1, w, algo)
        runs.append(_port_fwd_bwd(conv, feats, inds, shape, 1, cot))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
