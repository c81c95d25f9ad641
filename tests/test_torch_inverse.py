"""The port's inverse conv and the strided conv's backward against the JAX
package on the CPU: the divide table (against a brute-force enumeration of
its definition, and as the exact inverse of the affine table), the inverse
conv's forward against ``dg_regular_conv(inverse=True)`` and
``sk_regular_conv(inverse=True)`` run in interpret mode, and the strided
and inverse convs' gradients against ``jax.grad`` of the same functions.
The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas.dg_conv import dg_regular_conv as jax_dg_regular
from spconv_tpu.ops.pallas.sorted_conv import \
    sk_regular_conv as jax_sk_regular
from spconv_tpu.ops.rulebook import build_conv_outputs as jax_outputs

from spconv_tpu_torch import (SparseConv3d, SparseConvTensor,
                              SparseInverseConv3d, SparseConvolution)
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops.rulebook import build_conv_outputs

from test_torch_strided import GEOMS, _case

F32_FWD_TOL = 1e-6   # f32 forward, of max|ref|: sums in another order
BF16_TOL = 1.6e-2    # one bf16 rounding of the output (2**-7) plus order
GRAD_TOL = 5e-5      # f32 grads, of max|ref| per tensor (ROADMAP.md)


def _keys(name, **kw):
    """The case's input rows, output sites and both key sets, on the
    port's side."""
    feats, inds, geom, bound, out_shape = _case(name, **kw)
    out_inds, out_keys, _, _ = build_conv_outputs(
        torch.from_numpy(inds), out_bound=bound, **geom)
    in_keys, _ = TC.linearize(torch.from_numpy(inds), geom["spatial_shape"],
                              geom["batch_size"])
    tgeom = dict(ksize=geom["ksize"], stride=geom["stride"],
                 padding=geom["padding"], dilation=geom["dilation"],
                 in_shape=geom["spatial_shape"], out_shape=out_shape,
                 batch_size=geom["batch_size"])
    return feats, inds, out_inds.numpy(), in_keys, out_keys, tgeom, bound


def _brute_force_divide(inds, out_inds, in_shape, out_shape, ksize, stride,
                        padding, dil):
    """Row of the output site at ``(c - off_k * dil + pad) / stride`` for
    every input site ``c`` and offset ``k``, where that divides exactly and
    lies on the output grid, by a dictionary of output sites: the table's
    definition, written out."""
    rows = {tuple(r): o for o, r in enumerate(out_inds) if r[0] >= 0}
    offs = list(itertools.product(*[range(k) for k in ksize]))
    table = np.full((len(offs), len(inds)), -1, np.int32)
    for i, ic in enumerate(inds):
        if ic[0] < 0:
            continue
        for k, off in enumerate(offs):
            oc = []
            for a in range(len(in_shape)):
                t = int(ic[a + 1]) - (off[a] * dil[a] - padding[a])
                if t < 0 or t % stride[a] or t // stride[a] >= out_shape[a]:
                    break
                oc.append(t // stride[a])
            else:
                table[k, i] = rows.get((int(ic[0]),) + tuple(oc), -1)
    return table


@pytest.mark.parametrize("name", list(GEOMS))
def test_divide_table_matches_definition(name):
    """The divide table equals its definition exactly, at the CenterPoint
    downsample and ``conv_out`` geometries, an even kernel, dilation, two
    batches and a cut output set (sites past the bound are -1)."""
    _, inds, out_inds, in_keys, out_keys, geom, _ = _keys(name)
    div = TD.build_dg_pos_divide(in_keys, out_keys, **geom)
    want = _brute_force_divide(
        inds, out_inds, geom["in_shape"], geom["out_shape"], geom["ksize"],
        geom["stride"], geom["padding"], geom["dilation"])
    assert div.dtype == torch.int32
    np.testing.assert_array_equal(div.numpy(), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("name", list(GEOMS))
def test_divide_table_inverts_affine(name):
    """For every offset ``k``: ``div[k, affine[k, o]] == o`` wherever
    ``affine[k, o] >= 0``, and nothing else is set."""
    _, _, _, in_keys, out_keys, geom, _ = _keys(name)
    aff = TD.dg_pos_affine_plain(in_keys, out_keys, **geom).numpy()
    div = TD.dg_pos_divide_plain(in_keys, out_keys, **geom).numpy()
    assert div.shape == (aff.shape[0], in_keys.shape[0])
    for k in range(aff.shape[0]):
        inv = np.full(div.shape[1], -1, np.int32)
        hit = aff[k] >= 0
        inv[aff[k, hit]] = np.nonzero(hit)[0]
        np.testing.assert_array_equal(div[k], inv)


def _weights(seed, k_out, ksize, c):
    return (np.random.RandomState(seed).randn(k_out, *ksize, c)
            / np.sqrt(c * np.prod(ksize))).astype(np.float32)


def _layers(geom, bound, c, c_mid, c_out, w_down, w_up, algo, dtype):
    """A bias-free strided conv and its inverse under one key."""
    kw = dict(bias=False, indice_key="d", algo=algo, dtype=dtype,
              device="cpu")
    down = SparseConv3d(c, c_mid, geom["ksize"], stride=geom["stride"],
                        padding=geom["padding"], dilation=geom["dilation"],
                        out_bound=bound, **kw)
    up = SparseInverseConv3d(c_mid, c_out, geom["ksize"], **kw)
    with torch.no_grad():
        down.weight.copy_(torch.from_numpy(w_down).to(dtype))
        up.weight.copy_(torch.from_numpy(w_up).to(dtype))
    return down, up


def _jax_keys(inds, geom, bound, out_shape):
    _, out_keys, _, _ = jax_outputs(
        jnp.asarray(inds), out_bound=bound, spatial_shape=geom["in_shape"],
        batch_size=geom["batch_size"], ksize=geom["ksize"],
        stride=geom["stride"], padding=geom["padding"],
        dilation=geom["dilation"])
    in_keys, _ = JC.linearize(jnp.asarray(inds), geom["in_shape"],
                              geom["batch_size"])
    return in_keys, out_keys


def _jax_fn(fn, inds, geom, bound, inverse):
    """``f(features, weight)`` of the JAX regular or inverse conv in
    interpret mode, on the case's keys."""
    in_keys, out_keys = _jax_keys(inds, geom, bound, geom["out_shape"])

    def f(feats, w):
        out, _, _ = fn(
            feats, in_keys, out_keys, w, in_shape=geom["in_shape"],
            out_shape=geom["out_shape"], batch_size=geom["batch_size"],
            stride=geom["stride"], padding=geom["padding"],
            dilation=geom["dilation"], inverse=inverse, interpret=True)
        return out

    return f


def _inverse_input(y, c_mid, dtype, seed):
    """Random features on the strided conv's output sites."""
    f = np.random.RandomState(seed).randn(y.indices.shape[0], c_mid)
    f = (f * (y.indices.numpy()[:, :1] >= 0)).astype(np.float32)
    return f, y.replace_feature(torch.from_numpy(f).to(dtype))


# each case runs the Pallas kernel in interpret mode (5-15 s on the CPU)
@pytest.mark.parametrize("name,dtype,algo", [
    ("k3s2p1", "float32", "dg"), ("k3s2p1", "bfloat16", "dg"),
    ("k311s211p0", "float32", "dg"), ("k3s2p1", "float32", "sk")])
def test_inverse_conv_matches_jax(name, dtype, algo):
    """``SparseInverseConv3d`` after a ``SparseConv3d`` under the same key
    against ``dg_regular_conv`` / ``sk_regular_conv`` with
    ``inverse=True``: the output sites are the strided conv's input sites,
    on its input grid; f32 within 1e-6*max|ref|, bf16 within
    1.6e-2*max|ref|.  The divide table is built once, by the inverse conv,
    and cached on the record."""
    c, c_mid, c_out = 5, 16, 8
    feats, inds, geom_s, bound, out_shape = _case(name, c=c, seed=1, n=200,
                                                  nbuf=256)
    geom = dict(ksize=geom_s["ksize"], stride=geom_s["stride"],
                padding=geom_s["padding"], dilation=geom_s["dilation"],
                in_shape=geom_s["spatial_shape"], out_shape=out_shape,
                batch_size=geom_s["batch_size"])
    w_down = _weights(2, c_mid, geom["ksize"], c)
    w_up = _weights(3, c_out, geom["ksize"], c_mid)
    tdt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    down, up = _layers(geom_s, bound, c, c_mid, c_out, w_down, w_up, algo,
                       tdt)
    x = SparseConvTensor(torch.from_numpy(feats).to(tdt),
                         torch.from_numpy(inds), geom["in_shape"], 1,
                         keys_sorted=True)
    ns = "__skreg" if algo == "sk" else "__dgreg"
    with torch.no_grad():
        y = down(x)
        rec = y.indice_dict[f"{ns}__d"]
        assert rec.pos_div is None
        f_mid, y_in = _inverse_input(y, c_mid, tdt, 4)
        z = up(y_in)
    assert rec.pos_div is not None and rec.pos_div.shape == (
        int(np.prod(geom["ksize"])), 256)
    np.testing.assert_array_equal(z.indices.numpy(), inds)
    assert z.spatial_shape == geom["in_shape"] and z.keys_sorted
    assert int(z.num_voxels) == int(x.num_voxels)
    assert z.features.dtype == tdt
    fn = jax_sk_regular if algo == "sk" else jax_dg_regular
    ref = _jax_fn(fn, inds, geom, bound, True)(
        jnp.asarray(f_mid, jdt), jnp.asarray(w_up, jdt))
    ref = np.asarray(jnp.where((jnp.asarray(inds)[:, 0] >= 0)[:, None],
                               ref, 0).astype(jnp.float32))
    tol = F32_FWD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(z.features.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    assert np.abs(ref).max() > 0
    assert not z.features[~x.valid_mask].any()


def _grads_vs_jax(name, algo, inverse):
    """din and dW of the port's strided (or inverse) layer against
    ``jax.grad`` of the JAX function, f32, for ``sum(out * cot)``."""
    c, c_mid = 5, 16
    feats, inds, geom_s, bound, out_shape = _case(name, c=c, seed=5, n=200,
                                                  nbuf=256)
    geom = dict(ksize=geom_s["ksize"], stride=geom_s["stride"],
                padding=geom_s["padding"], dilation=geom_s["dilation"],
                in_shape=geom_s["spatial_shape"], out_shape=out_shape,
                batch_size=geom_s["batch_size"])
    w_down = _weights(6, c_mid, geom["ksize"], c)
    w_up = _weights(7, c, geom["ksize"], c_mid)
    down, up = _layers(geom_s, bound, c, c_mid, c, w_down, w_up, algo,
                       torch.float32)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         geom["in_shape"], 1, keys_sorted=True)
    if inverse:
        with torch.no_grad():
            y = down(x)
        f_in, t_in = _inverse_input(y, c_mid, torch.float32, 8)
        layer, w, valid_out = up, w_up, inds[:, 0] >= 0
    else:
        f_in, t_in, layer, w = feats, x, down, w_down
    t_in = t_in.replace_feature(t_in.features.clone().requires_grad_())
    out = layer(t_in)
    if not inverse:
        valid_out = out.indices.numpy()[:, 0] >= 0
    cot = np.random.RandomState(9).randn(*out.features.shape)
    cot = (cot * valid_out[:, None]).astype(np.float32)
    (out.features * torch.from_numpy(cot)).sum().backward()

    fn = _jax_fn(jax_sk_regular if algo == "sk" else jax_dg_regular, inds,
                 geom, bound, inverse)
    gx, gw = jax.grad(lambda f, ww: jnp.sum(fn(f, ww) * cot),
                      argnums=(0, 1))(jnp.asarray(f_in), jnp.asarray(w))
    for got, ref in ((t_in.features.grad, gx), (layer.weight.grad, gw)):
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape and np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max())
    assert not t_in.features.grad[~t_in.valid_mask].any()
    return layer


@pytest.mark.parametrize("algo", ["dg", "sk"])
def test_strided_grads_match_jax(algo):
    """The strided conv's din and dW (dgrad and wgrad through the divide
    table) against ``jax.grad`` of ``dg_regular_conv`` / ``sk_regular_conv``
    (``_dg_reg_conv_bwd`` / ``_sk_reg_conv_bwd``, divide probes), f32
    within 5e-5*max|ref| per tensor."""
    _grads_vs_jax("k3s2p1", algo, inverse=False)


def test_inverse_grads_match_jax():
    """The inverse conv's din and dW (through the affine table) against
    ``jax.grad`` of ``dg_regular_conv(inverse=True)`` (affine probes in
    ``_dg_reg_conv_bwd``), f32 within 5e-5*max|ref| per tensor."""
    _grads_vs_jax("k3s2p1", "dg", inverse=True)


def test_inverse_conv_refusals():
    """An inverse conv with no record under its key, another kernel size
    or another input grid or buffer raises ``ValueError``, and so does one
    under a transposed conv's record.  An ``algo="sk"`` inverse conv whose
    regular conv left only a ``__dgreg__`` record takes the native path on
    the rulebook rebuilt from it, as the JAX package's does: the DG
    inverse conv's result."""
    feats, inds, geom, bound, out_shape = _case("k3s2p1", c=4, seed=10)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         geom["spatial_shape"], 1, keys_sorted=True)
    kw = dict(indice_key="d", device="cpu")
    down = SparseConv3d(4, 8, 3, stride=2, padding=1, **kw)
    with torch.no_grad():
        y = down(x)
        with pytest.raises(ValueError, match="carries none"):
            SparseInverseConv3d(8, 4, 3, indice_key="e", device="cpu")(y)
        with pytest.raises(ValueError, match="kernel size"):
            SparseInverseConv3d(8, 4, 2, **kw)(y)
        x_rec = x.shadow_copy()
        x_rec.indice_dict.update(y.indice_dict)
        with pytest.raises(ValueError, match="input spatial shape"):
            SparseInverseConv3d(4, 4, 3, **kw)(x_rec)
        cut = SparseConvTensor(y.features[:128], y.indices[:128],
                               y.spatial_shape, 1,
                               indice_dict=y.indice_dict, keys_sorted=True)
        with pytest.raises(ValueError, match="input buffer N"):
            SparseInverseConv3d(8, 4, 3, **kw)(cut)
        # the record's own key namespace: "sk" reads __skreg__, and
        # without one rebuilds the rulebook from __dgreg__
        inv = SparseInverseConv3d(8, 4, 3, **kw)
        sk_inv = SparseInverseConv3d(8, 4, 3, algo="sk", **kw)
        sk_inv.load_state_dict(inv.state_dict())
        got, want = sk_inv(y), inv(y)
        assert want.spatial_shape == tuple(geom["spatial_shape"])
        assert got.keys_sorted and torch.equal(got.indices, want.indices)
        ref = want.features.numpy()
        np.testing.assert_allclose(got.features.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    with torch.no_grad():
        t = SparseConvolution(3, 4, 8, 3, stride=2, padding=1,
                              transposed=True, indice_key="t",
                              device="cpu")(x)
        with pytest.raises(ValueError, match="transposed"):
            SparseInverseConv3d(8, 4, 3, indice_key="t", device="cpu")(t)
    with pytest.raises(ValueError, match="indice_key"):
        SparseInverseConv3d(8, 4, 3, device="cpu")


def test_kernel1_inverse_is_a_1x1_conv_as_in_jax():
    """A kernel-1 ``SparseInverseConv3d`` is a plain 1x1 conv on its input's
    own sites in the JAX package (its stride is 1, so ``conv1x1`` holds);
    the port's is too: after a kernel-1 stride-2 ``SparseConv3d`` under the
    same key, the output keeps the downsampled sites, spatial shape and
    count, and its features match the JAX pair's within 1e-6*max|ref|."""
    import spconv_tpu
    from spconv_tpu.checkpoint import state_dict

    from spconv_tpu_torch import SparseSequential
    from spconv_tpu_torch.checkpoint import load_jax_state_dict

    feats, inds, geom, _, _ = _case("k3s2p1", c=4, seed=12)
    shape = tuple(geom["spatial_shape"])
    jnet = spconv_tpu.SparseSequential(
        spconv_tpu.SparseConv3d(4, 6, 1, stride=2, indice_key="k"),
        spconv_tpu.SparseInverseConv3d(6, 3, 1, indice_key="k"))
    tnet = SparseSequential(
        SparseConv3d(4, 6, 1, stride=2, indice_key="k", device="cpu"),
        SparseInverseConv3d(6, 3, 1, indice_key="k", device="cpu"))
    load_jax_state_dict(tnet, {k.replace("layers.", ""): v
                               for k, v in state_dict(jnet).items()})
    assert tnet[1].conv1x1 and not tnet[0].conv1x1
    ref = jnet(spconv_tpu.SparseConvTensor(
        jnp.asarray(feats), jnp.asarray(inds), shape, 1, keys_sorted=True))
    with torch.no_grad():
        x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                             shape, 1, keys_sorted=True)
        mid = tnet[0](x)
        out = tnet[1](mid)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(out.indices.numpy(), mid.indices.numpy())
    assert out.spatial_shape == tuple(ref.spatial_shape) == mid.spatial_shape
    assert int(out.num_voxels) == int(ref.num_voxels) == int(mid.num_voxels)
    want = np.asarray(ref.features)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(out.features.numpy(), want, rtol=0,
                               atol=F32_FWD_TOL * np.abs(want).max())
