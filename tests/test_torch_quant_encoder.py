"""Whole-encoder int8 PTQ against the JAX package on the CPU: the
calibration pass (``observe_encoder_scales``), ``quantize_encoder`` (int8
weights and the state dict, bit for bit), the int8 encoder's output against
the JAX encoder's CPU route and against the fp encoder, and every layer
against the JAX kernel route (``dg_subm_conv_q`` / ``dg_regular_conv_q`` in
interpret mode, ~10 s each) on the same int8 input.

The two JAX int8 routes round differently at a tie (the kernel route
requantizes ``acc * (s_in * s_w / s_out) + b / s_out``, the CPU gather route
``(acc * s_in * s_w + b) / s_out``; listed in ROADMAP.md).  The port follows
the kernel route, so it is exact against that one layer by layer and held
against the CPU route's whole-net output within a stated bound."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import load_state_dict, state_dict
from spconv_tpu.models import SparseEncoder as JaxEncoder
from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas import sorted_conv as SK
from spconv_tpu.ops.pallas.dg_conv import (build_dg_pos, dg_regular_conv_q,
                                           dg_subm_conv_q)
from spconv_tpu.quantization import observe_encoder_scales as jax_observe
from spconv_tpu.quantization import quantize_encoder as jax_quantize

import spconv_tpu_torch as st
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.models import SparseEncoder
from spconv_tpu_torch.quantization import (QuantizedSparseBasicBlock,
                                           observe_encoder_scales,
                                           quantize_encoder, quantize_tensor)

from test_torch_centerpoint import _seeded_bn_state
from utils import generate_sparse_data

SHAPE = (8, 12, 12)
ENC = dict(in_channels=4, base_channels=8, channels=(8, 16),
           blocks_per_stage=1, out_channels=16, out_bounds=(256,))
# the int8 output against the JAX CPU route's, in output steps (out_scale):
# a tie rounded the other way moves one int8 by one step, and the layers
# after it carry that on
STEP_BOUND = 2
MISMATCH_SHARE = 0.01
WINDOW = 128  # the JAX kernels' key window (results do not depend on it;
              # the smallest compiles fastest in interpret mode)


@pytest.fixture(scope="module")
def scan():
    """The JAX quantization test's input: 150 voxels of 4 features,
    key-sorted, in a 256-row buffer; as (port, JAX) tensors."""
    rng = np.random.RandomState(0)
    feats, inds = generate_sparse_data(SHAPE, 150, 4, batch_size=1, rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(SHAPE):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((256, 4), np.float32)
    ib = np.full((256, 4), -1, np.int32)
    fb[:len(inds)], ib[:len(inds)] = feats[order], inds[order]
    return (st.SparseConvTensor(torch.from_numpy(fb), torch.from_numpy(ib),
                                SHAPE, 1, keys_sorted=True),
            spconv_tpu.SparseConvTensor(jnp.asarray(fb), jnp.asarray(ib),
                                        SHAPE, 1, keys_sorted=True))


def _encoders(bn, seed=7):
    """The JAX encoder (with seeded BN statistics when ``bn``) and the port
    encoder carrying its state dict, in eval mode."""
    jenc = JaxEncoder(bn=bn, key=jax.random.PRNGKey(seed), **ENC)
    sd = state_dict(jenc)
    if bn:
        sd = _seeded_bn_state(sd, seed)
        jenc = load_state_dict(jenc, sd)
    tenc = load_jax_state_dict(SparseEncoder(bn=bn, device="cpu", **ENC),
                               sd).eval()
    return jenc, tenc


def test_observe_encoder_scales_matches_jax(scan):
    """The calibration artifact of a BN encoder: the same plain-JSON dict
    as the JAX package's, every scale within 1e-6 relative (f32
    activations summed in another order)."""
    jenc, tenc = _encoders(bn=True)
    want = jax_observe(jenc, [scan[1]])
    got = observe_encoder_scales(tenc, [scan[0]])
    assert json.loads(json.dumps(got)) == got
    flat = [(got["in"], want["in"]), (got["cin"], want["cin"]),
            (got["out"], want["out"])]
    flat += list(zip(got["down"], want["down"]))
    assert len(got["blocks"]) == len(want["blocks"]) == 2
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert len(gb) == len(wb) == 1
        flat += [(g, w) for gp, wp in zip(gb, wb) for g, w in zip(gp, wp)]
    assert len(flat) == 8
    for g, w in flat:
        assert isinstance(g, float) and abs(g - w) <= 1e-6 * w


def _rel_errs(out, ref):
    scale = np.abs(ref).max()
    return (np.abs(out - ref).max() / max(scale, 1e-9),
            np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-9))


@pytest.mark.parametrize("bn", [False, True])
def test_quantized_encoder_matches_jax(scan, bn):
    """From the same fp weights and the same scales dict: equal int8
    weights and state (the JAX state dict loads into a port encoder
    quantized from other weights, and then it computes the same); the
    output and the BEV map against the JAX CPU route within
    ``STEP_BOUND`` output steps, equal on all but ``MISMATCH_SHARE`` of
    the entries; and both sides within the JAX test's bounds of their fp
    encoder (max error < 0.25 of max|ref|, L2 < 0.1)."""
    tx, jx = scan
    jenc, tenc = _encoders(bn)
    scales = observe_encoder_scales(tenc, [tx])
    jq = jax_quantize(jenc, scales=scales)
    tq = quantize_encoder(tenc, scales=scales)
    kinds = [type(m).__name__ for m in tq.layers]
    assert kinds == ["QuantizedSparseConv", "QuantizedSparseBasicBlock",
                     "QuantizedSparseConv", "QuantizedSparseBasicBlock",
                     "QuantizedSparseConv"]
    assert (tq.input_scale, tq.out_scale) == (jq.input_scale, jq.out_scale)
    for tb, jb in zip(tq.layers[1::2], jq.layers[1::2]):
        assert isinstance(tb, QuantizedSparseBasicBlock)
        assert tb.q2.add_scale == jb.q2.add_scale
    sd = state_dict(jq)
    own = tq.state_dict()
    assert sorted(set(sd) - set(own)) == sorted(
        k for k in sd if k.endswith("base.weight"))
    for k, v in own.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    other = quantize_encoder(_encoders(bn, seed=8)[1], scales=scales)
    with pytest.warns(UserWarning, match="placeholder"):
        load_jax_state_dict(other, sd)

    ref = np.asarray(jq(jx).features)
    with torch.no_grad():
        out = tq(tx).features.numpy()
        again = other(tx).features.numpy()
        bev = tq.bev(tx).numpy()
        fp = tenc(tx).features.numpy()
    np.testing.assert_array_equal(again, out)
    steps = np.abs(out - ref) / tq.out_scale
    assert steps.max() <= STEP_BOUND + 1e-3, steps.max()
    assert (steps > 1e-3).mean() <= MISMATCH_SHARE, (steps > 1e-3).mean()
    ref_bev = np.asarray(jq.bev(jx))
    assert bev.shape == ref_bev.shape == (1, 16, 6, 6)
    assert np.abs(bev - ref_bev).max() <= (STEP_BOUND + 1e-3) * tq.out_scale
    jfp = np.asarray(jenc(jx).features)
    for got, want in ((out, fp), (ref, jfp)):
        err, l2 = _rel_errs(got, want)
        assert err < 0.25 and l2 < 0.1, (err, l2)


def _jax_stage_table(keys, shape, window):
    """The JAX kernel route's per-stage state (``QuantizedSparseConv``'s
    subm branch): the window plans and the match table, built once and
    passed to every int8 subm layer of the stage (posmode)."""
    ksize, dil = (3, 3, 3), (1, 1, 1)
    deltas, _ = SK.subm_key_deltas(ksize, dil, shape)
    groups = SK.sk_groups(ksize, include_center=True)
    sent = int(np.prod(shape))
    np_t, n_pad = SK._n_pad_for(keys.shape[0], 128, window)
    plans = SK.build_sk_plans(
        SK._pad_rows(keys, np_t, sent), sent, deltas, groups, tile=128,
        window=window, n_pad=n_pad, align=128)
    pos = build_dg_pos(keys, plans[0], ksize=ksize, dilation=dil,
                       spatial_shape=shape, batch_size=1, window=window,
                       interpret=True)
    return plans, pos


def _flat_layers(jq, tq):
    """(JAX conv, port conv, is the residual conv) in forward order."""
    out = []
    for jl, tl in zip(jq.layers, tq.layers):
        if isinstance(tl, QuantizedSparseBasicBlock):
            out += [(jl.q1, tl.q1, False), (jl.q2, tl.q2, True)]
        else:
            out.append((jl, tl, False))
    return out


def test_quantized_encoder_layers_match_kernel_route(scan):
    """Every int8 layer of the ``bn=False`` encoder, given the port's int8
    input of that layer on both sides, against the JAX kernel route with
    the JAX layer's own weights and folded scales (and, as its module
    does, one match table a stage): the active rows bit for bit (inactive
    rows: 0 in the port, as the JAX module masks them).
    Covers subm with relu and bias (the stage's shared table), subm with
    the fused residual, and the strided k3 s2 p1 and (3,1,1)/(2,1,1)
    convs."""
    tx, jx = scan
    jenc, tenc = _encoders(bn=False)
    scales = observe_encoder_scales(tenc, [tx])
    jq = jax_quantize(jenc, scales=scales)
    tq = quantize_encoder(tenc, scales=scales)
    with torch.no_grad():
        cur = tx.replace_feature(quantize_tensor(tx.features, tq.input_scale))
    block_in = cur
    modes, tables = [], {}
    for jl, tl, residual in _flat_layers(jq, tq):
        if not residual:
            block_in = cur
        with torch.no_grad():
            out = (tl(cur, add_input=block_in, add_scale=tl.add_scale)
                   if residual else tl(cur))
        cfg = jl.base
        scale = jl.input_scale * jl.weight_scale / jl.output_scale
        bias = jl.bias / jl.output_scale
        feats = jnp.asarray(cur.features.numpy())
        if cfg.subm:
            keys, _ = JC.linearize(jnp.asarray(cur.indices.numpy()),
                                   cur.spatial_shape, 1)
            if cfg.indice_key not in tables:
                tables[cfg.indice_key] = _jax_stage_table(
                    keys, cur.spatial_shape, WINDOW)
            plans, pos = tables[cfg.indice_key]
            ref = dg_subm_conv_q(
                feats, keys, jl.weight_i8, scale, bias,
                spatial_shape=cur.spatial_shape, batch_size=1,
                dilation=cfg.dilation, act=jl.act_type,
                add_features=(jnp.asarray(block_in.features.numpy())
                              if residual else None),
                add_scale=(tl.add_scale / jl.output_scale if residual
                           else 1.0), window=WINDOW, plans=plans, pos=pos,
                interpret=True)
        else:
            rec = out.indice_dict[f"__dgreg__{cfg.indice_key}"]
            ref, _ = dg_regular_conv_q(
                feats, jnp.asarray(rec.in_keys.numpy()),
                jnp.asarray(rec.out_keys.numpy()), jl.weight_i8, scale, bias,
                in_shape=rec.in_shape, out_shape=rec.out_shape,
                batch_size=1, stride=cfg.stride, padding=cfg.padding,
                dilation=cfg.dilation, act=jl.act_type, window=WINDOW,
                interpret=True)
        valid = out.indices[:, 0].numpy() >= 0
        got = out.features.numpy()
        assert got.dtype == np.int8 and not got[~valid].any()
        assert (got[valid] != 0).any()
        np.testing.assert_array_equal(got[valid], np.asarray(ref)[valid])
        modes.append("subm+add" if residual else
                     "subm" if cfg.subm else f"strided{cfg.kernel_size}")
        cur = out
    assert modes == ["subm", "subm", "subm+add", "strided(3, 3, 3)", "subm",
                     "subm+add", "strided(3, 1, 1)"]
