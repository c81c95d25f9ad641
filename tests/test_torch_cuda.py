"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import re

import numpy as np
import pytest
import torch

import spconv_tpu_torch as st
from spconv_tpu_torch._build import load_library
from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.benchmark import centerpoint as TCP
from spconv_tpu_torch.models import SparseUNet, centerpoint_encoder
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import probes as TP
from spconv_tpu_torch.ops.rulebook import (build_conv_outputs,
                                           build_deconv_outputs)

from utils import generate_sparse_data

pytestmark = pytest.mark.cuda

SHAPE = (9, 40, 40)
KSIZE = (3, 3, 3)
DIL = (1, 1, 1)
KV = 27


def _counts(**nonzero):
    """``launch_counts`` as a run that launched only ``nonzero`` leaves
    it."""
    return {**dict.fromkeys(TD.launch_counts, 0), **nonzero}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sorted_input(seed, n, c, nbuf):
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(SHAPE, n, c, rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(SHAPE):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, 4), -1, np.int32)
    fb[:n] = feats[order]
    ib[:n] = inds[order]
    return fb, ib


def _plain_pos(inds, reverse=False):
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    return keys, TD.dg_pos_plain(keys, ksize=KSIZE, dilation=DIL,
                                 spatial_shape=SHAPE, batch_size=1,
                                 reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_dg_pos_kernel_matches_plain(dev, reverse):
    """Exact; the reversed table is also the forward one flipped on its
    offset axis (an odd kernel)."""
    _, inds = _sorted_input(5, 3000, 4, 3072)
    keys, ref = _plain_pos(inds, reverse)
    name = "dg_pos_rev" if reverse else "dg_pos"
    before = dict(TD.launch_counts)
    got = TD.build_dg_pos(keys.to(dev), ksize=KSIZE, dilation=DIL,
                          spatial_shape=SHAPE, batch_size=1, reverse=reverse)
    torch.cuda.synchronize()
    assert TD.launch_counts[name] == before[name] + 1
    assert sum(TD.launch_counts.values()) == sum(before.values()) + 1
    assert torch.equal(got.cpu(), ref)
    if reverse:
        assert torch.equal(ref, _plain_pos(inds)[1].flip(0))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("c,k_out", [(3, 64), (64, 96), (160, 256),
                                     (12, 20)])
def test_dg_fwd_kernel_matches_plain(dev, dtype, tol, c, k_out):
    """f32 within 2e-5*max|ref| (order of the f32 sums); bf16 within
    1.6e-2*max|ref| (an f32-sum difference can flip one bf16 rounding)."""
    feats, inds = _sorted_input(6, 3000, c, 3072)
    _, pos = _plain_pos(inds)
    g = torch.Generator().manual_seed(7)
    w = torch.randn((KV, c, k_out), generator=g) / np.sqrt(KV * c)
    x = torch.from_numpy(feats).to(dev, dtype)
    w = w.to(dev, dtype)
    pos = pos.to(dev)
    ref = TD.dg_fwd_plain(x, w, pos).float()
    before = TD.launch_counts["dg_fwd"]
    got = TD.dg_fwd(x, w, pos)
    torch.cuda.synchronize()
    assert TD.launch_counts["dg_fwd"] == before + 1 and got.dtype == dtype
    got = got.float()
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err
    assert not got[3000:].any()


# N = 3000 active rows in a 3072-row buffer: neither a multiple of the
# 64-row tile nor of the 32-row wgrad chunk, with an all-invalid tail
_BWD_WIDTHS = [(3, 64), (64, 96), (160, 256), (256, 256), (12, 20)]


def _bwd_case(dev, dtype, c, k_out, seed):
    feats, inds = _sorted_input(seed, 3000, c, 3072)
    _, rev = _plain_pos(inds, reverse=True)
    g = torch.Generator().manual_seed(seed)
    dout = torch.randn((3072, k_out), generator=g)
    dout[3000:] = 0
    w = torch.randn((KV, c, k_out), generator=g) / np.sqrt(KV * c)
    return (torch.from_numpy(feats).to(dev, dtype), dout.to(dev, dtype),
            w.to(dev, dtype), rev.to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("c,k_out", _BWD_WIDTHS)
def test_dg_dgrad_kernel_matches_plain(dev, dtype, tol, c, k_out):
    """B2's kernel on the reversed table and W^T; tolerances as B2's.
    Rows without a reversed match (the invalid tail) are 0."""
    _, dout, w, rev = _bwd_case(dev, dtype, c, k_out, 8)
    ref = TD.dg_dgrad_plain(dout, w, rev).float()
    before = dict(TD.launch_counts)
    got = TD.dg_dgrad(dout, w, rev)
    torch.cuda.synchronize()
    assert TD.launch_counts["dg_dgrad"] == before["dg_dgrad"] + 1
    assert TD.launch_counts["dg_fwd"] == before["dg_fwd"]
    assert got.dtype == dtype and tuple(got.shape) == (3072, c)
    got = got.float()
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err
    assert not got[3000:].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("c,k_out", _BWD_WIDTHS)
def test_dg_wgrad_kernel_matches_plain(dev, dtype, tol, c, k_out):
    """f32 within 1e-4*max|ref| (sums of up to 3000 products per entry in
    another order); bf16 within 1.6e-2*max|ref| (one bf16 rounding).  Two
    runs are bit-equal (fixed-order reduction, no atomics)."""
    x, dout, _, rev = _bwd_case(dev, dtype, c, k_out, 9)
    ref = TD.dg_wgrad_plain(x, dout, rev).float()
    before = TD.launch_counts["dg_wgrad"]
    got = TD.dg_wgrad(x, dout, rev)
    again = TD.dg_wgrad(x, dout, rev)
    torch.cuda.synchronize()
    assert TD.launch_counts["dg_wgrad"] == before + 2
    assert got.dtype == dtype and tuple(got.shape) == (KV, c, k_out)
    assert torch.equal(got, again)
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


# (C, K) of each bf16 wgrad tile variant at 3,072 rows, by variant: C = 3
# and C = 5 (16-channel tile, scalar x), C = 20 (scalar x), K = 20 (scalar
# dout), K = 96 on a 128-wide tile, C = 96 on a 128-channel one, and
# channel and column tiles (C = 160, K = 256)
_WGRAD_VARIANTS = [(0, 3, 64), (0, 5, 16), (1, 32, 32), (1, 20, 40),
                   (2, 64, 64), (2, 64, 20), (3, 64, 96), (4, 96, 64),
                   (5, 128, 128), (5, 160, 256)]
WGRAD_TOL = 1.6e-2  # bf16: one rounding of each f32 sum


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def _check_wgrad(x, dout, rev, tile=None, path="subm"):
    """The bf16 kernel (on the tile variant ``tile``, when given) against
    the plain version within WGRAD_TOL of max|ref|, two runs bit-equal, one
    launch each under ``path``'s counter; returns dW."""
    if tile is not None:
        v = TD.wgrad_variant(x.shape[0], x.shape[1], dout.shape[1],
                             rev.shape[0])
        assert v.tile == tile, v
    ref = TD.dg_wgrad_plain(x, dout, rev).float()
    name = "dg_wgrad" if path == "subm" else f"dg_wgrad_{path}"
    before = TD.launch_counts[name]
    got = TD.dg_wgrad(x, dout, rev, path)
    again = TD.dg_wgrad(x, dout, rev, path)
    torch.cuda.synchronize()
    assert TD.launch_counts[name] == before + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    err = (got.float() - ref).abs().max().item()
    assert err <= WGRAD_TOL * ref.abs().max().item(), err
    return got


@pytest.mark.parametrize("tile,c,k_out", _WGRAD_VARIANTS)
def test_dg_wgrad_bf16_variants_match_plain_and_search(dev, tile, c, k_out):
    """Each bf16 wgrad tile variant on 3,000 active rows in a 3,072-row
    buffer (an all-invalid tail; 3,072 is no multiple of the 512-row chunk
    of a split): against plain, repeats bit-equal, and S3 bit-equal to the
    table mode on ``build_dg_pos(reverse=True)``."""
    feats, inds = _sorted_input(12, 3000, c, 3072)
    keys, rev = _plain_pos(inds, reverse=True)
    g = torch.Generator().manual_seed(12)
    dout = torch.randn((3072, k_out), generator=g)
    dout[3000:] = 0
    x = torch.from_numpy(feats).to(dev, torch.bfloat16)
    dout = dout.to(dev, torch.bfloat16)
    geom = TD.SearchGeom.of(KSIZE, DIL, SHAPE, 1)
    rev_dev = TD.build_dg_pos(keys.to(dev), reverse=True, **geom._asdict())
    assert torch.equal(rev_dev.cpu(), rev)
    dw = _check_wgrad(x, dout, rev_dev, tile)
    s3 = TD.dg_wgrad_search(x, dout, keys.to(dev), geom)
    assert torch.equal(s3, dw)
    assert torch.equal(s3, TD.dg_wgrad_search(x, dout, keys.to(dev), geom))


@pytest.mark.parametrize("c,k_out", [(64, 64), (3, 64), (160, 256)])
def test_dg_wgrad_bf16_misaligned_views(dev, c, k_out):
    """x and dout 2 bytes off a 16-byte boundary take the scalar gathers:
    bit-equal to the aligned call (the same sums in the same order)."""
    feats, inds = _sorted_input(13, 3000, c, 3072)
    _, rev = _plain_pos(inds, reverse=True)
    g = torch.Generator().manual_seed(13)
    x = torch.from_numpy(feats).to(dev, torch.bfloat16)
    dout = torch.randn((3072, k_out), generator=g).to(dev, torch.bfloat16)
    rev = rev.to(dev)
    xm, dm = _misaligned(x), _misaligned(dout)
    assert not TD.wgrad_variant(3072, c, k_out, aligned=False).vec
    aligned = _check_wgrad(x, dout, rev)
    assert torch.equal(_check_wgrad(xm, dm, rev), aligned)
    assert torch.equal(_check_wgrad(xm, dout, rev), aligned)


def _random_table(kv, n, n_dst, seed, hit=0.35, dead=(0, 0)):
    """A backward table ``[kv, n]``: each (offset, row) matches a random
    row of ``n_dst`` with probability ``hit``, except the rows in ``dead``
    and offset 1, which match nothing."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, n_dst, size=(kv, n)).astype(np.int32)
    t[rng.rand(kv, n) >= hit] = -1
    t[:, dead[0]:dead[1]] = -1
    t[1] = -1
    return torch.from_numpy(t)


@pytest.mark.parametrize("n,c,k_out,kv", [
    (20_000, 64, 64, 27),     # 40 splits: the first 13 see no match
    (20_000, 5, 16, 27),
    (4_999, 160, 256, 27),    # no multiple of the chunk or of 32
    (9_000, 64, 32, 8),       # the transposed conv's widths and offsets
])
def test_dg_wgrad_bf16_splits_without_matches(dev, n, c, k_out, kv):
    """Splits whose rows all miss, and an offset that matches nowhere
    (dW[1] exactly 0), on a random table: against plain, repeats
    bit-equal."""
    n_dst = 8 * n if kv == 8 else n
    rev = _random_table(kv, n, n_dst, 14, dead=(0, n // 3)).to(dev)
    g = torch.Generator().manual_seed(14)
    x = torch.randn((n, c), generator=g).to(dev, torch.bfloat16)
    dout = torch.randn((n_dst, k_out), generator=g).to(dev, torch.bfloat16)
    assert TD.wgrad_splits(n, kv, c, k_out) > 1
    dw = _check_wgrad(x, dout, rev, path="transposed" if kv == 8 else "subm")
    assert not dw[1].any()


def test_dg_wgrad_bf16_transposed_shape(dev):
    """The USAGE.md chain's transposed conv backward: x of 113,664 rows (64
    channels), dout of 1,039,616 (32), 8 offsets, each input site matching
    its 8 disjoint children: against plain, repeats bit-equal, and dout rows
    past 2**24 elements are read (offsets in size_t)."""
    n, n_dst = 113_664, 1_039_616
    rng = np.random.RandomState(15)
    live = 113_000
    perm = rng.permutation(8 * live).astype(np.int32).reshape(8, live)
    t = np.full((8, n), -1, np.int32)
    t[:, :live] = perm
    rev = torch.from_numpy(t).to(dev)
    g = torch.Generator().manual_seed(15)
    x = torch.randn((n, 64), generator=g).to(dev, torch.bfloat16)
    dout = torch.randn((n_dst, 32), generator=g).to(dev, torch.bfloat16)
    _check_wgrad(x, dout, rev, tile=2, path="transposed")


def test_benchnet_on_card_matches_cpu(dev):
    """The whole net through both kernels on the card against the plain
    versions on the CPU, f32."""
    shape = (64, 128, 128)
    voxels, coors, _ = TB.synthetic_scan(0, shape=shape, n_target=1600)
    net = TB.BenchNet(shape, device="cpu")
    with torch.no_grad():
        ref = net.forward_stages(TB.make_bench_input(voxels, coors, shape,
                                                     device="cpu"))
        net.to(dev)
        TD.reset_launch_counts()
        got = net.forward_stages(
            TB.make_bench_input(voxels, coors, shape, device=dev))
        torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_pos=7, dg_fwd=14)
    for r, g in zip(ref, got):
        assert torch.equal(g.indices.cpu(), r.indices)
        scale = r.features.abs().max().item()
        err = (g.features.cpu() - r.features).abs().max().item()
        assert err <= 1e-4 * scale, (err, scale)


def test_benchnet_train_step_on_card_matches_cpu(dev):
    """One f32 training step through every kernel on the card against the
    same step through the plain versions on the CPU: losses within 1e-4
    relative and every weight grad within 1e-3*max|ref| (f32 sums in
    another order; a near-tie in a max pool may route one gradient to
    another child).  A step launches 7 + 7 B1, 14 B2, 13 dgrad and 14
    wgrad."""
    shape = (64, 128, 128)
    voxels, coors, _ = TB.synthetic_scan(0, shape=shape, n_target=1600)
    net = TB.BenchNet(shape, device="cpu")
    ref_loss = TB.train_step(
        net, TB.make_bench_input(voxels, coors, shape, device="cpu"), 0.0)
    ref = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.to(dev)
    TD.reset_launch_counts()
    loss = TB.train_step(
        net, TB.make_bench_input(voxels, coors, shape, device=dev), 0.0)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_pos=7, dg_pos_rev=7, dg_fwd=14,
                                       dg_dgrad=13, dg_wgrad=14)
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * ref_loss.item()
    for k, p in net.named_parameters():
        scale = ref[k].abs().max().item()
        err = (p.grad.cpu() - ref[k]).abs().max().item()
        assert scale > 0 and err <= 1e-3 * scale, (k, err, scale)


# the strided layers of the CenterPoint encoder (k3 s2 p1 and its
# (3,1,1)/(2,1,1) conv_out), an even kernel, and two batches
_STRIDED = [((40, 64, 64), (3, 3, 3), (2, 2, 2), (1, 1, 1), 1),
            ((10, 16, 16), (3, 1, 1), (2, 1, 1), (0, 0, 0), 1),
            ((40, 64, 64), (2, 2, 2), (2, 2, 2), (0, 0, 0), 1),
            ((20, 32, 32), (3, 3, 3), (2, 2, 2), (1, 1, 1), 2)]


def _strided_case(shape, ksize, stride, padding, batch, c=5, nbuf=3072):
    rng = np.random.RandomState(11)
    feats, inds = generate_sparse_data(shape, 1400, c, batch_size=batch,
                                       rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, 4), -1, np.int32)
    fb[:len(inds)], ib[:len(inds)] = feats[order], inds[order]
    inds_t = torch.from_numpy(ib)
    _, out_keys, _, _ = build_conv_outputs(
        inds_t, spatial_shape=shape, batch_size=batch, ksize=ksize,
        stride=stride, padding=padding, dilation=(1, 1, 1),
        out_bound=2 * nbuf)
    in_keys, _ = TC.linearize(inds_t, shape, batch)
    geom = dict(ksize=ksize, stride=stride, padding=padding,
                dilation=(1, 1, 1), in_shape=shape,
                out_shape=tuple(TC.get_conv_output_size(
                    shape, ksize, stride, padding, (1, 1, 1))),
                batch_size=batch)
    return torch.from_numpy(fb), in_keys, out_keys, geom


@pytest.mark.parametrize("case", _STRIDED)
def test_dg_pos_affine_kernel_matches_plain(dev, case):
    """The affine table on the card equals its plain version exactly."""
    _, in_keys, out_keys, geom = _strided_case(*case)
    ref = TD.dg_pos_affine_plain(in_keys, out_keys, **geom)
    before = dict(TD.launch_counts)
    got = TD.build_dg_pos_affine(in_keys.to(dev), out_keys.to(dev), **geom)
    torch.cuda.synchronize()
    assert TD.launch_counts["dg_pos_affine"] == before["dg_pos_affine"] + 1
    assert sum(TD.launch_counts.values()) == sum(before.values()) + 1
    assert (ref >= 0).any() and torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("c,k_out", [(5, 16), (16, 32), (64, 128),
                                     (128, 128)])
@pytest.mark.parametrize("case", [_STRIDED[0], _STRIDED[1]])
def test_dg_fwd_strided_kernel_matches_plain(dev, dtype, tol, c, k_out,
                                             case):
    """B2 on an affine table, N_in = 3072 input rows onto 6144 output
    rows; tolerances as B2's.  Sentinel output rows are 0."""
    feats, in_keys, out_keys, geom = _strided_case(*case, c=c)
    pos = TD.dg_pos_affine_plain(in_keys, out_keys, **geom)
    assert pos.shape[1] != feats.shape[0]
    g = torch.Generator().manual_seed(12)
    kv = int(np.prod(geom["ksize"]))
    w = torch.randn((kv, c, k_out), generator=g) / np.sqrt(kv * c)
    x, w, pos = feats.to(dev, dtype), w.to(dev, dtype), pos.to(dev)
    ref = TD.dg_fwd_plain(x, w, pos).float()
    before = dict(TD.launch_counts)
    got = TD.dg_fwd(x, w, pos, path="strided")
    torch.cuda.synchronize()
    assert TD.launch_counts["dg_fwd_strided"] == before["dg_fwd_strided"] + 1
    assert TD.launch_counts["dg_fwd"] == before["dg_fwd"]
    assert got.dtype == dtype and tuple(got.shape) == (pos.shape[1], k_out)
    got = got.float()
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err
    sentinel = TC.grid_sentinel(geom["out_shape"], geom["batch_size"])
    assert not got[(out_keys == sentinel).to(dev)].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1.6e-2)])
def test_centerpoint_encoder_on_card_matches_cpu(dev, dtype, tol):
    """The whole encoder through the kernels on the card against the
    plain versions on the CPU: coordinates equal after every stage, the
    BEV map within 1e-4*max|ref| (f32) or 1.6e-2*max|ref| (bf16, rounded
    at every layer).  A forward launches 4 subm and 4 affine tables and
    17 + 4 gather-GEMMs."""
    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                           n_target=1500, dtype=dtype,
                                           device="cpu")
    net = centerpoint_encoder(in_channels=5, bn=False, dtype=dtype,
                              device="cpu").eval()
    with torch.no_grad():
        ref = net.forward_stages(x)
        ref_bev = net.bev(x).float()
        net.to(dev)
        xd = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                             n_target=1500, dtype=dtype,
                                             device=dev)[0]
        TD.reset_launch_counts()
        got = net.forward_stages(xd)
        torch.cuda.synchronize()
        counts = dict(TD.launch_counts)
        bev = net.bev(xd).float().cpu()
    assert counts == _counts(dg_pos=4, dg_pos_affine=4, dg_fwd=17,
                             dg_fwd_strided=4)
    for r, g in zip(ref, got):
        assert torch.equal(g.indices.cpu(), r.indices)
    scale = ref_bev.abs().max().item()
    assert scale > 0 and (bev - ref_bev).abs().max().item() <= tol * scale


@pytest.mark.parametrize("case", _STRIDED)
def test_dg_pos_divide_kernel_matches_plain(dev, case):
    """The divide table on the card equals its plain version exactly."""
    _, in_keys, out_keys, geom = _strided_case(*case)
    ref = TD.dg_pos_divide_plain(in_keys, out_keys, **geom)
    before = dict(TD.launch_counts)
    got = TD.build_dg_pos_divide(in_keys.to(dev), out_keys.to(dev), **geom)
    torch.cuda.synchronize()
    assert TD.launch_counts["dg_pos_divide"] == before["dg_pos_divide"] + 1
    assert sum(TD.launch_counts.values()) == sum(before.values()) + 1
    assert (ref >= 0).any() and torch.equal(got.cpu(), ref)


def _regular_operands(case, path, c, k_out, dtype, dev, seed):
    """For conv ``path`` ("strided" or "inverse") at ``case``: the source
    features ``x`` [N_src, c] (0 on sentinel rows), a ``dout`` [N_dst,
    k_out] (the same), ``w`` [kv, c, k_out] and the forward's and the
    backward's tables, on ``dev``."""
    _, in_keys, out_keys, geom = _strided_case(*case)
    aff = TD.dg_pos_affine_plain(in_keys, out_keys, **geom)
    div = TD.dg_pos_divide_plain(in_keys, out_keys, **geom)
    sent_in = TC.grid_sentinel(geom["in_shape"], geom["batch_size"])
    sent_out = TC.grid_sentinel(geom["out_shape"], geom["batch_size"])
    live_in, live_out = in_keys != sent_in, out_keys != sent_out
    if path == "strided":
        pos, pos_bwd, live_src, live_dst = aff, div, live_in, live_out
    else:
        pos, pos_bwd, live_src, live_dst = div, aff, live_out, live_in
    g = torch.Generator().manual_seed(seed)
    kv = int(np.prod(geom["ksize"]))
    x = torch.randn((live_src.shape[0], c), generator=g) * live_src[:, None]
    dout = (torch.randn((live_dst.shape[0], k_out), generator=g)
            * live_dst[:, None])
    w = torch.randn((kv, c, k_out), generator=g) / np.sqrt(kv * c)
    return (x.to(dev, dtype), dout.to(dev, dtype), w.to(dev, dtype),
            pos.to(dev), pos_bwd.to(dev), live_src.to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("c,k_out", [(32, 16), (64, 32), (128, 128)])
@pytest.mark.parametrize("case", [_STRIDED[0], _STRIDED[1]])
def test_dg_fwd_inverse_kernel_matches_plain(dev, dtype, tol, c, k_out,
                                             case):
    """B2 on a divide table (the inverse conv), N_out = 6144 source rows
    onto N_in = 3072 output rows; tolerances as B2's."""
    x, _, w, pos, _, _ = _regular_operands(case, "inverse", c, k_out, dtype,
                                           dev, 13)
    ref = TD.dg_fwd_plain(x, w, pos).float()
    before = dict(TD.launch_counts)
    got = TD.dg_fwd(x, w, pos, path="inverse")
    torch.cuda.synchronize()
    assert TD.launch_counts == dict(
        before, dg_fwd_inverse=before["dg_fwd_inverse"] + 1)
    assert got.dtype == dtype and tuple(got.shape) == (pos.shape[1], k_out)
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 2e-5, 1e-4),
                                            (torch.bfloat16, 1.6e-2,
                                             1.6e-2)])
@pytest.mark.parametrize("path", ["strided", "inverse"])
@pytest.mark.parametrize("c,k_out", [(16, 32), (64, 32), (128, 128)])
def test_regular_bwd_kernels_match_plain(dev, dtype, tol, wtol, path, c,
                                         k_out):
    """dgrad and wgrad of the strided conv (through the divide table) and
    of the inverse conv (through the affine table), N_in != N_out, against
    their plain versions; tolerances as the subm ones'.  Rows without a
    match get a zero din; two wgrad runs are bit-equal."""
    x, dout, w, _, pos_bwd, live_src = _regular_operands(
        _STRIDED[0], path, c, k_out, dtype, dev, 14)
    before = dict(TD.launch_counts)
    din = TD.dg_dgrad(dout, w, pos_bwd, path=path)
    dw = TD.dg_wgrad(x, dout, pos_bwd, path=path)
    again = TD.dg_wgrad(x, dout, pos_bwd, path=path)
    torch.cuda.synchronize()
    assert TD.launch_counts == dict(
        before, **{f"dg_dgrad_{path}": before[f"dg_dgrad_{path}"] + 1,
                   f"dg_wgrad_{path}": before[f"dg_wgrad_{path}"] + 2})
    assert tuple(din.shape) == tuple(x.shape) and torch.equal(dw, again)
    ref = TD.dg_dgrad_plain(dout, w, pos_bwd).float()
    err = (din.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err
    assert not din[~live_src].any()
    ref = TD.dg_wgrad_plain(x, dout, pos_bwd).float()
    err = (dw.float() - ref).abs().max().item()
    assert err <= wtol * ref.abs().max().item(), err


def test_unet_train_step_on_card_matches_cpu(dev):
    """One f32 training step of a small ``SparseUNet`` through every kernel
    on the card against the same step through the plain versions on the
    CPU: coordinates equal, the loss within 1e-4 relative, every grad
    within 1e-4*max|ref| (f32 sums in another order).  A step launches 3 +
    3 subm, 2 affine and 2 divide tables, 5 + 2 + 2 B2, 4 + 2 + 2 dgrad
    and 5 + 2 + 2 wgrad."""
    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                           n_target=1500, device="cpu")
    net = SparseUNet(5, (16, 32, 64), 16, device="cpu")
    with torch.no_grad():
        ref_out = net(x)
    ref_loss = TB.train_step(net, x, 0.0)
    ref = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.to(dev)
    xd = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                         n_target=1500, device=dev)[0]
    with torch.no_grad():
        out = net(xd)
    assert torch.equal(out.indices.cpu(), ref_out.indices)
    TD.reset_launch_counts()
    loss = TB.train_step(net, xd, 0.0)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(
        dg_pos=3, dg_pos_rev=3, dg_pos_affine=2, dg_pos_divide=2, dg_fwd=5,
        dg_fwd_strided=2, dg_fwd_inverse=2, dg_dgrad=4, dg_dgrad_strided=2,
        dg_dgrad_inverse=2, dg_wgrad=5, dg_wgrad_strided=2,
        dg_wgrad_inverse=2)
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * ref_loss.item()
    for k, p in net.named_parameters():
        scale = ref[k].abs().max().item()
        err = (p.grad.cpu() - ref[k]).abs().max().item()
        assert scale > 0 and err <= 1e-4 * scale, (k, err, scale)


def _q_operands(case, path, c, k_out, seed):
    """int8 operands of B7 on conv ``path`` at ``case`` (a ``_STRIDED``
    geometry; "subm" takes its input grid): features on the source rows (0
    on inactive ones), weights, a requant scale that puts the outputs in
    and past +-127, a bias, a residual and the forward's table, all on the
    CPU."""
    feats, in_keys, out_keys, geom = _strided_case(*case)
    rng = np.random.RandomState(seed)
    kv = int(np.prod(geom["ksize"]))
    if path == "subm":
        kv = KV
        pos = TD.dg_pos_plain(in_keys, ksize=KSIZE, dilation=DIL,
                              spatial_shape=geom["in_shape"],
                              batch_size=geom["batch_size"])
        n_src = in_keys.shape[0]
        live = in_keys != TC.grid_sentinel(geom["in_shape"],
                                           geom["batch_size"])
    else:
        build = (TD.dg_pos_affine_plain if path == "strided"
                 else TD.dg_pos_divide_plain)
        pos = build(in_keys, out_keys, **geom)
        src_keys, shape = ((in_keys, geom["in_shape"]) if path == "strided"
                           else (out_keys, geom["out_shape"]))
        n_src = src_keys.shape[0]
        live = src_keys != TC.grid_sentinel(shape, geom["batch_size"])
    x = torch.from_numpy(rng.randint(-127, 128, (n_src, c)).astype(np.int8))
    x[~live] = 0
    w = torch.from_numpy(rng.randint(-127, 128, (kv, c, k_out))
                         .astype(np.int8))
    matched = max(1.0, float((pos >= 0).sum()) / pos.shape[1])
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, k_out) * 60
                              / (5300 * np.sqrt(matched * c)))
                             .astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-20, 20, k_out).astype(np.float32))
    add = torch.from_numpy(rng.randint(-127, 128, (pos.shape[1], k_out))
                           .astype(np.int8))
    return x, w, pos, scale, bias, add


@pytest.mark.parametrize("path,c,k_out,mode", [
    ("subm", 5, 16, "relu+bias"), ("subm", 16, 16, "relu+bias"),
    ("subm", 64, 64, "none"), ("subm", 128, 128, "relu+bias"),
    ("subm", 12, 20, "none+bias"), ("subm", 16, 16, "relu+add"),
    ("subm", 128, 128, "relu+bias+add"), ("strided", 16, 32, "relu+bias"),
    ("strided", 128, 128, "none"), ("inverse", 32, 16, "relu+bias"),
    ("inverse", 64, 32, "none"),
    # the widths of B7's tiles and gathers (b7_variant): packed in 16-,
    # 32- and 64-channel slots with byte and 16-byte gathers on the 16-,
    # 32- and 64-wide tiles
    ("subm", 32, 16, "relu+bias+add"), ("subm", 20, 16, "none+add"),
    ("subm", 16, 32, "relu+bias+add"), ("subm", 24, 32, "relu+bias"),
    ("subm", 5, 64, "relu+bias+add"), ("subm", 40, 48, "none+bias+add"),
    ("subm", 16, 64, "relu+add"), ("strided", 5, 16, "none"),
    ("strided", 20, 16, "relu+bias"), ("strided", 40, 48, "relu+bias"),
    ("inverse", 16, 64, "relu+bias"), ("inverse", 12, 20, "none+bias")])
def test_dg_fwd_q_kernel_matches_plain(dev, path, c, k_out, mode):
    """B7 on the card bit-equal to its plain version (run on the CPU) on
    every path and epilogue mode, and two runs bit-equal; one launch under
    the path's counter."""
    x, w, pos, scale, bias, add = _q_operands(_STRIDED[0], path, c, k_out,
                                              15)
    kw = dict(act="relu" if "relu" in mode else "none",
              add=add if "add" in mode else None, add_scale=0.37)
    bias = bias if "bias" in mode else None
    ref = TD.dg_fwd_q_plain(x, w, pos, scale, bias, **kw)
    assert (ref.abs() == 127).any() and (ref != 0).any()
    on = [t.to(dev) if t is not None else None
          for t in (x, w, pos, scale, bias, kw["add"])]
    kw["add"] = on[5]
    name = "dg_fwd_q" if path == "subm" else f"dg_fwd_q_{path}"
    before = dict(TD.launch_counts)
    got = TD.dg_fwd_q(*on[:5], path=path, **kw)
    again = TD.dg_fwd_q(*on[:5], path=path, **kw)
    torch.cuda.synchronize()
    assert TD.launch_counts == dict(before, **{name: before[name] + 2})
    assert got.dtype == torch.int8 and tuple(got.shape) == tuple(ref.shape)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), ref)


# (tile, vec, packed) of each B7 variant -> (N, C, K) that takes it: slots
# of 16 (C <= 16), 32 and 64 channels among the packed ones; the 128-wide
# tile needs a wave of 64-row blocks (N >= 8,448)
_B7_VARIANTS = {
    (0, False, True): (3072, 5, 16), (0, True, True): (3072, 16, 16),
    (0, True, False): (3072, 80, 16), (0, False, False): (3072, 72, 16),
    (1, False, True): (3072, 24, 20), (1, True, True): (3072, 32, 32),
    (1, True, False): (3072, 96, 32), (1, False, False): (3072, 100, 32),
    (2, False, True): (3072, 40, 48), (2, True, True): (3072, 64, 64),
    (2, True, False): (3072, 128, 64), (2, False, False): (3072, 72, 48),
    (3, False, True): (10_000, 12, 100), (3, True, True): (10_000, 32, 128),
    (3, True, False): (10_000, 128, 128),
    (3, False, False): (10_000, 36, 96)}
_B7_PATHS = [("subm", "none"), ("subm", "relu+bias"),
             ("subm", "relu+bias+add"), ("strided", "none"),
             ("strided", "relu+bias"), ("inverse", "none"),
             ("inverse", "relu+bias")]


def _b7_operands(dev, n, c, k_out, path, seed, kv=27, dead=(0, 0)):
    """int8 operands of B7 on a random table ``[kv, n]`` of conv ``path``
    (the source has ``n`` rows for "subm", ``2n`` for "strided", ``n / 2``
    for "inverse"), on the card: features, weights, a scale that puts the
    outputs in and past +-127, a bias, a residual and the table."""
    n_src = {"subm": n, "strided": 2 * n, "inverse": n // 2}[path]
    pos = _random_table(kv, n, n_src, seed, hit=0.3, dead=dead)
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (n_src, c)).astype(np.int8)
    w = rng.randint(-127, 128, (kv, c, k_out)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, k_out) * 60
             / (5300 * np.sqrt(0.3 * kv * c))).astype(np.float32)
    bias = rng.uniform(-20, 20, k_out).astype(np.float32)
    add = rng.randint(-127, 128, (n, k_out)).astype(np.int8)
    return [torch.from_numpy(t).to(dev) for t in (x, w, scale, bias, add)
            ] + [pos.to(dev)]


def _check_b7(x, w, scale, bias, add, pos, path, mode):
    """B7 against its plain version, bit for bit, in epilogue ``mode``;
    two runs bit-equal; one launch each under ``path``'s counter; returns
    the output."""
    kw = dict(act="relu" if "relu" in mode else "none",
              add=add if "add" in mode else None, add_scale=0.37)
    bias = bias if "bias" in mode else None
    name = "dg_fwd_q" if path == "subm" else f"dg_fwd_q_{path}"
    before = TD.launch_counts[name]
    got = TD.dg_fwd_q(x, w, pos, scale, bias, path=path, **kw)
    again = TD.dg_fwd_q(x, w, pos, scale, bias, path=path, **kw)
    torch.cuda.synchronize()
    assert TD.launch_counts[name] == before + 2
    ref = TD.dg_fwd_q_plain(x.cpu(), w.cpu(), pos.cpu(), scale.cpu(),
                            None if bias is None else bias.cpu(),
                            **dict(kw, add=None if kw["add"] is None
                                   else kw["add"].cpu()))
    assert (ref.abs() == 127).any() and (ref != 0).any()
    assert got.dtype == torch.int8 and torch.equal(got, again)
    assert torch.equal(got.cpu(), ref)
    return got


@pytest.mark.parametrize("path,mode", _B7_PATHS)
@pytest.mark.parametrize("variant", sorted(_B7_VARIANTS))
def test_b7_variants_match_plain(dev, variant, path, mode):
    """Every B7 variant (tile x 16-byte or byte gather x packed) on every
    path and epilogue mode, bit-equal to plain, with the weight a
    contiguous ``[kv, C, K]`` (copied by the wrapper) and the ``[kv, C,
    K]`` view of a contiguous ``[kv, K, C]`` (read as it is)."""
    n, c, k_out = _B7_VARIANTS[variant]
    ops = _b7_operands(dev, n, c, k_out, path, 16)
    v = TD.b7_variant(n, c, k_out)
    assert (v.tile, v.vec, v.packed) == variant
    got = _check_b7(*ops, path, mode)
    ops[1] = ops[1].transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(_check_b7(*ops, path, mode), got)


@pytest.mark.parametrize("variant", sorted(_B7_VARIANTS))
def test_dg_fwd_q_search_at_every_variant(dev, variant):
    """S4 on each B7 variant (9,000 active rows of 9,216 for the
    128-wide tile), with bias, ReLU and the residual: bit-equal to plain
    and to B1 followed by the table mode."""
    n, c, k_out = _B7_VARIANTS[variant]
    nbuf = 3072 if n == 3072 else 9216
    _, inds = _sorted_input(17, nbuf - nbuf // 32, c, nbuf)
    keys, pos = _plain_pos(inds)
    geom = TD.SearchGeom.of(KSIZE, DIL, SHAPE, 1)
    x, w, scale, bias, add, _ = _b7_operands(dev, nbuf, c, k_out, "subm",
                                              17)
    x[nbuf - nbuf // 32:] = 0
    v = TD.b7_variant(nbuf, c, k_out)
    assert (v.tile, v.vec, v.packed) == variant
    kw = dict(act="relu", add=add, add_scale=0.37)
    TD.reset_launch_counts()
    got = TD.dg_fwd_q_search(x, w, keys.to(dev), scale, bias, geom, **kw)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_q_search=1)
    ref = TD.dg_fwd_q_search_plain(x.cpu(), w.cpu(), keys, scale.cpu(),
                                   bias.cpu(), geom, act="relu",
                                   add=add.cpu(), add_scale=0.37)
    assert (ref.abs() == 127).any()
    assert torch.equal(got.cpu(), ref)
    pos_dev = TD.build_dg_pos(keys.to(dev), **geom._asdict())
    assert torch.equal(pos_dev.cpu(), pos)
    assert torch.equal(got, TD.dg_fwd_q(x, w, pos_dev, scale, bias, **kw))


@pytest.mark.parametrize("c,k_out", [(64, 64), (16, 32), (12, 20),
                                     (128, 128)])
def test_b7_misaligned_view_takes_the_scalar_gather(dev, c, k_out):
    """Features 1 byte past a 16-byte boundary (``base[1:]`` viewed as
    ``[N, C]``) take the byte gather: bit-equal to the aligned call."""
    n = 10_000 if k_out > 64 else 3072
    x, w, scale, bias, add, pos = _b7_operands(dev, n, c, k_out, "subm",
                                                18)
    base = torch.empty(x.numel() + 1, dtype=torch.int8, device=dev)
    xv = base[1:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    assert not TD.b7_variant(n, c, k_out, aligned=False).vec
    got = _check_b7(xv, w, scale, bias, add, pos, "subm", "relu+bias+add")
    assert torch.equal(got, _check_b7(x, w, scale, bias, add, pos, "subm",
                                      "relu+bias+add"))


@pytest.mark.parametrize("c,k_out", [(5, 16), (16, 32), (64, 64),
                                     (128, 128)])
def test_b7_offset_groups_without_matches(dev, c, k_out):
    """A 5^3 kernel's 125 offsets (four staged groups) on 10,000 rows: the
    first third of the rows and offsets 32-63 (a whole group) match
    nothing, nor does offset 1; blocks with no match anywhere get the
    epilogue of a zero sum.  Bit-equal to plain."""
    x, w, scale, bias, add, pos = _b7_operands(dev, 10_000, c, k_out, "subm",
                                               19, kv=125, dead=(0, 3333))
    pos[32:64] = -1
    got = _check_b7(x, w, scale, bias, add, pos, "subm", "relu+bias+add")
    assert got[:3333].any()  # bias and residual alone


def test_int8_request_launches_no_weight_copy(dev):
    """A served int8 encoder request reads each layer's ``[kv, K, C]``
    weight as it is: it launches 21 B7 kernels, and its profiler window
    records no copy of a tensor of a layer weight's shape, where the same
    request with the weights held ``[kv, C, K]`` copies each of the 21 (the
    ops' host records: the profiler can lose a device op's record now and
    then)."""
    from torch.profiler import ProfilerActivity, profile

    from spconv_tpu_torch.quantization import (QuantizedSparseConv,
                                               observe_encoder_scales,
                                               quantize_encoder)

    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                           n_target=1500, device=dev)
    net = centerpoint_encoder(in_channels=5, bn=False, device=dev).eval()
    qnet = quantize_encoder(net, scales=observe_encoder_scales(net, [x]))
    mods = [m for m in qnet.modules() if isinstance(m, QuantizedSparseConv)]
    shapes = {tuple(m.weight_kv.transpose(1, 2).shape) for m in mods}

    def copies():
        with torch.no_grad():
            qnet(x)
            torch.cuda.synchronize()
            TD.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                qnet(x)
                torch.cuda.synchronize()
        assert TD.launch_counts["dg_fwd_q"] + TD.launch_counts[
            "dg_fwd_q_strided"] == 21
        return sum(1 for e in prof.events() if e.name == "aten::contiguous"
                   and e.input_shapes and tuple(e.input_shapes[0]) in shapes)

    assert len(mods) == 21 and copies() == 0
    held = [m.weight_kc for m in mods]
    for m in mods:
        m.weight_kc = m.weight_kv.contiguous().transpose(1, 2)
    copied = copies()
    for m, wkc in zip(mods, held):
        m.weight_kc = wkc
    assert copied == 21


def test_int8_encoder_on_card_matches_cpu(dev):
    """A small int8 CenterPoint encoder (quantized on the CPU from scales
    observed there) served on the card against its plain run on the CPU:
    coordinates and int8 outputs equal, bit for bit.  A request launches 4
    subm and 4 affine tables, 17 subm and 4 strided B7 and no B2."""
    from spconv_tpu_torch.quantization import (observe_encoder_scales,
                                               quantize_encoder)

    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                           n_target=1500, device="cpu")
    net = centerpoint_encoder(in_channels=5, bn=False, device="cpu").eval()
    qnet = quantize_encoder(net, scales=observe_encoder_scales(net, [x]))
    with torch.no_grad():
        ref = qnet(x)
        qnet.to(dev)
        xd = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                             n_target=1500, device=dev)[0]
        TD.reset_launch_counts()
        got = qnet(xd)
        torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_pos=4, dg_pos_affine=4,
                                       dg_fwd_q=17, dg_fwd_q_strided=4)
    assert torch.equal(got.indices.cpu(), ref.indices)
    assert ref.features.abs().max() > 0
    assert torch.equal(got.features.cpu(), ref.features)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_exported_centerpoint_matches_eager_on_card(dev, kind):
    """The CenterPoint encoder's ``bev`` request (f32, bf16, and int8 from
    ``quantize_encoder``) exported (``spconv_tpu_torch.export``), saved
    and reloaded: bit-equal to eager on the card, launching eager's
    kernels, kernel by kernel."""
    import io

    from spconv_tpu_torch.export import export_inference, serialize
    from spconv_tpu_torch.quantization import (observe_encoder_scales,
                                               quantize_encoder)

    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                           n_target=1500, dtype=dtype,
                                           device=dev)
    net = centerpoint_encoder(in_channels=5, bn=False, dtype=dtype,
                              device=dev).eval()
    if kind == "int8":
        with torch.no_grad():
            net = quantize_encoder(net, scales=observe_encoder_scales(
                net, [x]))

    def request(f, i):
        return net.bev(st.SparseConvTensor(f, i, x.spatial_shape, 1,
                                           keys_sorted=True))

    args = (x.features, x.indices)
    program = export_inference(request, args)
    loaded = torch.export.load(io.BytesIO(serialize(request, args)))
    outs, counts = [], []
    with torch.no_grad():
        for fn in (request, program.module(), loaded.module()):
            torch.cuda.synchronize()
            TD.reset_launch_counts()
            outs.append(fn(*args))
            torch.cuda.synchronize()
            counts.append(dict(TD.launch_counts))
    want = (_counts(dg_pos=4, dg_pos_affine=4, dg_fwd_q=17,
                    dg_fwd_q_strided=4) if kind == "int8" else
            _counts(dg_pos=4, dg_pos_affine=4, dg_fwd=17, dg_fwd_strided=4))
    assert counts == [want] * 3
    assert outs[0].abs().max() > 0
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])


# B6, the sorted-key pool: 3-d and 4-d grids with odd edges
_POOL_SHAPES = {3: (9, 41, 40), 4: (11, 13, 12, 13)}


def _pool_case(ndim, seed, dev, nonfinite=False):
    """A key-sorted input with an invalid tail, its keys and the pool's
    output keys (a bound below the output count), on ``dev``."""
    from spconv_tpu_torch.ops.rulebook import build_pool2_outputs

    shape = _POOL_SHAPES[ndim]
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, 2500, 24, rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, s in enumerate(shape):
        key = key * s + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    fb = np.zeros((2600, 24), np.float32)
    ib = np.full((2600, ndim + 1), -1, np.int32)
    fb[:2500], ib[:2500] = feats[order], inds[order]
    if nonfinite:
        fb[5, 1], fb[50, 2], fb[80, 3] = np.nan, np.inf, -np.inf
    ti = torch.from_numpy(ib).to(dev)
    _, out_keys, n_out, n_tot = build_pool2_outputs(
        ti, spatial_shape=shape, batch_size=1, out_bound=768)
    assert int(n_tot) > int(n_out)
    in_keys, _ = TC.linearize(ti, shape, 1)
    geom = dict(in_shape=shape, out_shape=tuple(s // 2 for s in shape),
                batch_size=1)
    return torch.from_numpy(fb).to(dev), in_keys, out_keys, geom


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("mode", ["max", "mean"])
def test_sk_pool_kernel_matches_plain(dev, dtype, ndim, mode):
    """B6 against its plain version on the card: max bit-equal, mean within
    1e-6*max|ref| (both sum in f32 in child order and divide once); one
    launch counted; sentinel parents 0."""
    from spconv_tpu_torch.ops import sorted_pool as TS

    x, in_keys, out_keys, geom = _pool_case(ndim, 20 + ndim, dev)
    x = x.to(dtype)
    ref = TS.sk_pool2_plain(x, in_keys, out_keys, mode=mode, **geom)
    before = dict(TD.launch_counts)
    got = TS.sk_pool2(x, in_keys, out_keys, mode=mode, **geom)
    torch.cuda.synchronize()
    assert TD.launch_counts["sk_pool"] == before["sk_pool"] + 1
    assert sum(TD.launch_counts.values()) == sum(before.values()) + 1
    assert got.dtype == dtype and got.shape == ref.shape
    if mode == "max":
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-6 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["max", "mean"])
def test_sk_pool_kernel_nonfinite_matches_plain(dev, dtype, mode):
    """NaN and +-inf inputs: the max is written as 0 where not finite (the
    kernel's fmax-free NaN-propagating max), the mean keeps NaN and inf;
    equal to the plain version."""
    from spconv_tpu_torch.ops import sorted_pool as TS

    x, in_keys, out_keys, geom = _pool_case(3, 30, dev, nonfinite=True)
    x = x.to(dtype)
    got = TS.sk_pool2(x, in_keys, out_keys, mode=mode, **geom)
    ref = TS.sk_pool2_plain(x, in_keys, out_keys, mode=mode, **geom)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    if mode == "max":
        assert torch.isfinite(got).all()
    else:
        assert got.isnan().any() and got.isinf().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["max", "mean"])
def test_sk_pool_backward_on_card_matches_cpu(dev, dtype, mode):
    """``SKPool2Fn`` on the card (B6 forward, torch-ops backward) against
    the same on the CPU (plain forward): features on a grid of 0.5, so
    that tied children each get the full gradient; equal within
    1e-6*max|ref|."""
    from spconv_tpu_torch.ops import sorted_pool as TS

    x, in_keys, out_keys, geom = _pool_case(3, 40, dev)
    x = (x * 2).round().div(2).to(dtype)
    g = (geom["in_shape"], geom["out_shape"], 1, mode)
    dout = torch.randn((out_keys.shape[0], x.shape[1]),
                       generator=torch.Generator().manual_seed(1)).to(dtype)
    grads = []
    for d in (dev, torch.device("cpu")):
        xd = x.detach().to(d).clone().requires_grad_()
        TS.SKPool2Fn.apply(xd, in_keys.to(d), out_keys.to(d),
                           g).backward(dout.to(d))
        grads.append(xd.grad.float().cpu())
    scale = grads[1].abs().max().item()
    assert scale > 0
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-6 * scale


def test_sk_pool_benchnet_on_card_matches_cpu(dev):
    """The benchmark net with its pools on ``algo="sk"`` (B6) on the card
    against the CPU's plain versions, f32: a step's loss within 1e-4
    relative and every weight grad within 1e-3*max|ref| (as the seg-pool
    step: f32 sums in another order may break a near-tie in a max pool);
    a step launches 6 B6."""
    from spconv_tpu_torch.modules import SparseMaxPool3d

    shape = (64, 128, 128)
    voxels, coors, _ = TB.synthetic_scan(0, shape=shape, n_target=1600)
    net = TB.BenchNet(shape, device="cpu")
    for i in range(6):
        net.pools[i] = SparseMaxPool3d(2, 2, algo="sk")
    ref_loss = TB.train_step(
        net, TB.make_bench_input(voxels, coors, shape, device="cpu"), 0.0)
    ref = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.to(dev)
    TD.reset_launch_counts()
    loss = TB.train_step(
        net, TB.make_bench_input(voxels, coors, shape, device=dev), 0.0)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_pos=7, dg_pos_rev=7, dg_fwd=14,
                                       dg_dgrad=13, dg_wgrad=14, sk_pool=6)
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * ref_loss.item()
    for k, p in net.named_parameters():
        scale = ref[k].abs().max().item()
        err = (p.grad.cpu() - ref[k]).abs().max().item()
        assert scale > 0 and err <= 1e-3 * scale, (k, err, scale)


# the search mode (S1-S4): kernel 3, and kernel 5 with a dilation (125
# offsets: four of the kernels' search groups)
_SEARCH = {"k3": ((3, 3, 3), (1, 1, 1)), "k5": ((5, 5, 5), (1, 2, 1))}


def _search_case(dev, dtype, c, k_out, kernel, seed):
    """Features and dout on 3000 rows of a 3072-row buffer, weights, the
    keys and the geometry on the card; the forward and reversed B1 tables
    on the CPU."""
    feats, inds = _sorted_input(seed, 3000, c, 3072)
    ksize, dil = _SEARCH[kernel]
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    geom = TD.SearchGeom.of(ksize, dil, SHAPE, 1)
    kv = int(np.prod(ksize))
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((kv, c, k_out), generator=g) / np.sqrt(kv * c)
    dout = torch.randn((3072, k_out), generator=g)
    dout[3000:] = 0
    tabs = [TD.dg_pos_plain(keys, reverse=r, **geom._asdict())
            for r in (False, True)]
    return (torch.from_numpy(feats).to(dev, dtype), w.to(dev, dtype),
            dout.to(dev, dtype), keys.to(dev), geom, tabs)


@pytest.mark.parametrize("kernel", sorted(_SEARCH))
@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 2e-5, 1e-4),
                                            (torch.bfloat16, 1.6e-2, 1.6e-2)])
@pytest.mark.parametrize("c,k_out", [(3, 64), (64, 96), (160, 256), (12, 20)])
def test_search_kernels_match_plain_and_table(dev, dtype, tol, wtol, c, k_out,
                                              kernel):
    """S1, S2 and S3 against their plain versions (tolerances as B2's,
    dgrad's and wgrad's), bit-equal to B1 followed by the table-mode kernel
    (``dg_fwd``, ``dg_dgrad``, ``dg_wgrad`` on the card's tables), S3
    bit-equal across two runs; one launch each under its own counter, no
    table built; rows past the live ones are 0."""
    x, w, dout, keys, geom, tabs = _search_case(dev, dtype, c, k_out, kernel,
                                                10)
    TD.reset_launch_counts()
    out = TD.dg_fwd_search(x, w, keys, geom)
    din = TD.dg_dgrad_search(dout, w, keys, geom)
    dw = TD.dg_wgrad_search(x, dout, keys, geom)
    again = TD.dg_wgrad_search(x, dout, keys, geom)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_search=1, dg_dgrad_search=1,
                                       dg_wgrad_search=2)
    assert torch.equal(dw, again)
    refs = (TD.dg_fwd_plain(x.cpu(), w.cpu(), tabs[0]),
            TD.dg_dgrad_plain(dout.cpu(), w.cpu(), tabs[1]),
            TD.dg_wgrad_plain(x.cpu(), dout.cpu(), tabs[1]))
    for got, ref, t in zip((out, din, dw), refs, (tol, tol, wtol)):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.cpu().float() - ref.float()).abs().max().item()
        assert err <= t * ref.float().abs().max().item(), err
    pos = TD.build_dg_pos(keys, **geom._asdict())
    rev = TD.build_dg_pos(keys, reverse=True, **geom._asdict())
    assert torch.equal(pos.cpu(), tabs[0]) and torch.equal(rev.cpu(), tabs[1])
    assert torch.equal(out, TD.dg_fwd(x, w, pos))
    assert torch.equal(din, TD.dg_dgrad(dout, w, rev))
    assert torch.equal(dw, TD.dg_wgrad(x, dout, rev))
    assert not out[3000:].any() and not din[3000:].any()


@pytest.mark.parametrize("kernel", sorted(_SEARCH))
@pytest.mark.parametrize("c,k_out,mode", [
    (5, 16, "relu+bias"), (16, 16, "relu+add"), (64, 64, "none"),
    (128, 128, "relu+bias+add"), (12, 20, "none+bias")])
def test_dg_fwd_q_search_matches_plain_and_table(dev, c, k_out, mode,
                                                 kernel):
    """S4 bit-equal to its plain version (run on the CPU) and to B1
    followed by ``dg_fwd_q`` on the card, in every epilogue mode; one
    launch under ``dg_fwd_q_search``."""
    feats, inds = _sorted_input(11, 3000, c, 3072)
    ksize, dil = _SEARCH[kernel]
    kv = int(np.prod(ksize))
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    geom = TD.SearchGeom.of(ksize, dil, SHAPE, 1)
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randint(-127, 128, (3072, c)).astype(np.int8))
    x[3000:] = 0
    w = torch.from_numpy(rng.randint(-127, 128, (kv, c, k_out))
                         .astype(np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, k_out) * 60
                              / (5300 * np.sqrt(9 * c))).astype(np.float32))
    bias = (torch.from_numpy(rng.uniform(-20, 20, k_out).astype(np.float32))
            if "bias" in mode else None)
    add = torch.from_numpy(rng.randint(-127, 128, (3072, k_out))
                           .astype(np.int8)) if "add" in mode else None
    kw = dict(act="relu" if "relu" in mode else "none", add_scale=0.37)
    ref = TD.dg_fwd_q_search_plain(x, w, keys, scale, bias, geom, add=add,
                                   **kw)
    assert (ref != 0).any()
    on = [None if t is None else t.to(dev)
          for t in (x, w, keys, scale, bias, add)]
    TD.reset_launch_counts()
    got = TD.dg_fwd_q_search(*on[:5], geom, add=on[5], **kw)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_q_search=1)
    assert torch.equal(got.cpu(), ref)
    pos = TD.build_dg_pos(on[2], **geom._asdict())
    assert torch.equal(got, TD.dg_fwd_q(on[0], on[1], pos, on[3], on[4],
                                        add=on[5], **kw))


def _no_key(net):
    for conv in net.convs:
        conv.indice_key = None
    return net


def test_no_key_benchnet_on_card_matches_cpu(dev):
    """BenchNet with no ``indice_key`` through S1 on the card against the
    plain route on the CPU, f32: 14 ``dg_fwd_search`` launches and no
    table, coordinates equal, features within 1e-4*max|ref|."""
    shape = (64, 128, 128)
    voxels, coors, _ = TB.synthetic_scan(0, shape=shape, n_target=1600)
    net = _no_key(TB.BenchNet(shape, device="cpu"))
    with torch.no_grad():
        ref = net.forward_stages(TB.make_bench_input(voxels, coors, shape,
                                                     device="cpu"))
        net.to(dev)
        TD.reset_launch_counts()
        got = net.forward_stages(
            TB.make_bench_input(voxels, coors, shape, device=dev))
        torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_search=14)
    assert not got[-1].indice_dict
    for r, g in zip(ref, got):
        assert torch.equal(g.indices.cpu(), r.indices)
        scale = r.features.abs().max().item()
        err = (g.features.cpu() - r.features).abs().max().item()
        assert err <= 1e-4 * scale, (err, scale)


def test_no_key_benchnet_train_step_on_card_matches_cpu(dev):
    """One f32 training step of the no-key BenchNet through S1-S3 on the
    card against the same step through the plain versions on the CPU:
    losses within 1e-4 relative, every weight grad within 1e-3*max|ref| (as
    the keyed step's test).  A step launches 14 S1, 13 S2, 14 S3 and no
    table."""
    shape = (64, 128, 128)
    voxels, coors, _ = TB.synthetic_scan(0, shape=shape, n_target=1600)
    net = _no_key(TB.BenchNet(shape, device="cpu"))
    ref_loss = TB.train_step(
        net, TB.make_bench_input(voxels, coors, shape, device="cpu"), 0.0)
    ref = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.to(dev)
    TD.reset_launch_counts()
    loss = TB.train_step(
        net, TB.make_bench_input(voxels, coors, shape, device=dev), 0.0)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_search=14, dg_dgrad_search=13,
                                       dg_wgrad_search=14)
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * ref_loss.item()
    for k, p in net.named_parameters():
        scale = ref[k].abs().max().item()
        err = (p.grad.cpu() - ref[k]).abs().max().item()
        assert scale > 0 and err <= 1e-3 * scale, (k, err, scale)


# transposed convs: (grid, ksize, stride, padding, output_padding, batch):
# the USAGE.md chain's k2 s2, the general k3 s2 p1 op1, a stride-1 one and
# two batches
_TRANSPOSED = [((20, 32, 32), (2, 2, 2), (2, 2, 2), (0, 0, 0), (0, 0, 0), 1),
               ((20, 32, 32), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), 1),
               ((20, 32, 32), (3, 3, 3), (1, 1, 1), (1, 1, 1), (0, 0, 0), 1),
               ((10, 16, 16), (3, 3, 3), (2, 2, 2), (1, 1, 1), (0, 0, 0), 2)]


def _transposed_case(shape, ksize, stride, padding, opad, batch, c=8,
                     k_out=16, dtype=torch.float32, seed=15):
    """A transposed conv's operands on the CPU, on the swapped spaces of
    ``dg_regular_conv``: its input's keys (``out_keys``), its expanded
    output's (``in_keys``), the geometry, the forward's divide table and
    the backward's affine table (plain), features ``x`` on the input rows,
    a ``dout`` on the output rows and ``w`` ``[kv, c, k_out]``."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, 1200, c, batch_size=batch,
                                       rng=rng)
    key = inds[:, 0].astype(np.int64)
    for a, sz in enumerate(shape):
        key = key * sz + inds[:, a + 1]
    order = np.argsort(key, kind="stable")
    nbuf = 1280 * batch
    ib = np.full((nbuf, 4), -1, np.int32)
    ib[:len(inds)] = inds[order]
    inds_t = torch.from_numpy(ib)
    dil = (1, 1, 1)
    out_inds, exp_keys, _, _ = build_deconv_outputs(
        inds_t, spatial_shape=shape, batch_size=batch, ksize=ksize,
        stride=stride, padding=padding, dilation=dil, out_padding=opad)
    in_keys, _ = TC.linearize(inds_t, shape, batch)
    geom = dict(ksize=ksize, stride=stride, padding=padding, dilation=dil,
                in_shape=tuple(TC.get_deconv_output_size(
                    shape, ksize, stride, padding, dil, opad)),
                out_shape=shape, batch_size=batch)
    div = TD.dg_pos_divide_plain(exp_keys, in_keys, **geom)
    aff = TD.dg_pos_affine_plain(exp_keys, in_keys, **geom)
    live_in, live_out = inds_t[:, 0] >= 0, out_inds[:, 0] >= 0
    g = torch.Generator().manual_seed(seed)
    kv = int(np.prod(ksize))
    x = torch.randn((nbuf, c), generator=g) * live_in[:, None]
    dout = torch.randn((exp_keys.shape[0], k_out), generator=g) \
        * live_out[:, None]
    w = torch.randn((kv, c, k_out), generator=g) / np.sqrt(kv * c)
    return dict(exp_keys=exp_keys, in_keys=in_keys, geom=geom, div=div,
                aff=aff, x=x.to(dtype), dout=dout.to(dtype), w=w.to(dtype),
                live_in=live_in)


@pytest.mark.parametrize("case", _TRANSPOSED)
def test_transposed_tables_match_plain(dev, case):
    """B1 divide (the forward's table, over the expanded output rows) and
    affine (the backward's, over the input rows) on a transposed conv's
    swapped spaces equal their plain versions exactly, and count under
    ``dg_pos_divide_transposed`` / ``dg_pos_affine_transposed``."""
    t = _transposed_case(*case)
    keys = (t["exp_keys"].to(dev), t["in_keys"].to(dev))
    TD.reset_launch_counts()
    div = TD.build_dg_pos_divide(*keys, path="transposed", **t["geom"])
    aff = TD.build_dg_pos_affine(*keys, path="transposed", **t["geom"])
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_pos_divide_transposed=1,
                                       dg_pos_affine_transposed=1)
    assert (t["div"] >= 0).any()
    assert torch.equal(div.cpu(), t["div"]) and torch.equal(aff.cpu(),
                                                            t["aff"])


@pytest.mark.parametrize("dtype,tol,wtol", [(torch.float32, 2e-5, 1e-4),
                                            (torch.bfloat16, 1.6e-2,
                                             1.6e-2)])
@pytest.mark.parametrize("case", _TRANSPOSED)
def test_transposed_gemm_kernels_match_plain(dev, dtype, tol, wtol, case):
    """B2 on the divide table (path ``"transposed"``), and dgrad and wgrad
    through the affine table, against their plain versions; tolerances as
    the strided ones'.  Rows without a match get a zero din; two wgrad runs
    are bit-equal."""
    t = _transposed_case(*case, dtype=dtype)
    x, dout, w = (t[k].to(dev) for k in ("x", "dout", "w"))
    div, aff = t["div"].to(dev), t["aff"].to(dev)
    TD.reset_launch_counts()
    out = TD.dg_fwd(x, w, div, path="transposed")
    din = TD.dg_dgrad(dout, w, aff, path="transposed")
    dw = TD.dg_wgrad(x, dout, aff, path="transposed")
    again = TD.dg_wgrad(x, dout, aff, path="transposed")
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_transposed=1,
                                       dg_dgrad_transposed=1,
                                       dg_wgrad_transposed=2)
    assert torch.equal(dw, again)
    for got, ref, tl in ((out, TD.dg_fwd_plain(x, w, div), tol),
                         (din, TD.dg_dgrad_plain(dout, w, aff), tol),
                         (dw, TD.dg_wgrad_plain(x, dout, aff), wtol)):
        ref = ref.float()
        err = (got.float() - ref).abs().max().item()
        assert ref.abs().max().item() > 0 and err <= tl * ref.abs().max(
        ).item(), err
    assert not din[~t["live_in"].to(dev)].any()


def _usage_chain(device, seed=0):
    """The decoder chain of ``docs/USAGE.md:34-38``."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(device=device, generator=gen)
    return st.SparseSequential(
        st.SubMConv3d(32, 64, 3, indice_key="c0", **kw),
        st.SparseConv3d(64, 128, 3, stride=2, padding=1, indice_key="down1",
                        **kw),
        st.SparseInverseConv3d(128, 64, 3, indice_key="down1", **kw),
        st.SparseConvTranspose3d(64, 32, 2, stride=2, **kw))


def _chain_input(device):
    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                           n_target=1500, device=device)
    g = torch.Generator().manual_seed(1)
    f = torch.randn((x.indices.shape[0], 32), generator=g)
    return x.replace_feature((f * x.valid_mask.cpu()[:, None]).to(device))


def test_transposed_chain_train_step_on_card_matches_cpu(dev):
    """One f32 training step of the USAGE.md chain (subm, strided, inverse,
    transposed) through every kernel on the card against the same step
    through the plain versions on the CPU: coordinates equal, the loss
    within 1e-4 relative, every grad within 1e-4*max|ref|.  The transposed
    conv launches B1 divide and affine, B2, dgrad and wgrad under
    ``*_transposed``; the chain's input needs no gradient, so the subm
    conv launches no dgrad."""
    net = _usage_chain("cpu")
    x = _chain_input("cpu")
    with torch.no_grad():
        ref_out = net(x)
    ref_loss = TB.train_step(net, x, 0.0)
    ref = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.to(dev)
    xd = _chain_input(dev)
    with torch.no_grad():
        out = net(xd)
    assert torch.equal(out.indices.cpu(), ref_out.indices)
    assert out.spatial_shape == ref_out.spatial_shape == (80, 128, 128)
    TD.reset_launch_counts()
    loss = TB.train_step(net, xd, 0.0)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(
        dg_pos=1, dg_pos_rev=1, dg_pos_affine=1, dg_pos_divide=1,
        dg_pos_divide_transposed=1, dg_pos_affine_transposed=1,
        dg_fwd=1, dg_fwd_strided=1, dg_fwd_inverse=1, dg_fwd_transposed=1,
        dg_dgrad_strided=1, dg_dgrad_inverse=1,
        dg_dgrad_transposed=1, dg_wgrad=1, dg_wgrad_strided=1,
        dg_wgrad_inverse=1, dg_wgrad_transposed=1)
    assert abs(loss.item() - ref_loss.item()) <= 1e-4 * ref_loss.item()
    for k, p in net.named_parameters():
        scale = ref[k].abs().max().item()
        err = (p.grad.cpu() - ref[k]).abs().max().item()
        assert scale > 0 and err <= 1e-4 * scale, (k, err, scale)


def _probe_counts(**nonzero):
    return {**dict.fromkeys(TP.launch_counts, 0), **nonzero}


@pytest.mark.parametrize("dtype,place", [
    *((d, p) for d in (torch.int8, torch.bfloat16, torch.int32,
                       torch.float32) for p in ("aligned", "unaligned")),
    (torch.int8, "4 bytes off"), (torch.bfloat16, "4 bytes off")])
@pytest.mark.parametrize("start", [0, 3, 96, 384, 4090, -2])
@pytest.mark.parametrize("width", [128, 7, 8, 12])
def test_probe_copy_matches_plain(dev, dtype, start, width, place):
    """The copy kernel bit-equal to its plain version for every element
    size, on the 16-byte path (width 128; 8 and 12 where they hold whole
    vectors of the kind: int8 both, bf16 8 only, 4-byte both; int8 also
    with ``x`` 4 bytes past a 16-byte boundary, since it reads 4 bytes a
    vector) and the one-element path (width 7, the other widths, and ``x``
    one element, or for bf16 4 bytes, past a 16-byte boundary), rows past
    either end of the table 0; and the chunk copy."""
    g = torch.Generator().manual_seed(start + 7 + width)
    x = torch.randint(-100, 100, (4096, width), generator=g).to(dtype)
    s = torch.tensor([start], dtype=torch.int32)
    ref = TP.copy_rows_plain(x, s, 64)
    off = {"aligned": 0, "unaligned": 1,
           "4 bytes off": 4 // x.element_size()}[place]
    xd = _off_by_one(x, dev, off) if off else x.to(dev)
    if x.dtype == torch.int8:
        assert TP.copy_launch_plan(xd, 64).vec == (width % 4 == 0
                                                   and off in (0, 4))
    TP.reset_launch_counts()
    got = TP.copy_rows(xd, s.to(dev), 64)
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_copy=1)
    assert got.dtype == ref.dtype and torch.equal(got.cpu(), ref)
    tab = torch.rand((256, 128), generator=g)
    s = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(TP.copy_rows(tab.to(dev), s.to(dev), 16, scale=16,
                                    off=16).cpu(), tab[96:112])


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_probe_copy_replays_with_a_new_device_start(dev, dtype):
    """``copy_rows`` captured in a CUDA graph and replayed after ``start``
    changes on the device gives the new rows: the kernel reads the start
    on the device, with no host sync (a sync would fail the capture)."""
    x = torch.randint(-100, 100, (4096, 128),
                      generator=torch.Generator().manual_seed(2)).to(dtype)
    xd = x.to(dev)
    start = torch.tensor([96], dtype=torch.int32, device=dev)
    TP.copy_rows(xd, start, 64)  # the library built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    TP.reset_launch_counts()
    with torch.cuda.graph(graph):
        out = TP.copy_rows(xd, start, 64)
    assert TP.launch_counts == _probe_counts(probe_copy=1)
    for st in (96, 3, 4090, -2, 384):
        start.fill_(st)
        graph.replay()
        torch.cuda.synchronize()
        ref = TP.copy_rows_plain(x, torch.tensor([st], dtype=torch.int32), 64)
        assert torch.equal(out.cpu(), ref), st


@pytest.mark.parametrize("m,n,place", [
    (128, 128, "aligned"), (100, 37, "aligned"), (1, 65, "aligned"),
    (4096, 8, "aligned"), (8, 4096, "aligned"), (128, 128, "unaligned")])
def test_probe_transpose_matches_plain(dev, m, n, place):
    """The transpose bit-equal to its plain version on its plan (16-byte
    accesses where m and n are multiples of 4 and ``a`` is aligned, else
    masked one element at a time), and every other plan of the sweep
    (``tools/copy_tiles.py``: each lane pair) launched on the same
    input."""
    a = torch.rand((m, n), generator=torch.Generator().manual_seed(m))
    ad = _off_by_one(a, dev) if place == "unaligned" else a.to(dev)
    ref = TP.transpose_plain(a)
    TP.reset_launch_counts()
    got = TP.transpose(ad)
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_transpose=1)
    assert torch.equal(got.cpu(), ref)
    sms = TD.sm_count(dev.index or 0)
    aligned = place == "aligned"
    for plan in [TP.transpose_plan(m, n, sms, aligned=aligned, tile=t)
                 for t in TP.TRANSPOSE_TILES + ((4, 2), (2, 2))]:
        out = torch.full((n, m), float("nan"), device=dev)
        assert TP.launch_transpose(load_library(), ad, plan, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("rows", [8, 32, 64, 128, 7, 33, 129, 200])
def test_probe_gathers_match_plain(dev, dtype, rows):
    """The lane gather bit-equal to its plain version (indices outside the
    row give 0) with one launch, on its plan and on every plan of the
    sweep (``tools/join_gather_tiles.py``: 1-16 warps a block), row
    counts the warps of a block do not divide included; and the row broadcast for f32, also to more
    output rows than ``x`` has, on every warp and row split."""
    g = torch.Generator().manual_seed(rows)
    x = torch.randint(-2**30, 2**30, (rows, 128), generator=g)
    x = x.to(dtype) if dtype == torch.int32 else torch.rand(
        (rows, 128), generator=g)
    idx = torch.randint(-2, 130, (rows, 128), generator=g, dtype=torch.int32)
    ref = TP.lane_gather_plain(x, idx)
    xd, idxd = x.to(dev), idx.to(dev)
    TP.reset_launch_counts()
    got = TP.lane_gather(xd, idxd)
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_lane_gather=1)
    assert torch.equal(got.cpu(), ref)
    sms = TD.sm_count(dev.index or 0)
    for plan in [TP.gather_plan(rows, 128, sms, rb=rb)
                 for rb in TP.GATHER_WARPS + (16,)]:
        out = torch.full_like(xd, -1)
        assert TP.launch_gather(load_library(), xd, idxd, plan, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref), plan
    if dtype == torch.float32:
        for row, n in ((3, 8), (rows // 2, 3 * rows + 1)):
            TP.reset_launch_counts()
            got = TP.row_broadcast(xd, row, 4.0, n)
            torch.cuda.synchronize()
            assert TP.launch_counts == _probe_counts(probe_row_broadcast=1)
            ref = TP.row_broadcast_plain(x, row, 4.0, n)
            assert torch.equal(got.cpu(), ref)
            for plan in [TP.gather_plan(n, 128, sms, broadcast=True, rb=rb,
                                        rw=rw)
                         for rb in (1, 2, 4, 8) for rw in (1, 2, 4, 8)]:
                out = torch.full((n, 128), float("nan"), device=dev)
                assert TP.launch_broadcast(load_library(), xd, row, 4.0,
                                           plan, out) == 0
                torch.cuda.synchronize()
                assert torch.equal(out.cpu(), ref), plan


@pytest.mark.parametrize("width", [4, 8, 64, 132, 256, 1000])
def test_probe_lane_gather_widths(dev, width):
    """Widths other than the probes' 128 (past it a lane moves several
    vectors), each plan bit-equal to plain."""
    g = torch.Generator().manual_seed(width)
    x = torch.rand((37, width), generator=g)
    idx = torch.randint(-3, width + 3, (37, width), generator=g,
                        dtype=torch.int32)
    ref = TP.lane_gather_plain(x, idx)
    xd, idxd = x.to(dev), idx.to(dev)
    TP.reset_launch_counts()
    got = TP.lane_gather(xd, idxd)
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_lane_gather=1)
    assert torch.equal(got.cpu(), ref)
    sms = TD.sm_count(dev.index or 0)
    for plan in [TP.gather_plan(37, width, sms, rb=rb)
                 for rb in TP.GATHER_WARPS]:
        out = torch.full_like(xd, float("nan"))
        assert TP.launch_gather(load_library(), xd, idxd, plan, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref), plan


def _join_operands(table_dtype, t, w, c, kind, g):
    """probes, keys (ascending) and table for the join: ``random`` (probes
    ``3 i``, keys drawn from ``[0, 3 t)``), ``unsorted`` (the same probes
    shuffled), ``negative`` (probes and keys in ``[-500, 500)``), ``one
    run`` (every key equal, one probe in four matching it), ``extremes``
    (keys and probes at the int32 limits beside ``negative``'s)."""
    if kind == "extremes":
        lim = torch.tensor([-2**31, -2**31, 2**31 - 1, 2**31 - 1],
                           dtype=torch.int32)
        keys = torch.sort(torch.cat([torch.randint(
            -500, 500, (w - 4,), generator=g, dtype=torch.int32), lim])).values
        probes = torch.cat([lim[1:3], torch.randint(
            -500, 500, (t - 2,), generator=g, dtype=torch.int32)])
    elif kind == "one run":
        keys = torch.full((w,), 7, dtype=torch.int32)
        probes = torch.where(torch.arange(t) % 4 == 0, 7,
                             torch.arange(t) + 8).int()
    elif kind == "negative":
        keys = torch.sort(torch.randint(-500, 500, (w,), generator=g,
                                        dtype=torch.int32)).values
        probes = torch.randint(-500, 500, (t,), generator=g,
                               dtype=torch.int32)
    else:
        probes = torch.arange(t, dtype=torch.int32) * 3
        if kind == "unsorted":
            probes = probes[torch.randperm(t, generator=g)]
        keys = torch.sort(torch.randint(0, 3 * t, (w,), generator=g,
                                        dtype=torch.int32)).values
    table = (torch.randint(-127, 127, (w, c), generator=g).to(torch.int8)
             if table_dtype == torch.int8 else torch.randn((w, c),
                                                           generator=g))
    return probes, keys, table


@pytest.mark.parametrize("table_dtype,t,w,c,kind", [
    (torch.int8, 128, 256, 128, "random"),
    (torch.float32, 256, 1024, 64, "random"),
    (torch.float32, 50, 300, 33, "random"),
    (torch.int8, 128, 256, 128, "unsorted"),
    (torch.float32, 256, 1024, 64, "unsorted"),
    (torch.int8, 100, 777, 36, "negative"),
    (torch.float32, 64, 500, 8, "negative"),
    (torch.float32, 64, 300, 64, "extremes"),
    (torch.int8, 64, 2000, 128, "extremes"),
    (torch.int8, 40, 256, 128, "one run"),
    (torch.float32, 40, 1024, 64, "one run"),
    (torch.int8, 100, 2000, 64, "random"),
    (torch.float32, 40, 3000, 64, "one run"),
    (torch.float32, 1, 5000, 64, "random"),
    (torch.int8, 1, 9001, 128, "one run"),
    (torch.float32, 64, 300, 64, "misaligned"),
    (torch.int8, 64, 300, 128, "misaligned"),
    (torch.int8, 64, 300, 128, "4 bytes off")])
def test_probe_join_matches_plain(dev, table_dtype, t, w, c, kind):
    """The one-hot join bit-equal to its plain version (the f32 sums in
    the plain version's order) with one launch, int8 -> int32 and f32:
    keys with repeats, probes in any order, negative, or matching nothing,
    a run of every key, keys counted in registers and past those
    (searched in global memory), a table one element off its alignment
    (the one-element path), an int8 table 4 bytes past a 16-byte boundary
    (16-byte outputs from 4-byte reads); and on every plan of the sweep
    (``tools/join_gather_tiles.py``: block sizes, each search)."""
    g = torch.Generator().manual_seed(t + w)
    off = {"misaligned": 1, "4 bytes off": 4}.get(kind)
    probes, keys, table = _join_operands(table_dtype, t, w, c,
                                         "random" if off else kind, g)
    ref = TP.keyed_sum_plain(probes, keys, table)
    pd, kd = probes.to(dev), keys.to(dev)
    td = _off_by_one(table, dev, off) if off else table.to(dev)
    if kind == "4 bytes off":
        assert td.data_ptr() % 16 == 4
    plan = TP.join_launch_plan(pd, kd, td)
    assert plan.vec == (kind != "misaligned" and c % 4 == 0)
    assert plan == TP.join_plan(t, w, c, TD.sm_count(dev.index or 0),
                                aligned=plan.vec)
    TP.reset_launch_counts()
    got = TP.keyed_sum(pd, kd, td)
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_join=1)
    assert torch.equal(got.cpu(), ref)
    sms = TD.sm_count(dev.index or 0)
    for p in [TP.join_plan(t, w, c, sms, aligned=plan.vec, threads=n,
                           search=sr)
              for sr in TP.JOIN_SEARCHES
              if sr != "count" or w <= TP.JOIN_COUNT_KEYS
              for n in TP.JOIN_THREADS]:
        out = torch.full_like(got, -1)
        assert TP.launch_join(load_library(), pd, kd, td, p, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref), p


def test_probe_rank_matches_plain(dev):
    g = torch.Generator().manual_seed(3)
    keys = torch.sort(torch.randint(0, 10_000, (128,), generator=g,
                                    dtype=torch.int32)).values
    probes = torch.randint(0, 10_000, (16, 128), generator=g,
                           dtype=torch.int32)
    TP.reset_launch_counts()
    got = TP.lane_rank(keys.to(dev), probes.to(dev))
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_rank=1)
    assert torch.equal(got.cpu(), TP.lane_rank_plain(keys, probes))


@pytest.mark.parametrize("w_n", (1, 100, 128, 1024, 5000))
@pytest.mark.parametrize("lanes", (1, 7, 128))
@pytest.mark.parametrize("rows,place", [(16, "aligned"), (33, "aligned"),
                                        (16, "misaligned")])
def test_probe_rank_sizes_match_plain(dev, w_n, lanes, rows, place):
    """The warp-a-row rank bit-equal to its plain version with one launch
    at every key count (counted up to 1,024, searched past it), row width
    (16-byte bodies with a head and a tail a row at 7 lanes) and row
    count, keys with repeats, probes below, between and above them, the
    keys one element off their 16-byte alignment (counted one a lane); and
    on every plan of the sweep (``tools/join_gather_tiles.py``)."""
    g = torch.Generator().manual_seed(w_n + lanes + rows)
    keys = torch.sort(torch.randint(0, 3000, (w_n,), generator=g,
                                    dtype=torch.int32)).values
    probes = torch.randint(-10, 3010, (rows, lanes), generator=g,
                           dtype=torch.int32)
    probes[0, 0], probes[-1, 0] = -5, 3005
    ref = TP.lane_rank_plain(keys, probes)
    kd = (_off_by_one(keys, dev) if place == "misaligned"
          else keys.to(dev))
    pd = probes.to(dev)
    plan = TP.rank_launch_plan(kd, pd)
    assert plan.kvec == (place == "aligned" and w_n <= TP.RANK_COUNT_KEYS)
    TP.reset_launch_counts()
    got = TP.lane_rank(kd, pd)
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_rank=1)
    assert torch.equal(got.cpu(), ref)
    sms = TD.sm_count(dev.index or 0)
    for p in [TP.rank_plan(rows, w_n, lanes, sms, aligned=plan.kvec, rb=rb,
                           search=sr)
              for sr in TP.RANK_SEARCHES
              if sr != "count" or w_n <= TP.RANK_COUNT_KEYS
              for rb in TP.RANK_WARPS + (16,)]:
        out = torch.full_like(got, -1)
        assert TP.launch_rank(load_library(), kd, pd, p, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref), p


def _probe_gemm_operands(m, k, n, values, g):
    """int8 and f32 operands: uniform ("random"); s8 of only -128 and 127
    with a row and a column all -128 (the largest sum, 16384 K) and f32
    each exactly halfway between two bf16 values ("edge"); or uniform in
    storage one element past a 16-byte boundary ("unaligned")."""
    if values == "edge":
        a8 = torch.where(torch.rand((m, k), generator=g) < 0.5, -128, 127)
        b8 = torch.where(torch.rand((k, n), generator=g) < 0.5, -128, 127)
        a8[0], b8[:, 0] = -128, -128
        half = [((torch.rand(s, generator=g) * 2 - 1).bfloat16().float()
                 .view(torch.int32) | 0x8000).view(torch.float32)
                for s in ((m, k), (k, n))]
        return a8.to(torch.int8), b8.to(torch.int8), *half
    a8 = torch.randint(-127, 127, (m, k), generator=g).to(torch.int8)
    b8 = torch.randint(-127, 127, (k, n), generator=g).to(torch.int8)
    return a8, b8, torch.rand((m, k), generator=g), torch.rand((k, n),
                                                               generator=g)


def _off_by_one(t, dev, k=1):
    """``t`` on ``dev``, contiguous, one element (or ``k``) past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=dev)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


# the probes' shapes, then ragged ones reaching each tile of
# ops/probes.py::gemm_plan, K split over 1-8 warps, a K of one MMA step
# and a warp slice staged in several rounds
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (128, 432, 128),
                                   (70, 40, 90), (1, 1, 1), (129, 33, 65),
                                   (64, 1000, 48), (256, 432, 256),
                                   (512, 96, 512), (192, 72, 224),
                                   (64, 3000, 48), (32, 4096, 32)])
@pytest.mark.parametrize("values", ["random", "edge", "unaligned"])
def test_probe_gemm_matches_plain(dev, m, k, n, values):
    """s8 -> s32 bit-equal to its plain version; bf16 within the probe's
    own ``rtol=2e-2`` of the f32 product (``tools/probe_dg.py:109``) and
    within 1e-5 of max|ref| of the plain version (f32 sums in another
    order), inputs halfway between two bf16 values rounded to even as the
    plain version rounds them, and two runs bit-equal."""
    g = torch.Generator().manual_seed(k)
    a8, b8, a, b = _probe_gemm_operands(m, k, n, values, g)
    place = ((lambda t: _off_by_one(t, dev)) if values == "unaligned"
             else (lambda t: t.to(dev)))
    ops8, ops = (place(a8), place(b8)), (place(a), place(b))
    TP.reset_launch_counts()
    got8 = TP.gemm(*ops8)
    got = TP.gemm(*ops).cpu()
    again = TP.gemm(*ops).cpu()
    torch.cuda.synchronize()
    assert TP.launch_counts == _probe_counts(probe_gemm_s8=1,
                                             probe_gemm_bf16=2)
    assert torch.equal(got8.cpu(), TP.gemm_plain(a8, b8))
    assert torch.equal(got, again)
    ref = TP.gemm_plain(a, b)
    if values != "edge":
        assert np.allclose(got.numpy(), (a @ b).numpy(), rtol=2e-2)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# B2's bf16 variants (ops/dg_conv.py::b2_variant): every tile width, the
# scalar gather (C % 8 != 0), column tiles past K = 256, a K that is no
# 16-byte vector (20), on 3000 live rows of a 3072-row buffer (an
# all-invalid tail)
_B2_C = (3, 5, 12, 64, 160)
_B2_K = (16, 20, 32, 96, 256, 320)


def _b2_case(dev, c, k_out, n_live, nbuf, seed, kernel="k3"):
    """bf16 features and dout on ``n_live`` rows of ``nbuf``, weights, keys
    and geometry on the card; B1's forward and reversed tables built by
    the kernel."""
    feats, inds = _sorted_input(seed, n_live, c, nbuf)
    ksize, dil = _SEARCH[kernel]
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    geom = TD.SearchGeom.of(ksize, dil, SHAPE, 1)
    kv = int(np.prod(ksize))
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((kv, c, k_out), generator=g) / np.sqrt(kv * c)
    dout = torch.randn((nbuf, k_out), generator=g)
    dout[n_live:] = 0
    keys = keys.to(dev)
    tabs = [TD.build_dg_pos(keys, reverse=r, **geom._asdict())
            for r in (False, True)]
    bf = torch.bfloat16
    return (torch.from_numpy(feats).to(dev, bf), w.to(dev, bf),
            dout.to(dev, bf), keys, geom, tabs)


def _check_b2(x, w, dout, keys, geom, tabs, n_live):
    """B2 and dgrad within 1.6e-2 * max|ref| of their plain versions (one
    bf16 rounding of an f32 sum in another order), bit-equal on repeat,
    zero past the live rows; S1 and S2 bit-equal to B1 + the table mode;
    one launch each under its own counter."""
    pos, rev = tabs
    TD.reset_launch_counts()
    out, din = TD.dg_fwd(x, w, pos), TD.dg_dgrad(dout, w, rev)
    s1 = TD.dg_fwd_search(x, w, keys, geom)
    s2 = TD.dg_dgrad_search(dout, w, keys, geom)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd=1, dg_dgrad=1,
                                       dg_fwd_search=1, dg_dgrad_search=1)
    for got, ref in ((out, TD.dg_fwd_plain(x, w, pos)),
                     (din, TD.dg_dgrad_plain(dout, w, rev))):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1.6e-2 * ref.float().abs().max().item(), err
        assert not got[n_live:].any()
    assert torch.equal(out, TD.dg_fwd(x, w, pos))
    assert torch.equal(din, TD.dg_dgrad(dout, w, rev))
    assert torch.equal(s1, out) and torch.equal(s2, din)


@pytest.mark.parametrize("k_out", _B2_K)
@pytest.mark.parametrize("c", _B2_C)
def test_b2_variants_match_plain_and_table(dev, c, k_out):
    """Every (C, K) of the grid: the forward and the input gradient (W[k]^T
    read in the kernel) against plain, and the search mode bit-equal."""
    _check_b2(*_b2_case(dev, c, k_out, 3000, 3072, 11), 3000)


@pytest.mark.parametrize("c,k_out", [(3, 16), (64, 64), (160, 256),
                                     (12, 320)])
@pytest.mark.parametrize("n", [1, 63, 65, 512])
def test_b2_small_n_matches_plain_and_table(dev, n, c, k_out):
    """Buffers of 1, 63, 65 and 512 rows (an all-invalid tail past 7/8 of
    the larger ones): partial row tiles, and the column tiles of a small
    N."""
    n_live = max(1, n - n // 8)
    _check_b2(*_b2_case(dev, c, k_out, n_live, n, 12), n_live)


@pytest.mark.parametrize("c,k_out", [(16, 16), (64, 32), (5, 32)])
def test_b2_kernel5_matches_plain_and_table(dev, c, k_out):
    """Kernel 5^3 with a dilation: 125 offsets, four staged groups."""
    _check_b2(*_b2_case(dev, c, k_out, 3000, 3072, 13, kernel="k5"), 3000)


@pytest.mark.parametrize("c,k_out", [(3, 64), (64, 64), (256, 256)])
def test_b2_benchnet_stage0_matches_plain(dev, c, k_out):
    """BenchNet's stage-0 size: the 125,562-voxel synthetic scan in its
    125,952-row buffer."""
    x0 = TB.make_bench_input(*TB.synthetic_scan(0), dtype=torch.bfloat16,
                             device=dev)
    keys, _ = TC.linearize(x0.indices, x0.spatial_shape, 1)
    geom = TD.SearchGeom.of(KSIZE, DIL, x0.spatial_shape, 1)
    tabs = [TD.build_dg_pos(keys, reverse=r, **geom._asdict())
            for r in (False, True)]
    g = torch.Generator(device=dev).manual_seed(c)
    n, live = x0.indices.shape[0], x0.valid_mask[:, None]
    x = (torch.randn((n, c), device=dev, generator=g) * live).bfloat16()
    w = (torch.randn((KV, c, k_out), device=dev, generator=g)
         / np.sqrt(KV * c)).bfloat16()
    dout = (torch.randn((n, k_out), device=dev, generator=g)
            * live).bfloat16()
    _check_b2(x, w, dout, keys, geom, tabs, int(x0.num_voxels))


@pytest.mark.parametrize("c,k_out", [(64, 96), (160, 32)])
def test_b2_misaligned_features_take_the_scalar_gather(dev, c, k_out):
    """A contiguous view whose data pointer is off 16 bytes takes the
    scalar-gather variant; it stages the same operands as the 16-byte one,
    so its results are bit-equal to those on an aligned copy."""
    x, w, dout, keys, geom, tabs = _b2_case(dev, c, k_out, 3000, 3072, 14)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xv = base[1:].view_as(x).copy_(x)
    base_d = torch.empty(dout.numel() + 1, dtype=dout.dtype, device=dev)
    dv = base_d[1:].view_as(dout).copy_(dout)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    assert not TD.b2_variant(3072, c, k_out, aligned=False).vec
    pos, rev = tabs
    assert torch.equal(TD.dg_fwd(xv, w, pos), TD.dg_fwd(x, w, pos))
    assert torch.equal(TD.dg_dgrad(dv, w, rev), TD.dg_dgrad(dout, w, rev))
    assert torch.equal(TD.dg_fwd_search(xv, w, keys, geom),
                       TD.dg_fwd(x, w, pos))
    _check_b2(xv, w, dv, keys, geom, tabs, 3000)


# ---------------------------------------------------------------------------
# B1 and B6 at the edge inputs of spconv_tpu_torch/tools/table_cases.py
# (held against the JAX package on the CPU in test_torch_table_edges.py and
# test_torch_table_pool_plan.py)
# ---------------------------------------------------------------------------

def _edge_keys(name, dev):
    from spconv_tpu_torch.tools.table_cases import table_case

    inds, shape, batch, subm, regular = table_case(name)
    inds = torch.from_numpy(inds).to(dev)
    return inds, TC.linearize(inds, shape, batch)[0], shape, batch, subm, \
        regular


_EDGE_TABLES = ("slab", "full_pool", "batch_tail", "faces", "dil2",
                "ndim1", "ndim2", "ndim4", "k5", "even")


def _windowed(rows, table, tg, sentinel):
    """B1's table through its windowed path (``b1_window_plan``) whatever
    the table's size: the public entry takes the direct path for small
    tables."""
    from spconv_tpu_torch._build import load_library

    kv = int(np.prod(tg.ksize))
    pos = torch.empty((kv, rows.shape[0]), dtype=torch.int32,
                      device=rows.device)
    plan = TD.b1_window_plan(rows.shape[0], tg.ksize, tg.stride, tg.divide,
                             sms=TD.sm_count(rows.device.index))
    assert TD.launch_b1(load_library(), rows, table, tg, sentinel, plan,
                        pos) == 0
    return pos


@pytest.mark.parametrize("name", _EDGE_TABLES)
def test_b1_edge_tables_match_plain(dev, name):
    """B1 bit-equal to its plain version in every mode at each edge input,
    through the public entry (one launch counted a table) and through the
    windowed path: the subm kernels forward and reversed, the regular
    convs' affine and divide tables, and both tables of a transposed conv
    of the same geometry on the swapped spaces."""
    from spconv_tpu_torch.ops.rulebook import build_conv_outputs

    inds, keys, shape, batch, subm, regular = _edge_keys(name, dev)
    for ksize, dil in subm:
        for rev in (False, True):
            geom = dict(ksize=ksize, dilation=dil, spatial_shape=shape,
                        batch_size=batch, reverse=rev)
            before = sum(TD.launch_counts.values())
            got = TD.build_dg_pos(keys, **geom)
            assert sum(TD.launch_counts.values()) == before + 1
            want = TD.dg_pos_plain(keys, **geom)
            assert torch.equal(got, want)
            assert torch.equal(_windowed(
                keys, keys, TD.TableGeom.subm(ksize, dil, shape, rev),
                TC.grid_sentinel(shape, batch)), want)
    for ksize, stride, padding, dil in regular:
        conv = dict(ksize=ksize, stride=stride, padding=padding,
                    dilation=dil)
        zero = (0,) * len(shape)
        _, out_keys, _, _ = build_conv_outputs(
            inds, spatial_shape=shape, batch_size=batch,
            out_bound=inds.shape[0], **conv)
        _, t_keys, _, _ = build_deconv_outputs(
            inds, spatial_shape=shape, batch_size=batch, out_padding=zero,
            **conv)
        spaces = (
            ((keys, out_keys), "strided", dict(
                conv, in_shape=shape, out_shape=tuple(TC.get_conv_output_size(
                    shape, ksize, stride, padding, dil)), batch_size=batch)),
            ((t_keys, keys), "transposed", dict(
                conv, in_shape=tuple(TC.get_deconv_output_size(
                    shape, ksize, stride, padding, dil, zero)),
                out_shape=shape, batch_size=batch)))
        for (ins, outs), path, geom in spaces:
            for divide, build, plain in (
                    (False, TD.build_dg_pos_affine, TD.dg_pos_affine_plain),
                    (True, TD.build_dg_pos_divide, TD.dg_pos_divide_plain)):
                want = plain(ins, outs, **geom)
                got = build(ins, outs, path=path, **geom)
                assert torch.equal(got, want), (build.__name__, path, conv)
                tg = TD.TableGeom.regular(divide, **{
                    k: v for k, v in geom.items() if k != "batch_size"})
                rows, table = (ins, outs) if divide else (outs, ins)
                assert torch.equal(_windowed(
                    rows, table, tg, TC.grid_sentinel(tg.row_dims, batch)),
                    want), ("windowed", build.__name__, path, conv)


_EDGE_POOLS = ("c12_batch_tail", "c6", "ndim1", "ndim2", "ndim4", "slab",
               "full_pool")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", _EDGE_POOLS)
def test_b6_edge_pools_match_plain(dev, name, dtype):
    """B6 at each pool edge input, with a NaN, a +inf and a -inf feature,
    on the features and on a view 2 bytes off 16-byte alignment (the
    scalar path): max bit-equal, mean within 1e-6*max|ref| where finite and
    NaN / inf where plain has them."""
    from spconv_tpu_torch.ops import sorted_pool as TS
    from spconv_tpu_torch.ops.rulebook import build_pool2_outputs
    from spconv_tpu_torch.tools.table_cases import pool_case

    feats, inds, shape, batch = pool_case(name)
    inds = torch.from_numpy(inds).to(dev)
    in_keys, _ = TC.linearize(inds, shape, batch)
    _, out_keys, _, _ = build_pool2_outputs(
        inds, spatial_shape=shape, batch_size=batch, out_bound=inds.shape[0])
    geom = dict(in_shape=shape, out_shape=tuple(s // 2 for s in shape),
                batch_size=batch)
    x = torch.from_numpy(feats).to(dev)
    rows = torch.nonzero(inds[:, 0] >= 0).squeeze(1)
    x[rows[3], 0], x[rows[10], -1], x[rows[20], 0] = (
        float("nan"), float("inf"), float("-inf"))
    x = x.to(dtype)
    view = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
    view = view.view_as(x).copy_(x)
    for feat in (x, view):
        for mode in ("max", "mean"):
            got = TS.sk_pool2(feat, in_keys, out_keys, mode=mode, **geom)
            ref = TS.sk_pool2_plain(feat, in_keys, out_keys, mode=mode,
                                    **geom)
            assert torch.equal(got.isnan(), ref.isnan())
            if mode == "max":
                assert torch.equal(got.nan_to_num(), ref.nan_to_num())
                continue
            fin = torch.isfinite(ref)
            assert torch.equal(got[~fin].nan_to_num(), ref[~fin].nan_to_num())
            err = (got[fin].float() - ref[fin].float()).abs().max().item()
            assert err <= 1e-6 * ref[fin].float().abs().max().item()


def test_b1_sampled_windows_counted_on_the_slab(dev):
    """The counting build of ``dg_pos.cu`` (``tools/table_count.py``)
    counts the windows B1 samples (did not fit in its pool whole) on the
    dense slab: above 0, equal to the host count (``b1_fallbacks``), with
    the table bit-equal to plain, forward and reversed."""
    _check_fallbacks(dev, "slab", "table_count_test")


def _check_fallbacks(dev, name, build_dir):
    """The counting build's count of B1's windows searched in global memory
    at table edge input ``name``, forward and reversed: above 0 and equal
    to the host count (``tools/table_count.py``'s ``b1_fallbacks``), the
    table bit-equal to plain.  Returns the host's count of the windows
    left without a sample."""
    from spconv_tpu_torch._build import BUILD_DIR
    from spconv_tpu_torch.tools import ablation as AB
    from spconv_tpu_torch.tools import table_count as TCN

    count_lib = AB.build("dg_pos.cu", (TCN.COUNT,), TCN.COUNT_ARGTYPES,
                         BUILD_DIR / build_dir)[TCN.COUNT[0]]
    _, keys, shape, batch, subm, _ = _edge_keys(name, dev)
    (ksize, dil), sent = subm[0], TC.grid_sentinel(shape, batch)
    unsampled = 0
    for rev in (False, True):
        tg = TD.TableGeom.subm(ksize, dil, shape, rev)
        plan = TD.b1_plan(keys.shape[0], ksize, sms=TD.sm_count(dev.index))
        card, pos = TCN.fallen_back(count_lib, keys, keys, tg, sent, plan)
        host, none = TCN.b1_fallbacks(TCN.b1_windows(keys, keys, tg, sent,
                                                     plan),
                                      plan, keys.shape[0])
        assert card == host > 0
        unsampled += none
        assert torch.equal(pos, TD.dg_pos_plain(
            keys, ksize=ksize, dilation=dil, spatial_shape=shape,
            batch_size=batch, reverse=rev))
    return unsampled


def test_b1_full_pool_windows_searched_without_sample(dev):
    """At the "full_pool" input a block's first fitting window fills B1's
    pool exactly and the windows after it get no sample: the counting
    build counts them, as the host does, and the table stays bit-equal to
    plain (its affine, divide and transposed tables, and B6's pool at the
    pool input of the same name, are held in the edge tests above)."""
    assert _check_fallbacks(dev, "full_pool", "table_count_full_test") > 0


def test_b1_divide_table_in_passes(dev):
    """A 5^3 stride-2 divide table over enough rows for 128-row tiles
    stages its results in shared memory a few offset groups a pass (three
    passes of b1_plan's): bit-equal to plain, and its affine inverse
    too."""
    from spconv_tpu_torch.ops.rulebook import build_conv_outputs

    shape, ksize = (40, 60, 60), (5, 5, 5)
    conv = dict(ksize=ksize, stride=(2, 2, 2), padding=(2, 2, 2),
                dilation=(1, 1, 1))
    _, inds = generate_sparse_data(shape, 40000, 1,
                                   rng=np.random.RandomState(3))
    key = inds[:, 1].astype(np.int64)
    for a in range(1, 3):
        key = key * shape[a] + inds[:, a + 1]
    inds = torch.from_numpy(inds[np.argsort(key)]).to(dev)
    keys, _ = TC.linearize(inds, shape, 1)
    _, out_keys, _, _ = build_conv_outputs(
        inds, spatial_shape=shape, batch_size=1, out_bound=inds.shape[0],
        **conv)
    geom = dict(conv, in_shape=shape, out_shape=tuple(
        TC.get_conv_output_size(shape, ksize, (2, 2, 2), (2, 2, 2),
                                (1, 1, 1))), batch_size=1)
    plan = TD.b1_plan(keys.shape[0], ksize, (2, 2, 2), True,
                      sms=TD.sm_count(dev.index))
    assert plan.tile == 128 and plan.passes == 3
    assert torch.equal(TD.build_dg_pos_divide(keys, out_keys, **geom),
                       TD.dg_pos_divide_plain(keys, out_keys, **geom))
    assert torch.equal(TD.build_dg_pos_affine(keys, out_keys, **geom),
                       TD.dg_pos_affine_plain(keys, out_keys, **geom))


def _mnist_qat_net(observe=2):
    """The MNIST QAT example's net on the CPU, prepared and observed on
    ``observe`` batches, and a batch it has not seen."""
    import copy

    from spconv_tpu_torch.examples import mnist_qat, mnist_sparse
    from spconv_tpu_torch.quantization import prepare_qat, qat_observe

    rng = np.random.RandomState(0)
    qnet = prepare_qat(mnist_qat.build_net(device="cpu")[0])
    for _ in range(observe):
        qat_observe(qnet, mnist_sparse.make_batch(rng, device="cpu")[0])
    return copy.deepcopy(qnet), mnist_sparse.make_batch(rng, device="cpu")


def _to(x, dev):
    return st.SparseConvTensor(x.features.to(dev), x.indices.to(dev),
                               x.spatial_shape, x.batch_size,
                               keys_sorted=x.keys_sorted)


def test_qat_step_on_card_matches_cpu(dev):
    """One MNIST QAT step (``examples.mnist_qat.qat_step``: an observe pass,
    then Adam on the fake-quantized net) on the card against the same step
    on the CPU from the same state: the launch counts of an observe pass
    and a step; the loss, the stub's and every module's scales and BN
    statistics within 1e-5 relative; the grads within 1e-3 of max|ref| per
    tensor (a fake-quantized activation next to a rounding boundary may
    round one step apart when the conv sums in another order)."""
    import copy

    from spconv_tpu_torch.examples import mnist_qat
    from spconv_tpu_torch.modules import SparseGlobalAvgPool
    from spconv_tpu_torch.quantization import qat_observe

    qnet, (x, y) = _mnist_qat_net()
    head = mnist_qat.build_net(device="cpu")[2]
    nets, heads, losses = {}, {}, {}
    for where in ("cpu", "cuda"):
        d = torch.device("cpu") if where == "cpu" else dev
        nets[where] = copy.deepcopy(qnet).to(d)
        heads[where] = tuple(t.detach().clone().to(d).requires_grad_()
                             for t in head)
        opt = torch.optim.Adam(list(nets[where].parameters())
                               + list(heads[where]), lr=mnist_qat.QAT_LR)
        xd, yd = _to(x, d), y.to(d)
        if where == "cuda":
            before = dict(TD.launch_counts)
            qat_observe(copy.deepcopy(nets[where]), xd)
            torch.cuda.synchronize()
            got = {k: TD.launch_counts[k] - before[k] for k in before}
            assert got == _counts(dg_pos=1, dg_fwd=2, dg_pos_affine=2,
                                  dg_fwd_strided=2)
            before = dict(TD.launch_counts)
        losses[where] = float(mnist_qat.qat_step(
            nets[where], SparseGlobalAvgPool(), heads[where], opt, xd, yd))
        if where == "cuda":
            torch.cuda.synchronize()
            got = {k: TD.launch_counts[k] - before[k] for k in before}
            assert got == _counts(
                dg_pos=2, dg_pos_rev=1, dg_fwd=3, dg_wgrad=1,
                dg_pos_affine=3, dg_pos_divide=1, dg_fwd_strided=3,
                dg_dgrad_strided=1, dg_wgrad_strided=1)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * losses["cpu"]
    ref_sd = nets["cpu"].state_dict()
    for k, v in nets["cuda"].state_dict().items():
        if "scale" in k or "running" in k:
            np.testing.assert_allclose(v.cpu().numpy(), ref_sd[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    for (name, p), (_, q) in zip(nets["cuda"].named_parameters(),
                                 nets["cpu"].named_parameters()):
        ref = q.grad.numpy()
        np.testing.assert_allclose(p.grad.cpu().numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)


def test_int8_mnist_net_bit_equal_to_plain(dev):
    """The converted MNIST QAT net (``convert_qat``: an int8 subm conv with
    one input channel, then a strided one) on the card: one subm and one
    affine table and one B7 launch each, no B2, and the output bit-equal to
    the same net's plain run on the CPU."""
    import copy

    from spconv_tpu_torch.quantization import convert_qat

    qnet, (x, _) = _mnist_qat_net()
    net8 = convert_qat(qnet)
    want = net8(x).features
    net8 = copy.deepcopy(net8).to(dev)
    before = dict(TD.launch_counts)
    with torch.inference_mode():
        got = net8(_to(x, dev))
    torch.cuda.synchronize()
    assert {k: TD.launch_counts[k] - before[k] for k in before} == _counts(
        dg_pos=1, dg_pos_affine=1, dg_fwd_q=1, dg_fwd_q_strided=1)
    assert got.q_scale is None and torch.equal(got.features.cpu(), want)
    assert want.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_updated_on_card_matches_cpu(dev, dtype):
    """Three ``BatchNorm1d.updated`` calls on the card (features in
    ``dtype``, padding rows) advance the running statistics as on the
    CPU, within 1e-6 relative."""
    bns = {d: st.BatchNorm1d(5, momentum=0.3, device=d)
           for d in ("cpu", "cuda")}
    for seed in range(3):
        fb, ib = _sorted_input(seed, 300, 5, 384)
        x = st.SparseConvTensor(torch.from_numpy(fb * (seed + 1) + seed)
                                .to(dtype), torch.from_numpy(ib), SHAPE, 1,
                                keys_sorted=True)
        x = x.replace_feature_masked(x.features)
        for d, bn in bns.items():
            assert bn.updated(_to(x, torch.device(d))) is bn
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(
            getattr(bns["cuda"], name).cpu().numpy(),
            getattr(bns["cpu"], name).numpy(), rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the native rulebook path: the same kernels on a rulebook's pair tables
# ---------------------------------------------------------------------------

def _shuffled_input(seed, n, c, nbuf, shape=SHAPE, batch=1):
    """Seeded features and coordinates in a random row order (inactive
    rows among them): the rulebook's tables then index rows in no key
    order."""
    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(shape, n, c, batch_size=batch,
                                       rng=rng)
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, len(shape) + 1), -1, np.int32)
    fb[:len(inds)] = feats
    ib[:len(inds)] = inds
    perm = rng.permutation(nbuf)
    return torch.from_numpy(fb[perm]), torch.from_numpy(ib[perm])


def _rulebooks(inds, dev):
    """A subm, a strided and a transposed rulebook of ``inds`` built on
    ``dev``."""
    from spconv_tpu_torch.ops import rulebook as TR

    inds = inds.to(dev)
    geo = dict(spatial_shape=SHAPE, batch_size=1)
    return {
        "subm": TR.build_subm_rulebook(inds, ksize=KSIZE, dilation=DIL,
                                       **geo),
        "strided": TR.build_conv_rulebook(
            inds, ksize=KSIZE, stride=(2, 2, 2), padding=(1, 1, 1),
            dilation=DIL, **geo),
        "transposed": TR.build_conv_rulebook(
            inds, ksize=(2, 2, 2), stride=(2, 2, 2), padding=(0, 0, 0),
            dilation=DIL, transposed=True, out_bound=8 * inds.shape[0],
            **geo),
    }


@pytest.mark.parametrize("kind", ["subm", "strided", "transposed"])
def test_rulebooks_on_card_equal_cpu(dev, kind):
    """The rulebook builders (torch ops) on the card equal their CPU run,
    integer for integer, on rows in no key order."""
    _, inds = _shuffled_input(20, 3000, 4, 3072)
    got, want = _rulebooks(inds, dev)[kind], _rulebooks(inds, "cpu")[kind]
    for f in ("pair_fwd", "pair_bwd", "out_indices", "num_out",
              "num_out_total"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_pool2_and_int64_rulebooks_on_card_equal_cpu(dev):
    """The 2x pool rulebook, and a subm rulebook on a grid of int64 keys
    ([160, 2048, 2048] at batch 4), on the card equal their CPU run."""
    from spconv_tpu_torch.ops import rulebook as TR

    _, inds = _shuffled_input(21, 3000, 4, 3072)
    geo = dict(spatial_shape=SHAPE, batch_size=1)
    got = TR.build_pool2_rulebook(inds.to(dev), **geo)
    want = TR.build_pool2_rulebook(inds, **geo)
    big = (160, 2048, 2048)
    rng = np.random.RandomState(22)
    pts = np.concatenate([rng.randint(0, 4, (2000, 1)),
                          rng.randint(0, 6, (2000, 3)) + [80, 1020, 1020]],
                         axis=1)
    pts = torch.from_numpy(np.unique(pts, axis=0).astype(np.int32))
    kw = dict(spatial_shape=big, batch_size=4, ksize=KSIZE, dilation=DIL)
    got64 = TR.build_subm_rulebook(pts.to(dev), **kw)
    want64 = TR.build_subm_rulebook(pts, **kw)
    for a, b in ((got, want), (got64, want64)):
        for f in ("pair_fwd", "pair_bwd", "out_indices", "num_out"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("kind", ["subm", "strided", "transposed"])
def test_native_gather_gemm_kernels_match_plain(dev, dtype, tol, kind):
    """B2 forward and dgrad and the wgrad kernel on a rulebook's tables
    whose rows are in no key order (``path="native"``), against their
    plain versions: forward and dgrad within the file's B2 tolerances,
    wgrad within WGRAD_TOL (bf16) of max|ref|, over ``pair_bwd`` and over
    ``pair_fwd`` (``wgrad_gather_mm`` without the mirror); each launch
    counted under its ``*_native`` name."""
    from spconv_tpu_torch.ops import gather_gemm as TG

    c, k_out = 32, 48
    feats, inds = _shuffled_input(23, 3000, c, 3072)
    rec = _rulebooks(inds, dev)[kind]
    kv = rec.pair_fwd.shape[0]
    g = torch.Generator().manual_seed(24)
    w = (torch.randn((kv, c, k_out), generator=g) / np.sqrt(kv * c)).to(
        dev, dtype)
    x = feats.to(dev, dtype)
    dout = torch.randn((rec.pair_fwd.shape[1], k_out), generator=g)
    dout = (dout * (rec.out_indices[:, :1].cpu() >= 0)).to(dev, dtype)
    TD.reset_launch_counts()
    cases = (
        (TD.dg_fwd(x, w, rec.pair_fwd, path="native"),
         TD.dg_fwd_plain(x, w, rec.pair_fwd), tol),
        (TD.dg_dgrad(dout, w, rec.pair_bwd, path="native"),
         TD.dg_dgrad_plain(dout, w, rec.pair_bwd), tol),
        (TG.wgrad_gather_mm(x, dout, rec.pair_fwd, None,
                            pair_bwd=rec.pair_bwd),
         TD.dg_wgrad_plain(x, dout, rec.pair_bwd),
         max(tol, WGRAD_TOL if dtype == torch.bfloat16 else 1e-4)),
        (TG.wgrad_gather_mm(x, dout, rec.pair_fwd, None),
         TD.dg_wgrad_plain(x, dout, rec.pair_bwd),
         max(tol, WGRAD_TOL if dtype == torch.bfloat16 else 1e-4)),
    )
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_native=1, dg_dgrad_native=1,
                                       dg_wgrad_native=2)
    for got, ref, t in cases:
        ref = ref.float()
        err = (got.float() - ref).abs().max().item()
        assert err <= t * ref.abs().max().item(), err


def test_native_b7_on_transposed_rulebook_bit_equal(dev):
    """B7 (``dg_fwd_q``, ``path="native"``) on a transposed rulebook's
    ``pair_fwd``, with bias, ReLU and the residual, bit-equal to its plain
    version, and one ``dg_fwd_q_native`` launch."""
    c, k_out = 32, 16
    _, inds = _shuffled_input(25, 3000, c, 3072)
    rec = _rulebooks(inds, dev)["transposed"]
    rng = np.random.RandomState(26)
    x = torch.from_numpy(rng.randint(-127, 128, (3072, c)).astype(
        np.int8)).to(dev)
    w = torch.from_numpy(rng.randint(-127, 128, (8, c, k_out)).astype(
        np.int8)).to(dev)
    scale = torch.from_numpy((rng.rand(k_out) / 3000).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.randn(k_out).astype(np.float32)).to(dev)
    n = rec.pair_fwd.shape[1]
    add = torch.from_numpy(rng.randint(-127, 128, (n, k_out)).astype(
        np.int8)).to(dev)
    kw = dict(act="relu", add=add, add_scale=0.5)
    TD.reset_launch_counts()
    got = TD.dg_fwd_q(x, w, rec.pair_fwd, scale, bias, path="native", **kw)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_fwd_q_native=1)
    want = TD.dg_fwd_q_plain(x, w, rec.pair_fwd, scale, bias, **kw)
    assert torch.equal(got, want)


def test_native_conv_step_on_card_matches_cpu(dev):
    """A native subm + strided + inverse chain on unsorted input: forward
    and a backward on the card against the same chain on the CPU (plain
    versions), f32; the launches are the native route's only.  A native
    subm forward runs under ``torch.cuda.set_sync_debug_mode("error")``:
    the rulebook reads nothing back to the host."""
    feats, inds = _shuffled_input(27, 3000, 8, 3072)

    def chain(device):
        g = torch.Generator().manual_seed(28)
        return st.SparseSequential(
            st.SubMConv3d(8, 16, 3, indice_key="s", algo="native",
                          device=device, generator=g),
            st.SparseConv3d(16, 16, 3, stride=2, padding=1, indice_key="d",
                            algo="native", device=device, generator=g),
            st.SparseInverseConv3d(16, 8, 3, indice_key="d", algo="native",
                                   device=device, generator=g))

    outs = {}
    for device in ("cpu", dev):
        net = chain(device)
        x = st.SparseConvTensor(feats.to(device).clone().requires_grad_(),
                                inds.to(device), SHAPE, 1)
        TD.reset_launch_counts()
        y = net(x)
        (y.features ** 2).sum().backward()
        if device == dev:
            torch.cuda.synchronize()
            assert TD.launch_counts == _counts(
                dg_fwd_native=3, dg_dgrad_native=3, dg_wgrad_native=3)
        outs[str(device)] = [y.features.detach().cpu(), x.features.grad.cpu()
                             ] + [p.grad.cpu() for p in net.parameters()]
    for got, ref in zip(outs[str(dev)], outs["cpu"]):
        err = (got - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), err
    conv = st.SubMConv3d(8, 16, 3, indice_key="s", algo="native",
                         device=dev)
    x = st.SparseConvTensor(feats.to(dev), inds.to(dev), SHAPE, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            conv(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _voxelize_both(dev, pc, **kw):
    """``point_to_voxel`` of ``pc`` on the card and on the CPU."""
    from spconv_tpu_torch.ops.point2voxel import point_to_voxel

    got = point_to_voxel(pc.to(dev), **kw)
    torch.cuda.synchronize()
    return [t.cpu() for t in got], point_to_voxel(pc, **kw)


def test_point_to_voxel_on_card_equals_cpu(dev):
    """The voxelizer on the card bit-equal to the CPU in all five outputs:
    a CenterPoint-style cloud at 0.1 m (~45,000 points, 5 % outside the
    range, one point a voxel) and a dense random cloud with NaN and +-inf
    points, five points a voxel, empty means and a voxel cap below the
    voxel count.  On a card tensor it reads nothing back to the host
    (``set_sync_debug_mode("error")``)."""
    pts = torch.from_numpy(TCP.synthetic_centerpoint_points(
        0, shape=(40, 256, 256), n_target=20000))
    kw = dict(vsize_xyz=TCP.CP_VSIZE, coors_range_xyz=TCP.CP_RANGE,
              max_num_voxels=30000, max_num_points_per_voxel=1)
    got, want = _voxelize_both(dev, pts, **kw)
    assert int(want[4]) == 20000
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rng = np.random.RandomState(3)
    pc = rng.uniform(-2, 4, (60000, 5)).astype(np.float32)
    pc[:50, 0], pc[50:80, 1], pc[80:90, 2] = np.nan, np.inf, -np.inf
    kw = dict(vsize_xyz=(0.1, 0.1, 0.2), coors_range_xyz=(-1, -1, -1, 3, 3,
                                                           3),
              max_num_voxels=8000, max_num_points_per_voxel=5,
              empty_mean=True)
    got, want = _voxelize_both(dev, torch.from_numpy(pc), **kw)
    assert int(want[4]) == 8000 and int(want[2].max()) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    from spconv_tpu_torch.ops.point2voxel import point_to_voxel
    pc_dev = torch.from_numpy(pc).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        point_to_voxel(pc_dev, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _cp_scan(dev, shift=0):
    """A 20,000-voxel CenterPoint-style scan on the card, f32, its x
    coordinates shifted by ``shift`` (rows pushed off the grid become
    invalid)."""
    x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 256, 256),
                                           n_target=20000, device=dev)
    if shift:
        inds = x.indices.clone()
        inds[:, 3] += shift
        off = (x.indices[:, 0] < 0) | (inds[:, 3] >= 256)
        inds[off] = -1
        feats = torch.where(off[:, None], 0.0, x.features + 1.0)
        x = st.SparseConvTensor(feats, inds, x.spatial_shape, 1)
    return x


def _to_cpu(x):
    return st.SparseConvTensor(x.features.cpu(), x.indices.cpu(),
                               x.spatial_shape, x.batch_size,
                               keys_sorted=x.keys_sorted)


def test_sparse_add_and_remove_duplicate_on_card_equal_cpu(dev):
    """``sparse_add`` of a scan and its shifted copy (two rows a site at
    most, so the sums are exact in any order) and ``RemoveDuplicate`` of
    the scan with 10 % of its rows repeated (features changed), rows
    shuffled: bit-equal to the CPU; the deduplicated scan feeds a subm
    conv on B1 + B2."""
    a, b = _cp_scan(dev), _cp_scan(dev, shift=1)
    got = st.sparse_add(a, b)
    want = st.sparse_add(_to_cpu(a), _to_cpu(b))
    for f in ("features", "indices", "num_voxels"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert int(want.num_voxels) > 20000
    g = torch.Generator().manual_seed(0)
    dup = torch.randperm(20000, generator=g)[:2000]
    feats = torch.cat([a.features, a.features[dup.to(dev)] * 2 + 1])
    inds = torch.cat([a.indices, a.indices[dup.to(dev)]])
    perm = torch.randperm(feats.shape[0], generator=g).to(dev)
    x = st.SparseConvTensor(feats[perm], inds[perm], a.spatial_shape, 1)
    got = st.RemoveDuplicate()(x)
    want = st.RemoveDuplicate()(_to_cpu(x))
    for f in ("features", "indices", "num_voxels"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert int(got.num_voxels) == 20000 and got.keys_sorted
    conv = st.SubMConv3d(5, 16, 3, indice_key="r", device=dev)
    TD.reset_launch_counts()
    with torch.no_grad():
        y = conv(got)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(dg_pos=1, dg_fwd=1)
    assert torch.isfinite(y.features).all()


# rotated IoU, card against CPU, of max|ref| (see the test below)
BOX_CARD_TOL = 1e-4


def test_hash_table_and_rotate_nms_on_card_equal_cpu(dev):
    """A ``HashTable`` insert / query of a scan's keys (and absent ones)
    and ``rotate_nms`` of 500 seeded boxes: the card's results equal the
    CPU's, the keep mask bit for bit.  The IoU within BOX_CARD_TOL: the
    card's sin / cos may differ from the CPU's in the last bits, and f32
    corners up to 45 m from the origin carry ulps of 3.8e-6 m, which an
    intersection of nearly parallel edges magnifies."""
    from spconv_tpu_torch.utils import boxops as TBX

    x = _cp_scan(dev)
    keys, _ = TC.linearize(x.indices, x.spatial_shape, 1)
    keys = keys[:20000]
    vals = torch.arange(20000, dtype=torch.int32, device=dev)
    q = torch.cat([keys[::3], keys[::7] + 1])
    outs = []
    for device in (dev, "cpu"):
        t = st.HashTable(32768, device=device).insert(keys.to(device),
                                                      vals.to(device))
        t, cnt = t.assign_arange_()
        outs.append([v.cpu() for v in (*t.query(q.to(device)), *t.items(),
                                       cnt)])
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(0, 40, (500, 2)),
                            rng.uniform(1, 5, (500, 2)),
                            rng.uniform(-np.pi, np.pi, (500, 1))], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    scores = torch.from_numpy(rng.rand(500).astype(np.float32))
    keep = TBX.rotate_nms(boxes.to(dev), scores.to(dev), 0.2)
    want = TBX.rotate_nms(boxes, scores, 0.2)
    assert torch.equal(keep.cpu(), want) and 0 < int(want.sum()) < 500
    iou = TBX.rbbox_iou(boxes.to(dev), boxes.to(dev)).cpu()
    ref = TBX.rbbox_iou(boxes, boxes)
    assert (iou - ref).abs().max() <= BOX_CARD_TOL * ref.abs().max()


# ---------------------------------------------------------------------------
# the tuner's B2 tile, the timers, data parallelism on the card
# ---------------------------------------------------------------------------

def _b2_tiles_launched(fn, reps=3):
    """The B2 bf16 tile of each device launch of ``reps`` calls of
    ``fn``, from a profiler window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tiles = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        m = re.search(
            r"dg_fwd_bf16_kernel<[^<]*Tile<(\d+), (\d+), \d+, \d+, (\d+)>",
            e.name)
        if m:
            tiles.append(tuple(int(v) for v in m.groups()))
    return tiles


def _check_tile(x, w, pos, tile, path):
    """B2 forced onto ``tile`` against plain (1.6e-2 of max|ref|), one
    launch, bit-equal on repeat."""
    ref = TD.dg_fwd_plain(x, w, pos).float()
    TD.reset_launch_counts()
    got = TD.dg_fwd(x, w, pos, path, tile=tile)
    torch.cuda.synchronize()
    assert TD.launch_counts == _counts(
        **{"dg_fwd" if path == "subm" else f"dg_fwd_{path}": 1})
    err = (got.float() - ref).abs().max().item()
    assert err <= 1.6e-2 * ref.abs().max().item(), err
    assert torch.equal(got, TD.dg_fwd(x, w, pos, path, tile=tile))


def _tile_case(c, dev):
    """bf16 features of 3,000 sorted sites in 3,072 rows at width ``c``, a
    ``[27, c, 96]`` weight, B1's table and a native subm rulebook's
    ``pair_fwd`` of the same sites."""
    from spconv_tpu_torch.ops import rulebook as TR

    feats, inds = _sorted_input(40 + c, 3000, c, 3072)
    _, pos = _plain_pos(inds)
    g = torch.Generator().manual_seed(41)
    w = (torch.randn((KV, c, 96), generator=g) / np.sqrt(KV * c)).to(
        dev, torch.bfloat16)
    pair = TR.build_subm_rulebook(torch.from_numpy(inds).to(dev),
                                  spatial_shape=SHAPE, batch_size=1,
                                  ksize=KSIZE, dilation=DIL).pair_fwd
    return (torch.from_numpy(feats).to(dev, torch.bfloat16), w,
            pos.to(dev), pair)


@pytest.mark.parametrize("c", [3, 16, 160])
@pytest.mark.parametrize("tile", range(5))
def test_b2_forced_tile_matches_plain(dev, tile, c):
    """Each of B2's five bf16 tiles forced through ``dg_fwd(tile=)`` at
    C = 3 (the scalar gather), 16 (packed steps) and 160 (channel steps),
    K = 96 (column tiles past 16-64-wide tiles, part of one 128- or
    256-wide tile), on a B1 table and on a native rulebook's ``pair_fwd``
    (the tuner's path), and ``gather_mm(tile=)`` equal to it."""
    from spconv_tpu_torch.ops import gather_gemm as TG

    x, w, pos, pair = _tile_case(c, dev)
    _check_tile(x, w, pos, tile, "subm")
    _check_tile(x, w, pair, tile, "native")
    assert torch.equal(TG.gather_mm(x, w, pair, None, tile=tile),
                       TD.dg_fwd(x, w, pair, "native", tile=tile))


def _stage0_native():
    """Phase 16's tile-tuning shape: BenchNet's stage 0 (seed 0, 125,562
    voxels), 64 bf16 features, a [27, 64, 64] weight and the native subm
    rulebook's ``pair_fwd``, and the scan's tensor."""
    from spconv_tpu_torch.ops import rulebook as TR

    x = TB.make_bench_input(*TB.synthetic_scan(0), device="cuda")
    pair = TR.build_subm_rulebook(x.indices, spatial_shape=x.spatial_shape,
                                  batch_size=1, ksize=KSIZE,
                                  dilation=DIL).pair_fwd
    g = torch.Generator(device="cuda").manual_seed(16)
    f = (torch.randn((x.indices.shape[0], 64), device="cuda", generator=g)
         * x.valid_mask[:, None]).bfloat16()
    w = (torch.randn((KV, 64, 64), device="cuda", generator=g)
         / np.sqrt(KV * 64)).bfloat16()
    return f, w, pair, x


@pytest.fixture(scope="module")
def stage0_native():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return _stage0_native()


@pytest.mark.parametrize("tile", range(5))
def test_b2_forced_tile_at_stage0(dev, stage0_native, tile):
    """Each tile at phase 16's shape against plain."""
    _check_tile(*stage0_native[:3], tile, "native")


def test_tuned_tile_serves_native_conv(dev, stage0_native, tmp_path,
                                       monkeypatch):
    """``tune_conv_tile`` at phase 16's shape caches a winner with every
    tile's ms; a native conv's forward with it cached equals the conv
    forced onto that tile."""
    from spconv_tpu_torch import tuner as TU
    from spconv_tpu_torch.ops import gather_gemm as TG

    f, w, pair, x = stage0_native
    won = TU.ConvTuner(cache_dir=str(tmp_path)).tune_conv_tile(f, w, pair,
                                                               None)
    assert set(won["candidates"]) == {f"tile={i}" for i in range(5)}
    assert all(np.isfinite(v) and v > 0 for v in won["candidates"].values())
    monkeypatch.setattr(TU, "CONV_TUNER", TU.ConvTuner(cache_dir=str(
        tmp_path)))
    conv = st.SubMConv3d(64, 64, 3, bias=False, algo="native",
                         dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        got = conv(x.replace_feature(f)).features
    wkv = TD.weight_krsc_to_kv(conv.weight.detach())
    assert torch.equal(got, TG.gather_mm(f, wkv, pair, None,
                                         tile=won["tile"]))


def _profiled_tiles():
    """The profiler's part of :func:`test_b2_tiles_launched_as_forced`,
    run in a fresh interpreter: B2 on each tile forced (B1 table and
    native rulebook, C = 3, 16, 160), and a native conv with a tuned tile
    cached at phase 16's shape, each window's B2 launches on that tile."""
    import tempfile

    from spconv_tpu_torch import tuner as TU
    from spconv_tpu_torch.ops import gather_gemm as TG

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for c in (3, 16, 160):
        x, w, pos, pair = _tile_case(c, dev)
        for tile in range(5):
            for what, fn in (
                    ("table", lambda: TD.dg_fwd(x, w, pos, tile=tile)),
                    ("native", lambda: TG.gather_mm(x, w, pair, None,
                                                    tile=tile))):
                tiles = _b2_tiles_launched(fn)
                assert tiles and set(tiles) == {TD.B2_TILES[tile]}, (
                    c, tile, what, tiles)
    f, w, pair, x = _stage0_native()
    with tempfile.TemporaryDirectory() as tmp:
        won = TU.ConvTuner(cache_dir=tmp).tune_conv_tile(f, w, pair, None)
        TU.CONV_TUNER = TU.ConvTuner(cache_dir=tmp)
        conv = st.SubMConv3d(64, 64, 3, bias=False, algo="native",
                             dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            tiles = _b2_tiles_launched(lambda: conv(x.replace_feature(f)))
    assert tiles and set(tiles) == {TD.B2_TILES[won["tile"]]}, tiles
    print(f"tuned tile {won['tile']} launched; every forced tile launched")


def test_b2_tiles_launched_as_forced(dev):
    """The profiler sees B2 launched on each forced tile and, through a
    native conv, on the tuned one (:func:`_profiled_tiles`), in a fresh
    interpreter: in a long test process the profiler has recorded none of
    the device ops of short windows."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent), str(here)]))
    out = subprocess.run(
        [sys.executable, "-c",
         "import test_torch_cuda as T; T._profiled_tiles()"],
        cwd=here, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "every forced tile launched" in out.stdout


def test_kernel_timer_and_benchmark_model_on_card(dev):
    """``KernelTimer`` spans are CUDA events read after one sync: nested
    keys, an outer span no shorter than its inner one, a span on another
    stream; ``benchmark_model`` gives the ms of one call on CUDA events,
    within 25 % of the same calls timed by hand."""
    from spconv_tpu_torch.tools import KernelTimer, benchmark_model

    a = torch.randn(2048, 2048, device=dev)
    timer = KernelTimer()
    with timer.namespace("outer"):
        with timer.namespace("mm"):
            for _ in range(4):
                a @ a
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            with timer.record("side", stream=side):
                a @ a
    spans = timer.get_all_pair_time()
    assert sorted(spans) == ["outer", "outer.mm", "outer.side"]
    assert all(v > 0 for v in spans.values())
    assert spans["outer"] >= spans["outer.mm"]
    assert timer.get_all_pair_time() == spans
    ms = benchmark_model(lambda t: t @ t, (a,), rep=10, n_outer=3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        a @ a
    end.record()
    end.synchronize()
    by_hand = start.elapsed_time(end) / 10
    assert isinstance(ms, float) and 0.75 * by_hand <= ms <= 1.25 * by_hand


def _sync_bn_rank(rank, world, device, feats, inds):
    """One data-parallel step of SubM -> SyncBN -> ReLU on ``device`` (the
    conv without a bias, as before a BN: its gradient would be 0 up to
    rounding)."""
    from spconv_tpu_torch import parallel as P

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = P.make_mesh(world)
    g = torch.Generator().manual_seed(3)
    net = st.SparseSequential(
        st.SubMConv3d(4, 8, 3, bias=False, indice_key="s", device=device,
                      generator=g),
        st.SparseSyncBatchNorm(8, device=device), st.SparseReLU()).train()

    def loss_fn(n, f, i):
        return (n(st.SparseConvTensor(f, i, SHAPE, 1, keys_sorted=True))
                .features ** 2).sum()

    loss, grads = P.data_parallel_value_and_grad(loss_fn, mesh)(
        net, torch.from_numpy(feats).to(device),
        torch.from_numpy(inds).to(device))
    return {"loss": loss.item(), "grads": {k: v.cpu()
                                           for k, v in grads.items()},
            "launches": dict(TD.launch_counts)}


def test_sync_bn_two_ranks_on_card_matches_cpu(dev, tmp_path):
    """A 2-rank ``gloo`` data-parallel step with SyncBN on the one card
    (B1 and B2 on each rank's scan, the statistics all-reduced through
    host memory) against the same step on the CPU: loss and grads within
    1e-4 of max per tensor; each card rank launched its kernels."""
    from spconv_tpu_torch.parallel import run_ranks

    scans = [_sorted_input(50 + r, 300, 4, 384) for r in range(2)]
    feats = np.stack([f for f, _ in scans])
    inds = np.stack([i for _, i in scans])
    res = {d: run_ranks(_sync_bn_rank, 2, (d, feats, inds), backend="gloo",
                        timeout=300, workdir=str(tmp_path))
           for d in ("cuda", "cpu")}
    for r in range(2):
        card, cpu = res["cuda"][r], res["cpu"][r]
        assert card["launches"]["dg_fwd"] == 1
        assert card["launches"]["dg_wgrad"] == 1
        assert not any(cpu["launches"].values())
        np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5)
        for k, g in cpu["grads"].items():
            err = (card["grads"][k] - g).abs().max().item()
            assert err <= 1e-4 * g.abs().max().item(), (k, err)


# ---- the C++ loader: packages served by libtorch with no Python ----------

@pytest.fixture(scope="module")
def cpp_loader():
    """``(CUDA op library, loader)``, built from the repo's sources."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    from spconv_tpu_torch._build import build_loader, build_ops_library

    return build_ops_library(True)[0], build_loader(True)[0]


def _loader_case(case, dev):
    """``(forward, inputs, launches of one request)`` of a small net on the
    card: together they reach every CUDA kernel of the C++ op library."""
    from spconv_tpu_torch.quantization import (observe_encoder_scales,
                                               quantize_encoder)

    if case == "int8":
        x, _ = TCP.synthetic_centerpoint_input(0, shape=(40, 64, 64),
                                               n_target=1500, device=dev)
        net = centerpoint_encoder(in_channels=5, bn=False, device=dev).eval()
        with torch.no_grad():
            net = quantize_encoder(net, scales=observe_encoder_scales(
                net, [x]))
        want = dict(dg_pos=4, dg_pos_affine=4, dg_fwd_q=17,
                    dg_fwd_q_strided=4)
        shape, args = x.spatial_shape, (x.features, x.indices)
    else:
        dtype = torch.float32 if case == "keyed_f32" else torch.bfloat16
        gen = torch.Generator().manual_seed(3)
        kw = dict(algo="dg", device=dev, dtype=dtype, generator=gen)
        layers = {
            "keyed_bf16": lambda: [
                st.SubMConv3d(16, 32, 3, indice_key="s0", **kw),
                st.SparseConv3d(32, 64, 3, stride=2, padding=1,
                                out_bound=768, **kw)],
            "no_key": lambda: [st.SubMConv3d(16, 32, 3, **kw)],
            "sk_pool": lambda: [
                st.SubMConv3d(16, 16, 3, indice_key="s0", **kw),
                st.SparseMaxPool3d(2, 2, algo="sk", out_bound=768)],
            "inverse": lambda: [
                st.SparseConv3d(16, 32, 3, stride=2, padding=1,
                                indice_key="d1", out_bound=768, **kw),
                st.SparseInverseConv3d(32, 16, 3, indice_key="d1", **kw)],
        }
        layers["keyed_f32"] = layers["keyed_bf16"]
        net = st.SparseSequential(*layers[case]()).eval()
        want = {"keyed_bf16": dict(dg_pos=1, dg_fwd=1, dg_pos_affine=1,
                                   dg_fwd_strided=1),
                "no_key": dict(dg_fwd_search=1),
                "sk_pool": dict(dg_pos=1, dg_fwd=1, sk_pool=1),
                "inverse": dict(dg_pos_affine=1, dg_fwd_strided=1,
                                dg_pos_divide=1, dg_fwd_inverse=1)}
        want = want.get(case, want["keyed_bf16"])
        fb, ib = _sorted_input(7, 600, 16, 768)
        shape = SHAPE
        args = (torch.from_numpy(fb).to(dev, dtype), torch.from_numpy(ib)
                .to(dev))

    def forward(f, i):
        y = net(st.SparseConvTensor(f, i, shape, 1, keys_sorted=True))
        return y.features, y.indices

    return forward, args, want


@pytest.mark.parametrize("case", ["keyed_bf16", "keyed_f32", "int8",
                                  "no_key", "sk_pool", "inverse"])
def test_cpp_loader_serves_package_on_card(dev, cpp_loader, tmp_path, case):
    """A small net packaged on the card (``export.package``) and served by
    the C++ loader through the C++ op library: every output bit-equal to
    eager's, and the loader's launches a request eager's (B1 subm, affine
    and divide; B2 bf16 and f32 in table and search mode; B7; B6)."""
    from spconv_tpu_torch.examples.export_model import (run_loader,
                                                        write_artifact)

    forward, args, want = _loader_case(case, dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        TD.reset_launch_counts()
        forward(*args)
        torch.cuda.synchronize()
    assert TD.launch_counts == _counts(**want)
    res = write_artifact(tmp_path / case, forward, args, package=True)
    run = run_loader(*cpp_loader, tmp_path / case, 2)
    assert run["rc"] == 0 and run["ok"], (run["stdout"][-3000:],
                                          run["stderr"][-3000:])
    assert run["launches"] == want
    assert len(run["outputs"]) == len(res["outputs"]) == 2
    assert all(o["bitequal"] for o in run["outputs"]), run["outputs"]
    assert run["outputs"][0]["max_abs_ref"] > 0
