"""The plain reference against the port on the CPU, in float32, at a tiny
size: subm and strided convs, the max pool, BN, the CenterPoint BEV and a
training step's gradients; and the reference's pair count against a
brute-force count."""

import itertools

import numpy as np
import pytest
import torch

from h100_bench.harness import check, runner, spec
from h100_bench.loops import serve, train
from h100_bench.reference import sparse as S

SHAPE = (9, 12, 10)


def _sites(seed, n, batch=2):
    rng = np.random.default_rng(seed)
    grid = np.array([[b, z, y, x] for b in range(batch)
                     for z, y, x in itertools.product(*map(range, SHAPE))])
    pick = rng.choice(len(grid), n, replace=False)
    coords = torch.from_numpy(grid[np.sort(pick)]).int()
    feats = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    return coords, feats


def _port_tensor(coords, feats, pad=16):
    from spconv_tpu_torch import SparseConvTensor

    n = coords.shape[0]
    f = torch.cat([feats, feats.new_zeros((pad, feats.shape[1]))])
    i = torch.cat([coords, coords.new_full((pad, 4), -1)])
    return SparseConvTensor(f, i, SHAPE, 2, keys_sorted=True), n


def _by_site(coords, feats, shape):
    """``{key: row}`` of active sites."""
    k = S.keys(coords.long(), shape)
    return {int(a): feats[j] for j, a in enumerate(k)}


def _assert_same_sites(port_out, ref_coords, ref_feats, shape, tol=1e-5):
    valid = port_out.indices[:, 0] >= 0
    got = _by_site(port_out.indices[valid],
                   port_out.features.detach()[valid], shape)
    want = _by_site(ref_coords, ref_feats, shape)
    assert set(got) == set(want)
    scale = max(float(ref_feats.abs().max()), 1e-6)
    for k, v in want.items():
        assert float((got[k] - v).abs().max()) <= tol * scale


def test_subm_conv_matches_port():
    from spconv_tpu_torch.modules import SubMConv3d

    coords, feats = _sites(0, 300)
    x, n = _port_tensor(coords, feats)
    conv = SubMConv3d(6, 8, 3, bias=False, indice_key="s", device="cpu")
    out = conv(x)
    rb = S.subm_rulebook(coords.long(), SHAPE, (3, 3, 3))
    ref = S.conv(feats, conv.weight.detach(), rb)
    _assert_same_sites(out, coords, ref, SHAPE)


@pytest.mark.parametrize("ksize,stride,padding", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
])
def test_strided_conv_matches_port(ksize, stride, padding):
    from spconv_tpu_torch.modules import SparseConv3d

    coords, feats = _sites(1, 300)
    x, n = _port_tensor(coords, feats)
    conv = SparseConv3d(6, 8, ksize, stride=stride, padding=padding,
                        bias=True, indice_key="d", device="cpu",
                        out_bound=512)
    out = conv(x)
    oc, oshape, rb = S.conv_rulebook(coords.long(), SHAPE, ksize, stride,
                                     padding)
    assert tuple(oshape) == tuple(out.spatial_shape)
    ref = S.conv(feats, conv.weight.detach(), rb, conv.bias.detach())
    _assert_same_sites(out, oc, ref, oshape)


def test_max_pool_matches_port():
    from spconv_tpu_torch.modules import SparseMaxPool3d

    coords, feats = _sites(2, 300)
    x, n = _port_tensor(coords, feats)
    out = SparseMaxPool3d(2, 2, out_bound=512)(x)
    oc, oshape, row = S.pool2_map(coords.long(), SHAPE)
    ref = S.max_pool2(feats, row, oc.shape[0])
    _assert_same_sites(out, oc, ref, oshape, tol=0.0)


def test_batch_norm_matches_port():
    from spconv_tpu_torch.modules import BatchNorm1d

    coords, feats = _sites(3, 200)
    x, n = _port_tensor(coords, feats)
    bn = BatchNorm1d(6, device="cpu").train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    out = bn(x)
    ref = S.batch_norm(feats, bn.weight.detach(), bn.bias.detach(), bn.eps)
    assert torch.allclose(out.features[:n], ref, atol=1e-5)


def test_pair_count_matches_brute_force():
    coords, _ = _sites(4, 150)
    sites = {tuple(c) for c in coords.tolist()}
    subm = sum((b, z + dz, y + dy, x + dx) in sites
               for b, z, y, x in sites
               for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3))
    rb = S.subm_rulebook(coords.long(), SHAPE, (3, 3, 3))
    assert rb.num_pairs() == subm
    # strided k3 s2 p1: input site i pairs output o where i = 2 o - 1 + k
    out_shape = S.conv_output_shape(SHAPE, (3,) * 3, (2,) * 3, (1,) * 3)
    pairs = set()
    for b, z, y, x in sites:
        for k in itertools.product(range(3), repeat=3):
            o = [(v + 1 - kk) for v, kk in zip((z, y, x), k)]
            if all(v % 2 == 0 and 0 <= v // 2 < s
                   for v, s in zip(o, out_shape)):
                pairs.add((b, z, y, x, k))
    _, _, rb = S.conv_rulebook(coords.long(), SHAPE, (3,) * 3, (2,) * 3,
                               (1,) * 3)
    assert rb.num_pairs() == len(pairs)


def _f32_setup(workload, seed):
    cell = spec.load_cell(workload)
    cell.config["rehearsal"] = dict(cell.config["rehearsal"],
                                    dtype="float32")
    return runner.build(cell, seed, torch.device("cpu"), rehearse=True)


def test_centerpoint_bev_matches_port():
    s = _f32_setup("cp-serve-b16", 5)
    got = s.loop(0)
    ref = serve.ref_serve(s, 0)
    assert check.serve_numbers([(got, ref)])["out_rel_l2"] < 1e-5


@pytest.mark.parametrize("workload", ["cp-train-b16", "benchnet-train-b8"])
def test_training_steps_match_port(workload):
    s = _f32_setup(workload, 6)
    got = check.train_numbers(train.program_steps(s.loop),
                              train.ref_steps(s))
    assert max(got.values()) < 2e-3, got
