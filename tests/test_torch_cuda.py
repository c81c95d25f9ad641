"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD

from utils import generate_sparse_data

pytestmark = pytest.mark.cuda

SHAPE = (9, 40, 40)
KSIZE = (3, 3, 3)
DIL = (1, 1, 1)
KV = 27


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


def _plain_pos(inds):
    keys, _ = TC.linearize(torch.from_numpy(inds), SHAPE, 1)
    return keys, TD.dg_pos_plain(keys, ksize=KSIZE, dilation=DIL,
                                 spatial_shape=SHAPE, batch_size=1)


def test_dg_pos_kernel_matches_plain(dev):
    _, inds = _sorted_input(5, 3000, 4, 3072)
    keys, ref = _plain_pos(inds)
    before = TD.dg_pos_launches
    got = TD.build_dg_pos(keys.to(dev), ksize=KSIZE, dilation=DIL,
                          spatial_shape=SHAPE, batch_size=1)
    torch.cuda.synchronize()
    assert TD.dg_pos_launches == before + 1
    assert torch.equal(got.cpu(), ref)


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
    before = TD.dg_fwd_launches
    got = TD.dg_fwd(x, w, pos)
    torch.cuda.synchronize()
    assert TD.dg_fwd_launches == before + 1 and got.dtype == dtype
    got = got.float()
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err
    assert not got[3000:].any()


def test_benchnet_on_card_matches_cpu(dev):
    """The whole net through both kernels on the card against the plain
    versions on the CPU, f32."""
    shape = (64, 128, 128)
    voxels, coors, _ = TB.synthetic_scan(0, shape=shape, n_target=1600)
    net = TB.BenchNet(shape)
    with torch.no_grad():
        ref = net.forward_stages(TB.make_bench_input(voxels, coors, shape))
        net.to(dev)
        TD.reset_launch_counts()
        got = net.forward_stages(
            TB.make_bench_input(voxels, coors, shape, device=dev))
        torch.cuda.synchronize()
    assert (TD.dg_pos_launches, TD.dg_fwd_launches) == (7, 14)
    for r, g in zip(ref, got):
        assert torch.equal(g.indices.cpu(), r.indices)
        scale = r.features.abs().max().item()
        err = (g.features.cpu() - r.features).abs().max().item()
        assert err <= 1e-4 * scale, (err, scale)
