"""BatchNorm1d's training ops (``ops/batch_norm.py``) on the CPU: the
closed-form backward of ``BatchNormFn`` against ``gradcheck`` in f64 and
against autograd through the plain formula (the parent's op-by-op BN) in
f32 and bf16, each op's schema and fake through ``torch.library.opcheck``,
the CPU path counting no launch, and the kernels' host plan."""

import numpy as np
import pytest
import torch

import spconv_tpu_torch as st
from spconv_tpu_torch.ops import batch_norm as B

EPS = 1e-3


def _inputs(n=60, active=45, c=5, dtype=torch.float64, seed=0):
    """``(x, indices)``: ``n`` rows of ``c`` channels, the last ``n -
    active`` inactive (index -1, features 0), channel 0 near constant (the
    one-pass variance's cancellation)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, c), generator=g, dtype=torch.float64) * 3 + 1
    x[:, 0] = 100 + 1e-3 * torch.randn(n, generator=g, dtype=torch.float64)
    ind = torch.full((n, 4), -1, dtype=torch.int32)
    ind[:active, 0] = 0
    ind[:active, 1] = torch.arange(active, dtype=torch.int32)
    x[active:] = 0
    return x.to(dtype), ind


def _affine(c, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    w = (torch.rand(c, generator=g, dtype=torch.float64) + 0.5).to(dtype)
    b = (0.3 * torch.randn(c, generator=g, dtype=torch.float64)).to(dtype)
    return w.requires_grad_(), b.requires_grad_()


def _plain_forward(x, indices, w, b):
    """The plain formula, differentiated by autograd op by op."""
    stats, mask = B.bn_stats_plain(x, indices)
    return B.bn_norm_plain(x, mask, stats, w, b, EPS)[0]


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("sparse", [True, False])
def test_batch_norm_fn_gradcheck(sparse, affine):
    """``gradcheck`` of ``BatchNormFn`` in f64 on a small masked input
    (and on a plain one, every row active), with and without the affine
    part: the closed form is the exact gradient."""
    x, ind = _inputs(n=24, active=18, c=3)
    x[:, 0] = torch.randn(24, dtype=torch.float64)
    x = x.requires_grad_()
    w, b = _affine(3, torch.float64) if affine else (None, None)
    ind = ind if sparse else None
    args = (x, w, b) if affine else (x,)

    def fn(x, w=None, b=None):
        return B.batch_norm_train(x, ind, w, b, EPS)

    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("c", [5, 16, 64])
def test_batch_norm_fn_matches_autograd(c, dtype, tol):
    """Forward bit-equal to the plain formula; ``dx``, ``dweight`` and
    ``dbias`` of ``BatchNormFn`` against autograd through it.  f32: within
    2e-6 of max|ref| (the closed form sums in f64, autograd's chain rounds
    each of its f32 steps); bf16: ``dx`` within 8e-3 of max|ref| (two f32
    results a rounding apart can round to neighbouring bf16 values, 2^-8
    of a value apart), ``dweight`` and ``dbias`` as f32.  Inactive rows of
    ``y`` and ``dx`` are 0."""
    x, ind = _inputs(n=300, active=250, c=c, dtype=dtype)
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(x.shape, generator=g).to(dtype)
    got, want = {}, {}
    for out, fwd in ((got, lambda x, w, b: B.batch_norm_train(
            x, ind, w, b, EPS)), (want, lambda x, w, b: _plain_forward(
                x, ind, w, b))):
        xx = x.clone().requires_grad_()
        w, b = _affine(c, torch.float32)
        y = fwd(xx, w, b)
        (y.float() * dy.float()).sum().backward()
        out.update(y=y, dx=xx.grad, dw=w.grad, db=b.grad)
    assert torch.equal(got["y"], want["y"])
    assert not got["y"][250:].any() and not got["dx"][250:].any()
    assert got["dx"].dtype == dtype
    for k in ("dx", "dw", "db"):
        t = tol if k == "dx" else 2e-6
        ref = want[k].float()
        err = (got[k].float() - ref).abs().max().item()
        assert err <= t * ref.abs().max().item(), (k, err)


def test_batch_norm_near_constant_channel_stats():
    """The statistics of bf16 features with a channel at 100 or 100.5 (var
    ~0.06, 1e-5 of the mean square): count exact, mean and var within
    1e-6 relative of numpy's two-pass f64 ones (the f64 sums keep the
    one-pass variance from cancelling; bf16 squares are exact in f32)."""
    x, ind = _inputs(n=2000, active=1500, c=4, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    x[:1500, 0] = 100 + 0.5 * torch.randint(0, 2, (1500,), generator=g)
    x = x.bfloat16()
    stats, mask = B.bn_stats_plain(x, ind)
    mean, var, cnt = B.moments(stats, 4, torch.float32)
    ref = x[:1500].double().numpy()
    assert float(cnt) == 1500 and mask.dtype == torch.uint8
    assert int(mask.sum()) == 1500
    np.testing.assert_allclose(mean.numpy(), ref.mean(0), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), ref.var(0), rtol=1e-6)


def _op_args():
    x, ind = _inputs(n=20, active=15, c=6, dtype=torch.float32)
    w, b = (t.detach() for t in _affine(6, torch.float32))
    stats, mask = B.bn_stats_plain(x, ind)
    _, mean, rstd = B.bn_norm_plain(x, mask, stats, w, b, EPS)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    sums, _ = B.bn_bwd_reduce_plain(dy, x, mask, mean, rstd)
    nomask = mask[:0]
    return {
        "stats": (B._BN_STATS, (x, ind)),
        "stats_plain_tensor": (B._BN_STATS, (x, None)),
        "norm": (B._BN_NORM, (x, mask, stats, w, b, EPS)),
        "norm_no_affine_all_rows": (B._BN_NORM, (x, nomask, stats, None,
                                                  None, EPS)),
        "bwd_reduce": (B._BN_BWD_REDUCE, (dy, x, mask, mean, rstd)),
        "bwd_dx": (B._BN_BWD_DX, (dy, x, mask, mean, rstd, w, sums, stats)),
        "bwd_dx_no_affine": (B._BN_BWD_DX, (dy, x, nomask, mean, rstd, None,
                                            sums, stats)),
    }


@pytest.mark.parametrize("case", sorted(_op_args()))
def test_batch_norm_opcheck(case):
    """``torch.library.opcheck`` (schema, fake, dispatch) on the CPU
    arguments each wrapper passes; the CPU kernel is the plain version."""
    op, args = _op_args()[case]
    torch.library.opcheck(op, args)


def test_batch_norm_cpu_counts_no_launch():
    """A training step and an ``updated`` call of ``BatchNorm1d`` on the
    CPU run the plain versions and count no launch."""
    B.reset_launch_counts()
    x, ind = _inputs(n=50, active=40, c=8, dtype=torch.float32)
    t = st.SparseConvTensor(x.requires_grad_(), ind, (1, 64, 1), 1)
    bn = st.BatchNorm1d(8, device="cpu").train()
    (bn(t).features ** 2).sum().backward()
    bn.updated(t)
    assert x.grad is not None and bn.weight.grad is not None
    assert not any(B.launch_counts.values())


@pytest.mark.parametrize("c,itemsize,align,want", [
    # (vec, tpr, rows, threads, groups): 16-byte vectors where C allows
    (16, 2, 16, (8, 2, 128, 256, 1)),
    (128, 2, 16, (8, 16, 16, 256, 1)),
    (256, 4, 16, (4, 64, 4, 256, 1)),
    (5, 4, 16, (1, 5, 51, 255, 1)),
    (5, 2, 16, (1, 5, 51, 255, 1)),
    (6, 2, 16, (2, 3, 85, 255, 1)),
    (12, 4, 16, (4, 3, 85, 255, 1)),
    # a pointer 4 bytes off a 16-byte boundary narrows the vector
    (16, 2, 4, (2, 8, 32, 256, 1)),
    # wider than 256 vectors: the channels split over blockIdx.y
    (4096, 2, 16, (8, 256, 1, 256, 2)),
    (1000, 4, 16, (4, 250, 1, 250, 1)),
])
def test_bn_plan(c, itemsize, align, want):
    """The host plan: the widest vector dividing a row and the pointers'
    alignment, whole rows a block up to 256 threads, channel groups past
    256 vectors, and ``BN_BLOCKS_PER_SM`` blocks an SM where the rows
    last (at least one block)."""
    p = B.bn_plan(1_000_000, c, itemsize, align, sms=132)
    assert (p.vec, p.tpr, p.rows, p.threads, p.groups) == want
    assert p.grid == B.BN_BLOCKS_PER_SM * 132
    assert p.tpr * p.groups * p.vec >= c and p.threads <= B.BN_THREADS
    assert B.bn_plan(10, c, itemsize, align, sms=132).grid == -(-10 //
                                                                 p.rows)
    assert B.bn_plan(0, c, itemsize, align, sms=132).grid == 1
