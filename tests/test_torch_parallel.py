"""The port's data parallelism against the JAX package on the CPU (the
counterparts of ``tests/test_parallel.py``), with ``gloo`` ranks started
by ``parallel.run_ranks`` (a ``file://`` rendezvous under ``tmp_path``, so
parallel test workers never share a port): the data-parallel loss and
grads at mesh 2 and 4, SyncBN against JAX's ``shard_map`` SyncBN and
numpy's global statistics, ``channel_parallel_conv`` and
``data_parallel_call``, a sub-mesh of the world, the batch-2
single-process equivalence of a data-parallel step of the CenterPoint
encoder with SyncBN, the ``dist_train`` example (both of its paths) against
the JAX functions on the same scans, an unbound ``axis_name``, and ranks
that fail or hang.

The ranks' functions live at the top level here and this module imports
neither ``jax`` nor ``spconv_tpu`` at its top level: a spawned rank
imports it by name, and stays free of JAX."""

import multiprocessing
import time

import numpy as np
import pytest
import torch

SHAPE = (9, 10, 11)
NBUF = 256
CP_SHAPE = (40, 64, 64)  # the CenterPoint encoder at a small size
CP_VOXELS = 1500
# per tensor, of max|ref| (ROADMAP.md's grad tolerance: f32 sums in
# another order; the encoder's through 21 convs and 18 BNs)
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5


def _scan(seed, c=4, n=100):
    """``tests/test_parallel.py``'s ``make_scan`` as numpy arrays."""
    from utils import generate_sparse_data, pad_sparse

    rng = np.random.RandomState(seed)
    feats, inds = generate_sparse_data(SHAPE, n, c, batch_size=1, rng=rng)
    return pad_sparse(feats, inds, NBUF)


def _stacked(seeds, c=4):
    scans = [_scan(s, c) for s in seeds]
    return (np.stack([f for f, _ in scans]), np.stack([i for _, i in scans]))


# ---------------------------------------------------------------------------
# the ranks' functions (torch only)
# ---------------------------------------------------------------------------

def _dp_net():
    import spconv_tpu_torch as st

    return st.SparseSequential(
        st.SubMConv3d(4, 8, 3, indice_key="c1", device="cpu"),
        st.SparseReLU(),
        st.SparseConv3d(8, 16, 3, stride=2, padding=1, device="cpu"))


def _dp_loss(net, f, i):
    import spconv_tpu_torch as st

    out = net(st.SparseConvTensor(f, i, SHAPE, 1))
    return (st.SparseGlobalAvgPool()(out) ** 2).sum()


def _load(module, sd):
    from spconv_tpu_torch.checkpoint import load_jax_state_dict

    return load_jax_state_dict(module, sd)


def _encoder(axis_name=None):
    from spconv_tpu_torch.models import centerpoint_encoder
    from spconv_tpu_torch.modules import BatchNorm1d

    net = centerpoint_encoder(in_channels=5, bn=True, device="cpu").train()
    for m in net.modules():
        if isinstance(m, BatchNorm1d):
            m.axis_name = axis_name
    return net


def _bev_loss(net, x, scale):
    """``sum(bev ** 2) * scale``, every stage's bound checked uncut."""
    stages = net.forward_stages(x)
    for s in stages:
        s.check_overflow("the encoder")
    dense = stages[-1].dense()
    return (dense.float() ** 2).sum() * scale


def _encoder_input(seed):
    from spconv_tpu_torch.benchmark import centerpoint as CP

    return CP.synthetic_centerpoint_input(seed, shape=CP_SHAPE,
                                          n_target=CP_VOXELS, device="cpu")[0]


def _rank_checks(rank, world, data):
    """Every data-parallel path of one world size in one rank."""
    import spconv_tpu_torch as st
    from spconv_tpu_torch import parallel as P

    torch.set_num_threads(1)
    res = {}
    mesh = P.make_mesh(world)
    tp = P.make_mesh(world, axis="tp")
    feats = torch.from_numpy(data["feats"])
    inds = torch.from_numpy(data["inds"])
    net = _load(_dp_net(), data["net_sd"])
    loss, grads = P.data_parallel_value_and_grad(_dp_loss, mesh)(net, feats,
                                                                  inds)
    res["loss"] = loss.item()
    res["grads"] = grads
    res["param_grads"] = {n: p.grad for n, p in net.named_parameters()}
    with torch.no_grad():
        res["call"] = P.data_parallel_call(net, mesh)(net, feats, inds,
                                                      SHAPE, 1)
    # SyncBN on the ranks' own scans, then its running statistics
    bn = st.SparseSyncBatchNorm(4, affine=False, device="cpu")
    x = st.SparseConvTensor(torch.from_numpy(data["bn_feats"][rank]),
                            torch.from_numpy(data["bn_inds"][rank]),
                            SHAPE, 1)
    res["bn"] = bn(x).features
    bn.updated(x)
    res["bn_running"] = torch.stack([bn.running_mean, bn.running_var])
    res["bn_eval"] = bn.eval()(x).features
    # column-parallel conv on the replicated input
    conv = _load(st.SubMConv3d(8, 16, 3, indice_key="t0", device="cpu"),
                 data["cp_sd"])
    with torch.no_grad():
        res["cp"] = P.channel_parallel_conv(conv, tp, axis="tp")(
            conv.weight, conv.bias, torch.from_numpy(data["cp_feats"]),
            torch.from_numpy(data["cp_inds"]), SHAPE, 1)
    if world == 4:
        # a mesh of ranks 0 and 1 of the world of 4
        half = P.make_mesh(2, axis="half")
        res["half_rank"] = half.rank
        if half.rank >= 0:
            net2 = _load(_dp_net(), data["net_sd"])
            res["half_loss"] = P.data_parallel_value_and_grad(
                _dp_loss, half)(net2, feats[:2], inds[:2])[0].item()
    if data.get("encoder"):
        # the CenterPoint encoder with SyncBN, one step on this rank's scan
        enc = _encoder("dp")
        x = _encoder_input(rank)
        xs = x.features[None].expand(world, -1, -1)
        xi = x.indices[None].expand(world, -1, -1)
        step = P.data_parallel_value_and_grad(
            lambda n, f, i: _bev_loss(n, st.SparseConvTensor(
                f, i, CP_SHAPE, 1, keys_sorted=True), 1.0), mesh)
        loss, grads = step(enc, xs, xi)
        res["enc_loss"] = loss.item()
        res["enc_grads"] = grads
    return res


def _rank_raises(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def _rank_hangs(rank, world):
    import torch.distributed as dist

    if rank == 1:
        time.sleep(120)
    dist.barrier()
    return rank


# ---------------------------------------------------------------------------
# the runs, once per module, and their JAX references
# ---------------------------------------------------------------------------

def _jax_nets():
    import jax

    import spconv_tpu
    from spconv_tpu.checkpoint import state_dict

    net = spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 8, 3, indice_key="c1",
                              key=jax.random.PRNGKey(1)),
        spconv_tpu.SparseReLU(),
        spconv_tpu.SparseConv3d(8, 16, 3, stride=2, padding=1,
                                key=jax.random.PRNGKey(2)))
    conv = spconv_tpu.SubMConv3d(8, 16, 3, indice_key="t0",
                                 key=jax.random.PRNGKey(3))
    return net, conv, state_dict(net), state_dict(conv)


def _run(world, tmp_path_factory):
    """One ``gloo`` run of :func:`_rank_checks` at mesh ``world``:
    ``(world, inputs, rank results)``."""
    from spconv_tpu_torch.parallel import run_ranks

    _, _, net_sd, cp_sd = _jax_nets()
    feats, inds = _stacked(range(world))
    bn_feats, bn_inds = _stacked(range(100, 100 + world))
    cp_feats, cp_inds = _scan(7, c=8, n=200)
    data = dict(feats=feats, inds=inds, net_sd=net_sd, bn_feats=bn_feats,
                bn_inds=bn_inds, cp_sd=cp_sd, cp_feats=cp_feats,
                cp_inds=cp_inds, encoder=world == 2)
    res = run_ranks(_rank_checks, world, (data,), backend="gloo",
                    timeout=240, workdir=str(tmp_path_factory.mktemp("dp")))
    return world, data, res


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.fixture(params=[2, 4])
def run(request):
    return request.getfixturevalue(f"run{request.param}")


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_dp_grads_match_jax(run):
    """The mean loss and every mean gradient of the data-parallel step
    against the JAX ``data_parallel_value_and_grad`` on the same scans
    (loss 1e-5 relative, grads 1e-4 of max per tensor); every rank holds
    the same values, in its parameters' ``.grad`` too."""
    import jax

    from spconv_tpu.checkpoint import state_dict
    from spconv_tpu.core import SparseConvTensor
    from spconv_tpu.parallel import data_parallel_value_and_grad, make_mesh

    import spconv_tpu

    world, data, res = run
    jnet = _jax_nets()[0]

    def loss_fn(m, f, i):
        out = m(SparseConvTensor(f, i, SHAPE, 1))
        return jax.numpy.sum(spconv_tpu.SparseGlobalAvgPool()(out) ** 2)

    step = data_parallel_value_and_grad(loss_fn, make_mesh(world))
    loss, grads = jax.jit(step)(jnet, data["feats"], data["inds"])
    want = state_dict(grads)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=LOSS_RTOL)
        assert set(r["grads"]) == {k.replace("layers.", "")
                                   for k in want}
        for k, g in want.items():
            name = k.replace("layers.", "")
            _close(r["grads"][name], g, GRAD_TOL, name)
            assert torch.equal(r["param_grads"][name], r["grads"][name])
        for name, g in r["grads"].items():
            assert torch.equal(g, res[0]["grads"][name])


def test_sync_bn_matches_jax_and_global_stats(run):
    """SyncBN (training) on each rank's scan against JAX's SyncBN under
    ``shard_map`` and against numpy's statistics over every rank's active
    rows (1e-4); the running statistics advance by the global ones; eval
    mode normalizes with them."""
    import jax
    from jax.sharding import PartitionSpec as Pspec

    import spconv_tpu
    from spconv_tpu.core import SparseConvTensor
    from spconv_tpu.parallel import make_mesh

    world, data, res = run
    bn = spconv_tpu.SparseSyncBatchNorm(4, affine=False, axis_name="dp")

    def shard_fn(f, i):
        return bn(SparseConvTensor(f[0], i[0], SHAPE, 1),
                  training=True).features[None]

    want = np.asarray(jax.jit(jax.shard_map(
        shard_fn, mesh=make_mesh(world), in_specs=(Pspec("dp"), Pspec("dp")),
        out_specs=Pspec("dp")))(data["bn_feats"], data["bn_inds"]))
    valid = data["bn_inds"][..., 0] >= 0
    f = data["bn_feats"][valid].astype(np.float64)
    mean, var = f.mean(0), f.var(0)
    for r, out in enumerate(res):
        _close(out["bn"], want[r], 1e-4, f"rank {r} vs JAX")
        got = out["bn"].numpy()[valid[r]]
        np.testing.assert_allclose(
            got, (data["bn_feats"][r][valid[r]] - mean) / np.sqrt(var + 1e-5),
            atol=1e-4)
        assert not out["bn"].numpy()[~valid[r]].any()
        n = f.shape[0]
        np.testing.assert_allclose(
            out["bn_running"].numpy(),
            np.stack([0.1 * mean, 0.9 + 0.1 * var * n / (n - 1)]),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            out["bn_eval"].numpy()[valid[r]],
            (data["bn_feats"][r][valid[r]] - out["bn_running"][0].numpy())
            / np.sqrt(out["bn_running"][1].numpy() + 1e-5), atol=1e-5)


def test_channel_parallel_conv_and_dp_call_match_jax(run):
    """``channel_parallel_conv`` (K split over the ranks) against the JAX
    function and the whole layer, and ``data_parallel_call``'s gathered
    outputs against the JAX call, within 1e-5 of max."""
    import jax

    import spconv_tpu
    from spconv_tpu.parallel import (channel_parallel_conv,
                                     data_parallel_call, make_mesh)

    world, data, res = run
    jnet, jconv, _, _ = _jax_nets()
    fn = channel_parallel_conv(jconv, make_mesh(world, axis="tp"), axis="tp")
    of, oi = jax.jit(lambda w, b, f, i: fn(w, b, f, i, SHAPE, 1))(
        jconv.weight, jconv.bias, data["cp_feats"], data["cp_inds"])
    whole = jconv(spconv_tpu.SparseConvTensor(
        jax.numpy.asarray(data["cp_feats"]),
        jax.numpy.asarray(data["cp_inds"]), SHAPE, 1)).features
    call = data_parallel_call(jnet, make_mesh(world))
    cf, ci = jax.jit(lambda n, f, i: call(n, f, i, SHAPE, 1))(
        jnet, data["feats"], data["inds"])
    for r, out in enumerate(res):
        got_f, got_i = out["cp"]
        _close(got_f, of, 1e-5, f"rank {r} channel-parallel vs JAX")
        _close(got_f, whole, 1e-5, f"rank {r} channel-parallel vs layer")
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(oi))
        f, i = out["call"]
        assert tuple(f.shape) == tuple(cf.shape)
        _close(f, cf, 1e-5, f"rank {r} data_parallel_call")
        np.testing.assert_array_equal(i.numpy(), np.asarray(ci))


def test_sub_mesh(run4):
    """A mesh of ranks 0-1 in a world of 4: ranks 2-3 are off it, and its
    data-parallel loss on scans 0-1 is the JAX net's mean loss on them."""
    _, data, res = run4
    assert [r["half_rank"] for r in res] == [0, 1, -1, -1]
    import jax

    import spconv_tpu
    from spconv_tpu.core import SparseConvTensor

    jnet = _jax_nets()[0]
    want = np.mean([float(jax.numpy.sum(spconv_tpu.SparseGlobalAvgPool()(
        jnet(SparseConvTensor(data["feats"][s], data["inds"][s], SHAPE, 1)))
        ** 2)) for s in (0, 1)])
    for r in res[:2]:
        np.testing.assert_allclose(r["half_loss"], want, rtol=LOSS_RTOL)


def _batch_of(xs):
    """One tensor holding the active rows of ``xs`` (key-sorted, one scan
    each) as batch items 0, 1, ...: still key-sorted."""
    import spconv_tpu_torch as st

    feats, inds = [], []
    for b, x in enumerate(xs):
        n = int(x.num_voxels)
        i = x.indices[:n].clone()
        i[:, 0] = b
        feats.append(x.features[:n])
        inds.append(i)
    n = sum(f.shape[0] for f in feats)
    nbuf = -(-n // 1024) * 1024
    f = torch.zeros((nbuf, feats[0].shape[1]), dtype=feats[0].dtype)
    i = torch.full((nbuf, inds[0].shape[1]), -1, dtype=torch.int32)
    f[:n] = torch.cat(feats)
    i[:n] = torch.cat(inds)
    return st.SparseConvTensor(f, i, xs[0].spatial_shape, len(xs),
                               keys_sorted=True)


def test_encoder_dp_step_equals_batch_of_two(run2):
    """The data-parallel step of the CenterPoint encoder with SyncBN
    (every BN on ``"dp"``; rank ``r`` on scan ``r``, ``sum(bev ** 2)``)
    against one process's step on one tensor holding both scans (batch 2,
    ``sum(bev ** 2) / 2``, BN on both scans' statistics): the loss within
    1e-5 relative, every gradient within 1e-4 of max; both ranks' grads
    bit-equal."""
    _, _, res = run2
    torch.set_num_threads(1)
    net = _encoder(None)
    x2 = _batch_of([_encoder_input(0), _encoder_input(1)])
    loss = _bev_loss(net, x2, 0.5)
    loss.backward()
    for r in res:
        np.testing.assert_allclose(r["enc_loss"], loss.item(),
                                   rtol=LOSS_RTOL)
        for name, p in net.named_parameters():
            _close(r["enc_grads"][name], p.grad, GRAD_TOL, name)
    assert all(torch.equal(g, res[1]["enc_grads"][k])
               for k, g in res[0]["enc_grads"].items())


@pytest.fixture(scope="module")
def dist_train_run(tmp_path_factory):
    from spconv_tpu_torch.examples import dist_train

    return dist_train.main(steps=2, device="cpu",
                           workdir=str(tmp_path_factory.mktemp("ex")))


def test_dist_train_ddp_path_equals_dp(dist_train_run):
    """The example's ``DistributedDataParallel`` path gives the losses,
    first-step grads and final weights of its
    ``data_parallel_value_and_grad`` path (f32 sums of two halves: equal
    within 1e-6)."""
    r = dist_train_run
    np.testing.assert_allclose(r["ddp_losses"], r["losses"], rtol=1e-6)
    for k, g in r["grads0"].items():
        _close(r["ddp_grads0"][k], g, 1e-6, k)
    for k, v in r["state"].items():
        _close(r["ddp_state"][k], v, 1e-6, k)


def test_dist_train_matches_jax(dist_train_run):
    """``dist_train.main(steps=2, device="cpu")`` against the JAX
    ``data_parallel_value_and_grad`` with SyncBN in training mode, on the
    example's scans from the same weights, with the same SGD: each step's
    mean loss (1e-5 relative) and the final weights (1e-5 of max); the
    losses are finite, and the first step's scans score lower after the
    last step than at the first."""
    import jax

    import spconv_tpu
    from spconv_tpu.checkpoint import load_state_dict, state_dict
    from spconv_tpu.core import SparseConvTensor
    from spconv_tpu.parallel import (data_parallel_value_and_grad,
                                     make_mesh, stack_sparse_batch)

    from spconv_tpu_torch.examples import dist_train

    r = dist_train_run
    init = dist_train.build_net("cpu", 0).state_dict()
    jnet = load_state_dict(spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(4, 16, 3, indice_key="c1"),
        spconv_tpu.SparseSyncBatchNorm(16, axis_name="dp"),
        spconv_tpu.SparseReLU(),
        spconv_tpu.SparseConv3d(16, 32, 3, stride=2, padding=1)),
        {f"layers.{k}": v.numpy() for k, v in init.items()})

    def loss_fn(m, f, i):
        out = m(SparseConvTensor(f, i, dist_train.SHAPE, 1), training=True)
        return jax.numpy.mean(spconv_tpu.SparseGlobalAvgPool()(out) ** 2)

    step = jax.jit(data_parallel_value_and_grad(loss_fn, make_mesh(2)))
    losses = []
    for s in range(2):
        scans = [dist_train.make_scan(2 * s + d, device="cpu")
                 for d in range(2)]
        feats, inds = stack_sparse_batch([SparseConvTensor(
            jax.numpy.asarray(t.features.numpy()),
            jax.numpy.asarray(t.indices.numpy()), dist_train.SHAPE, 1)
            for t in scans])
        loss, grads = step(jnet, feats, inds)
        dyn, sta = spconv_tpu.partition(jnet, spconv_tpu.module._is_inexact)
        dyn = jax.tree_util.tree_map(
            lambda p, g: p - dist_train.LR * g if g is not None else p, dyn,
            grads, is_leaf=lambda v: v is None)
        jnet = spconv_tpu.combine(dyn, sta)
        losses.append(float(loss))
    assert np.all(np.isfinite(r["losses"]))
    assert r["loss_after"] < r["losses"][0]
    np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
    for k, v in state_dict(jnet).items():
        _close(r["state"][k.replace("layers.", "")], v, 1e-5, k)


def test_unbound_axis_raises():
    """Training with an ``axis_name`` that no mesh registered raises
    ``RuntimeError`` naming the axis (no fall back to local statistics);
    eval mode needs no collective; ``make_mesh`` without a process group
    raises."""
    import spconv_tpu_torch as st
    from spconv_tpu_torch.parallel import make_mesh

    f, i = _scan(3)
    x = st.SparseConvTensor(torch.from_numpy(f), torch.from_numpy(i), SHAPE,
                            1)
    for bn in (st.BatchNorm1d(4, axis_name="nowhere", device="cpu"),
               st.SparseSyncBatchNorm(4, axis_name="nowhere",
                                      device="cpu")):
        with pytest.raises(RuntimeError, match="'nowhere'"):
            bn(x)
        with pytest.raises(RuntimeError, match="'nowhere'"):
            bn.updated(x)
        assert torch.isfinite(bn.eval()(x).features).all()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2)


@pytest.mark.parametrize("fn,timeout,why", [
    (_rank_raises, 120, "codes"), (_rank_hangs, 8, "timeout")])
def test_failed_or_hung_rank_fails_loudly(tmp_path, fn, timeout, why):
    """A rank that raises, or a run past its timeout, raises
    ``RuntimeError`` and leaves no process behind."""
    from spconv_tpu_torch.parallel import run_ranks

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=why):
        run_ranks(fn, 2, backend="gloo", timeout=timeout,
                  workdir=str(tmp_path))
    assert time.monotonic() - t0 < timeout + 60
    assert multiprocessing.active_children() == []


def test_sync_bn_state_dict_loads_from_jax():
    """A JAX ``SparseSyncBatchNorm``'s state dict loads strictly into the
    port's, as a BN's does (its tensors are a BN's), and the axis is not
    part of it."""
    import spconv_tpu
    from spconv_tpu.checkpoint import state_dict

    import spconv_tpu_torch as st
    from spconv_tpu_torch.checkpoint import load_jax_state_dict

    sd = state_dict(spconv_tpu.SparseSyncBatchNorm(16, axis_name="dp"))
    rng = np.random.RandomState(5)
    sd = {k: rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
          for k, v in sd.items()}
    bn = load_jax_state_dict(st.SparseSyncBatchNorm(16, device="cpu"), sd)
    assert sorted(bn.state_dict()) == sorted(sd) == sorted(
        st.BatchNorm1d(16, device="cpu").state_dict())
    for k, v in bn.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    assert bn.axis_name == "dp"
