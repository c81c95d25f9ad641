"""The slice: the BenchNet training step.  The port's full-width BenchNet
takes two ``train_step``s (forward, ``sum(out ** 2)``, backward, SGD) in f32
on the CPU; the JAX package's BenchNet takes the same step through
``filter_value_and_grad`` and ``p - lr * g``, with the same weights carried
across by ``load_jax_state_dict``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.benchmark import basic as JB
from spconv_tpu.checkpoint import load_state_dict, state_dict

from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import dg_conv as TD

SHAPE = (64, 128, 128)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small torch ops; with one intra-op
    thread each, parallel test workers do not oversubscribe the CPU (a
    whole-net test ran ~7x slower beside five busy processes without
    this)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LOSS_RTOL = 1e-4  # f32 sums in another order, through 14 layers and back
GRAD_TOL = 1e-3   # per tensor, of max|ref|; measured ~1e-6


def _jax_loss(net, x):
    t = spconv_tpu.SparseConvTensor(x.features, x.indices, SHAPE, 1,
                                    keys_sorted=True)
    out = net(t, training=True).features
    return jnp.sum(out.astype(jnp.float32) ** 2)


def test_benchnet_train_step_matches_jax():
    voxels, coors, _ = TB.synthetic_scan(0, shape=SHAPE, n_target=1600)
    jnet = JB.BenchNet(SHAPE)
    tnet = TB.BenchNet(SHAPE, device="cpu")
    load_jax_state_dict(tnet, state_dict(jnet))
    jx = JB.make_bench_input(voxels, coors, SHAPE)
    loss_j, grads = spconv_tpu.filter_value_and_grad(_jax_loss)(jnet, jx)
    g_ref = state_dict(grads)
    w_ref = state_dict(jnet)
    # a step that moves the largest weight by 1 % of the largest weight
    lr = 0.01 * max(np.abs(w).max() for w in w_ref.values()) / max(
        np.abs(g).max() for g in g_ref.values())
    jnet2 = load_state_dict(
        jnet, {k: w_ref[k] - lr * g_ref[k] for k in w_ref})
    loss2_j = float(_jax_loss(jnet2, jx))

    x = TB.make_bench_input(voxels, coors, SHAPE, device="cpu")
    TD.reset_launch_counts()
    loss = TB.train_step(tnet, x, lr)
    grads_t = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    loss2 = TB.train_step(tnet, x, lr)
    # CPU tensors take the plain versions: no kernel ran
    assert not any(TD.launch_counts.values())

    assert abs(float(loss) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert sorted(grads_t) == sorted(g_ref)
    for k, got in grads_t.items():
        ref = g_ref[k]
        assert tuple(got.shape) == ref.shape
        scale = np.abs(ref).max()
        assert scale > 0, k
        err = np.abs(got.numpy() - ref).max()
        assert err <= GRAD_TOL * scale, (k, err, scale)
    # the update moved the loss, the same way on both sides
    assert abs(loss2_j - float(loss_j)) > 1e-3 * float(loss_j)
    assert abs(float(loss2) - loss2_j) <= LOSS_RTOL * abs(loss2_j)


def test_stage_tables_under_grad_and_inference():
    """The reversed table is built once per stage, only when a gradient
    is wanted: under ``inference_mode`` no stage record holds one; in a
    training forward every stage's record does, and both convs of a stage
    share it."""
    voxels, coors, _ = TB.synthetic_scan(1, shape=SHAPE, n_target=800)
    net = TB.BenchNet(SHAPE, device="cpu")
    x = TB.make_bench_input(voxels, coors, SHAPE, device="cpu")
    with torch.inference_mode():
        stages = net.forward_stages(x)
    recs = stages[-1].indice_dict
    assert sorted(recs) == [f"c{s}" for s in range(7)]
    assert all(r.pos_rev is None for r in recs.values())
    stages = net.forward_stages(x)
    for s, out in enumerate(stages):
        rec = out.indice_dict[f"c{s}"]
        assert rec.pos_rev is not None
        assert torch.equal(rec.pos_rev, rec.pos.flip(0))
    assert stages[-1].features.requires_grad
