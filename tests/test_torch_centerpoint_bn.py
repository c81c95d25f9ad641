"""The CenterPoint encoder with BatchNorm trained in the port against the
JAX package on the CPU: every parameter's gradient of ``sum(bev ** 2)``
with ``bn=True`` in training mode (BN on the masked batch statistics, its
running statistics seeded away from (0, 1) and left as they were) against
``jax.grad`` of the JAX encoder's CPU route with ``training=True``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spconv_tpu
from spconv_tpu.checkpoint import load_state_dict, state_dict
from spconv_tpu.models import centerpoint_encoder as jax_encoder

from spconv_tpu_torch.benchmark import centerpoint as CP
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.models import centerpoint_encoder

SHAPE = (40, 64, 64)
N_VOX = 1500
# per tensor, of max|ref|: ROADMAP.md's grad tolerance (f32 sums in
# another order through 21 convs and 18 BNs)
GRAD_TOL = 5e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_centerpoint_bn_train_grads_match_jax():
    """``centerpoint_encoder(in_channels=5, bn=True)`` with seeded BN
    state, in training mode: the loss within 1e-4 relative of the JAX
    one's and every parameter's gradient (the convs, every BN's weight
    and bias) within GRAD_TOL of ``jax.grad``'s, per tensor; the forward
    leaves the running statistics as they were."""
    x, n = CP.synthetic_centerpoint_input(0, shape=SHAPE, n_target=N_VOX,
                                          device="cpu")
    assert n == N_VOX
    jnet = jax_encoder(in_channels=5, bn=True)
    rng = np.random.RandomState(3)
    sd = state_dict(jnet)
    for k, v in sd.items():
        if ".running_mean" in k or (k.endswith(".bias") and "bn" in k):
            sd[k] = (0.3 * rng.randn(*v.shape)).astype(np.float32)
        elif ".running_var" in k or (k.endswith(".weight") and "bn" in k):
            sd[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    jnet = load_state_dict(jnet, sd)
    tnet = load_jax_state_dict(
        centerpoint_encoder(in_channels=5, bn=True, device="cpu"), sd)
    tnet.train()
    jx = spconv_tpu.SparseConvTensor(
        jnp.asarray(x.features.numpy()), jnp.asarray(x.indices.numpy()),
        x.spatial_shape, x.batch_size, keys_sorted=True)

    def loss(m, t):
        return jnp.sum(m.bev(t, training=True).astype(jnp.float32) ** 2)

    loss_j, grads = spconv_tpu.filter_value_and_grad(loss)(jnet, jx)
    g_ref = state_dict(grads)
    stats = {k: v.clone() for k, v in tnet.state_dict().items()
             if "running" in k}
    loss_t = (tnet.bev(x).float() ** 2).sum()
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4 * float(
        loss_j)
    assert all(torch.equal(tnet.state_dict()[k], v)
               for k, v in stats.items())
    names = [name for name, _ in tnet.named_parameters()]
    # bn_input, two in each of the 8 blocks, bn_out
    assert sum(".bn" in k or k.startswith("bn_") for k in names) == 2 * 18
    for name, p in tnet.named_parameters():
        ref = g_ref[name]
        assert p.grad is not None and np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=name)
