"""The whole slice: the port's full-width BenchNet against the JAX
package's, in f32 on the CPU, with the JAX weights carried across by
``load_jax_state_dict``.  Coordinates must be equal at every stage and
features within 1e-4 * max|ref| (f32 sums in another order, through 14
layers)."""

import numpy as np
import torch

from spconv_tpu.benchmark import basic as JB
from spconv_tpu.checkpoint import state_dict

from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.checkpoint import load_jax_state_dict

SHAPE = (64, 128, 128)


def _jax_stages(net, x):
    out = []
    for stage in range(7):
        if stage:
            x = net.pools[stage - 1](x)
        x = net.convs[2 * stage + 1](net.convs[2 * stage](x))
        out.append(x)
    return out


def test_benchnet_matches_jax():
    voxels, coors, shape = TB.synthetic_scan(0, shape=SHAPE, n_target=1600)
    assert voxels.shape == (1600, 3) and list(shape) == list(SHAPE)
    jnet = JB.BenchNet(SHAPE)
    tnet = TB.BenchNet(SHAPE)
    load_jax_state_dict(tnet, state_dict(jnet))
    j_stages = _jax_stages(jnet, JB.make_bench_input(voxels, coors, SHAPE))
    with torch.no_grad():
        t_stages = tnet.forward_stages(
            TB.make_bench_input(voxels, coors, SHAPE))

    counts = []
    for j, t in zip(j_stages, t_stages):
        assert t.spatial_shape == tuple(j.spatial_shape)
        assert t.keys_sorted
        np.testing.assert_array_equal(t.indices.numpy(),
                                      np.asarray(j.indices))
        assert int(t.num_voxels) == int(j.num_voxels)
        ref = np.asarray(j.features)
        got = t.features.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        counts.append(int(t.num_voxels))
    assert counts[0] == 1600 and counts[-1] > 0
    assert list(t_stages[-1].features.shape[1:]) == [256]

    # a surface, not dust: most voxels see several of their 26 neighbours
    assert TB.matched_offsets_per_voxel(t_stages[0], "c0") > 5.0

    # the calibrated pool buffers hold every stage without truncation
    bounds = TB.measure_pool_bounds(SHAPE, TB.make_bench_input(
        voxels, coors, SHAPE))
    assert all(b >= n for b, n in zip(bounds, counts[1:]))
    with torch.no_grad():
        bounded = TB.BenchNet(SHAPE, pool_bounds=bounds).forward_stages(
            TB.make_bench_input(voxels, coors, SHAPE))
    for t, b in zip(bounded, t_stages):
        assert int(t.num_voxels) == int(b.num_voxels)
