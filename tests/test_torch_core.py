"""Core types, coordinates, checkpoints and the refusals of the PyTorch
port, held against the JAX package where both have the function."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC

import spconv_tpu_torch as st
from spconv_tpu_torch import SparseConvTensor, SubMConv3d
from spconv_tpu_torch.checkpoint import load_jax_state_dict
from spconv_tpu_torch.ops import coords as TC

from utils import generate_sparse_data

REPO = Path(__file__).resolve().parents[1]


def _rows(seed, shape, n, batch, nbuf, c=3):
    rng = np.random.RandomState(seed)
    if np.prod(shape) > 1e6:
        # coordinates may repeat; drawing unique ones would be slow
        inds = np.stack([rng.randint(0, s, n * batch)
                         for s in (batch, *shape)], axis=1).astype(np.int32)
        feats = rng.randn(n * batch, c).astype(np.float32)
    else:
        feats, inds = generate_sparse_data(shape, n, c, batch_size=batch,
                                           rng=rng)
    fb = np.zeros((nbuf, c), np.float32)
    ib = np.full((nbuf, len(shape) + 1), -1, np.int32)
    fb[:len(inds)] = feats
    ib[:len(inds)] = inds
    perm = rng.permutation(nbuf)
    return fb[perm], ib[perm]


@pytest.mark.parametrize("shape,batch", [((11, 13, 17), 2), ((80, 1600, 1600), 1),
                                         ((25, 25), 3)])
def test_linearize_delinearize_match_jax(shape, batch):
    _, inds = _rows(0, shape, 300, batch, 1000)
    kj, sj = JC.linearize(jnp.asarray(inds), shape, batch)
    kt, stt = TC.linearize(torch.from_numpy(inds), shape, batch)
    assert kt.dtype == torch.int32 and stt == int(sj)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    valid = inds[:, 0] >= 0
    dj = JC.delinearize(kj, shape, jnp.asarray(valid))
    dt = TC.delinearize(kt, shape, torch.from_numpy(valid))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(dt.numpy(), inds)


def test_geometry_helpers_match_jax():
    for ks in [(3, 3, 3), (3, 1, 5), (2, 2)]:
        np.testing.assert_array_equal(TC.kernel_offsets(ks),
                                      JC.kernel_offsets(ks))
    args = ((80, 1600, 1600), (2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1))
    assert TC.get_conv_output_size(*args) == JC.get_conv_output_size(*args)


def test_huge_grid_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        TC.linearize(torch.zeros((4, 4), dtype=torch.int32),
                     (2048, 2048, 1024), 1)


def test_sort_by_key_sets_flag_and_order():
    shape = (7, 9, 11)
    feats, inds = _rows(1, shape, 200, 2, 512)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         shape, 2)
    assert not x.keys_sorted and int(x.num_voxels) == 400
    y = x.sort_by_key()
    keys, sent = TC.linearize(y.indices, shape, 2)
    assert y.keys_sorted and (keys[1:] >= keys[:-1]).all()
    assert (keys[400:] == sent).all()
    order = np.argsort(np.asarray(TC.linearize(x.indices, shape, 2)[0]),
                       kind="stable")
    np.testing.assert_array_equal(y.features.numpy(), feats[order])
    s = y.shadow_copy()
    s.indice_dict["k"] = 1
    assert "k" not in y.indice_dict and s.features is y.features


def test_load_jax_state_dict_carries_weights_and_is_strict():
    import spconv_tpu
    from spconv_tpu.checkpoint import state_dict

    sd = state_dict(spconv_tpu.SparseSequential(
        spconv_tpu.SubMConv3d(3, 8, 3, indice_key="a"),
        spconv_tpu.SubMConv3d(8, 4, 3, bias=False, indice_key="a")))
    tnet = st.SparseSequential(SubMConv3d(3, 8, 3, indice_key="a"),
                               SubMConv3d(8, 4, 3, bias=False,
                                          indice_key="a"))
    # the JAX container names its layers "layers.i"; the port keeps the
    # key set of its own module, so map the prefix once
    sd = {k.replace("layers.", ""): v for k, v in sd.items()}
    assert set(sd) == {"0.weight", "0.bias", "1.weight"}
    load_jax_state_dict(tnet, sd)
    for k, v in tnet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    with pytest.raises(KeyError, match="missing"):
        load_jax_state_dict(tnet, {k: v for k, v in sd.items()
                                   if k != "0.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state_dict(tnet, {**sd, "2.weight": sd["1.weight"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_state_dict(tnet, {**sd, "0.bias": np.zeros(9, np.float32)})
    partial = {"1.weight": np.ones_like(sd["1.weight"])}
    load_jax_state_dict(tnet, partial, strict=False)
    assert (tnet[1].weight == 1).all()


def test_unported_paths_raise():
    shape = (7, 9, 11)
    feats, inds = _rows(2, shape, 100, 1, 128)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         shape, 1)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="key-sorted"):
            SubMConv3d(3, 4, 3)(x)
        for algo in ("native", "sk"):
            with pytest.raises(NotImplementedError, match="ROADMAP A4-A5"):
                SubMConv3d(3, 4, 3, algo=algo)(x.sort_by_key())
        # the 1x1 path needs no match table, sorted or not
        y = SubMConv3d(3, 4, 1)(x)
        assert not y.features[~x.valid_mask].any()
    for kw in (dict(subm=False, stride=2), dict(subm=False),
               dict(subm=True, transposed=True),
               dict(subm=True, inverse=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            st.SparseConvolution(3, 3, 4, 3, **kw)


def test_sequential_masks_dense_ops():
    shape = (7, 9, 11)
    feats, inds = _rows(3, shape, 100, 1, 128)
    x = SparseConvTensor(torch.from_numpy(feats), torch.from_numpy(inds),
                         shape, 1).sort_by_key()
    net = st.SparseSequential(SubMConv3d(3, 4, 3, indice_key="a"),
                              torch.nn.Sigmoid())
    with torch.no_grad():
        y = net(x)
    assert len(net) == 2 and isinstance(net[1], torch.nn.Sigmoid)
    assert not y.features[~y.valid_mask].any()
    assert (y.features[y.valid_mask] > 0).all()


def test_import_needs_no_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import spconv_tpu_torch, spconv_tpu_torch.benchmark.basic; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'spconv_tpu.'))"
            " for m in sys.modules if sys.modules[m] is not None)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
