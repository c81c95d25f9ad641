"""The probe kernels' plain versions (``spconv_tpu_torch.ops.probes``, B9)
and the probe scripts (``spconv_tpu_torch.tools``) on the CPU, against the
numpy references their Pallas probes in ``tools/`` check against, and
``probe_sk``'s subm conv against the JAX package's search-mode conv.

The ``tools/`` scripts run their cases at import or keep their kernels
inside ``main()``, so their references are copied here.  The CUDA kernels
are held against these plain versions in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv as jax_dg_subm_conv

from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import probes as P
from spconv_tpu_torch.tools import (probe_cast, probe_dg, probe_dma_align,
                                    probe_int8, probe_sk)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel may launch."""
    P.reset_launch_counts()
    TD.reset_launch_counts()
    yield
    assert not any(P.launch_counts.values())
    assert not any(TD.launch_counts.values())


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mult", [32, 8, 4, 1])
def test_copy_rows_int8_matches_probe_dma(mult):
    """``tools/probe_int8.py::probe_dma``: 64 rows at ``3 * mult`` of an int8
    [4096, 128] table, widened to int32."""
    x = (np.arange(4096 * 128).reshape(4096, 128) % 117 - 58).astype(np.int8)
    st = mult * 3
    out = P.copy_rows(*_t(x, np.array([st], np.int32)), 64)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  x[st:st + 64].astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32,
                                   torch.float32])
def test_copy_rows_matches_probe_dma_align(dtype):
    """``tools/probe_dma_align.py``: 64 rows at ``3 * mult`` for every
    multiple it probes; rows past the table give 0; a start times a scale
    plus an offset (``tools/probe_dg.py``'s chunk copy)."""
    x = torch.from_numpy(np.arange(4096 * 128).reshape(4096, 128) % 977
                         ).to(dtype)
    for mult in (128, 32, 16, 8, 1):
        st = torch.tensor([mult * 3], dtype=torch.int32)
        assert torch.equal(P.copy_rows(x, st, 64),
                           x[mult * 3:mult * 3 + 64])
    tail = P.copy_rows(x, torch.tensor([4090], dtype=torch.int32), 8)
    assert torch.equal(tail[:6], x[4090:]) and not tail[6:].any()
    assert torch.equal(P.copy_rows(x, torch.tensor([5], dtype=torch.int32),
                                   16, scale=16, off=16), x[96:112])


def test_transpose_and_gathers_match_probe_dg():
    """``tools/probe_dg.py``'s ``kt``, ``k``, ``ki`` and ``ks``: the
    transpose, the per-row lane gather (``np.take_along_axis``, f32 and
    int32; an index outside the row gives 0) and the row broadcast."""
    rs = np.random.RandomState(0)
    a = rs.rand(128, 96).astype(np.float32)
    np.testing.assert_array_equal(P.transpose(*_t(a)).numpy(), a.T)
    for x in (rs.rand(32, 128).astype(np.float32),
              rs.randint(-2**30, 2**30, (16, 128)).astype(np.int32)):
        idx = rs.randint(0, 128, x.shape).astype(np.int32)
        np.testing.assert_array_equal(P.lane_gather(*_t(x, idx)).numpy(),
                                      np.take_along_axis(x, idx, 1))
    idx[0, :3] = (-1, 128, 5)
    out = P.lane_gather(*_t(x, idx)).numpy()
    assert (out[0, :2] == 0).all() and out[0, 2] == x[0, 5]
    x = rs.rand(8, 128).astype(np.float32)
    np.testing.assert_array_equal(P.row_broadcast(*_t(x), 3, 4.0, 8).numpy(),
                                  np.broadcast_to(x[3:4] * 4, (8, 128)))


@pytest.mark.parametrize("table_dtype", [np.int8, np.float32])
def test_keyed_sum_matches_one_hot_product(table_dtype):
    """``tools/probe_int8.py::probe_matmul`` and ``tools/probe_cast.py``:
    the one-hot product ``onehot(probes == keys) @ table``, int8 -> int32
    and f32 exactly (two matched rows a probe, unmatched probes 0); the
    plain version needs no sorted keys."""
    rs = np.random.RandomState(1)
    t, w, c = (128, 256, 128) if table_dtype == np.int8 else (256, 1024, 64)
    kt = (np.arange(t) * 3).astype(np.int32)
    wk = (np.arange(w) // 2 * 2).astype(np.int32)
    table = (rs.randint(-127, 127, (w, c)) if table_dtype == np.int8
             else rs.randn(w, c)).astype(table_dtype)
    acc = np.int32 if table_dtype == np.int8 else np.float32
    ref = (kt[:, None] == wk[None, :]).astype(acc) @ table.astype(acc)
    out = P.keyed_sum(*_t(kt, wk, table))
    assert out.dtype == torch.from_numpy(ref).dtype
    np.testing.assert_array_equal(out.numpy(), ref)
    perm = rs.permutation(w)
    np.testing.assert_array_equal(
        P.keyed_sum_plain(*_t(kt, wk[perm], table[perm])).numpy(), ref)


def test_lane_rank_and_gemm_match_probe_dg():
    """``tools/probe_dg.py``'s ``kr`` (the rank of each row's first lane,
    broadcast) and the gemms: int8 exactly, bf16 within the probe's
    ``rtol=2e-2`` and exactly the bf16-rounded product in f32."""
    rs = np.random.RandomState(2)
    keys = np.sort(rs.randint(0, 10_000, 128)).astype(np.int32)
    probes = rs.randint(0, 10_000, (16, 128)).astype(np.int32)
    want = (keys[None, :] < probes[:, :1]).sum(1, keepdims=True)
    np.testing.assert_array_equal(P.lane_rank(*_t(keys, probes)).numpy(),
                                  np.broadcast_to(want, (16, 128)))
    a = rs.randint(-127, 127, (128, 256)).astype(np.int8)
    b = rs.randint(-127, 127, (256, 128)).astype(np.int8)
    out = P.gemm(*_t(a, b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  a.astype(np.int32) @ b.astype(np.int32))
    a = rs.rand(128, 432).astype(np.float32)
    b = rs.rand(432, 128).astype(np.float32)
    out = P.gemm(*_t(a, b)).numpy()
    assert np.allclose(out, a @ b, rtol=2e-2)
    ta, tb = _t(a, b)
    np.testing.assert_allclose(
        out, (ta.bfloat16().double() @ tb.bfloat16().double()).numpy(),
        rtol=1e-5)


def test_probe_wrappers_refuse_bad_operands():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="start"):
        P.copy_rows(x, torch.tensor([1]), 4)
    with pytest.raises(ValueError, match="copy"):
        P.copy_rows(x.double(), torch.tensor([1], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="float32"):
        P.transpose(x.int())
    with pytest.raises(ValueError, match="idx"):
        P.lane_gather(x, torch.zeros((8, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="row"):
        P.row_broadcast(x, 8, 1.0, 4)
    with pytest.raises(ValueError, match="table"):
        P.keyed_sum(torch.zeros(4, dtype=torch.int32),
                    torch.zeros(8, dtype=torch.int32), x.double())
    with pytest.raises(ValueError, match="int32"):
        P.lane_rank(torch.zeros(8), torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="int8 or two float32"):
        P.gemm(x.to(torch.int8), torch.zeros((128, 4)))


def test_probe_main_runs_on_the_card_by_default(monkeypatch):
    """With no ``device`` a probe runs on the card, and without one it
    raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_dg.main()


@pytest.mark.parametrize("module,cases", [
    (probe_int8, 6), (probe_dma_align, 15), (probe_cast, 3),
    (probe_dg, 10)])
def test_probe_main_on_cpu(module, cases, capsys):
    """Each probe's ``main(device="cpu")`` runs every case of its Pallas
    probe through the plain versions and prints one OK line per case."""
    results = module.main(device="cpu")
    assert len(results) == cases and all(results.values()), results
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.endswith("OK") or ": OK" in ln]
    assert len(lines) == cases


def test_probe_sk_main_on_cpu(capsys):
    """``probe_sk``'s case on a small synthetic scan (kernel 3^3, C = K =
    64, bf16) through the port's search-mode subm conv, the function its
    ``main`` runs, against the JAX package's ``dg_subm_conv`` with no table
    (its search mode, in interpret mode) within 1.6e-2 of max|ref|; and
    ``main(device="cpu")`` prints its one OK line."""
    shape, n_target = (20, 80, 80), 2000
    feats, w, keys, grid = probe_sk.sk_case(torch.device("cpu"), shape,
                                            n_target)
    got = TD.dg_fwd_search(feats, w, keys,
                           TD.SearchGeom.of((3, 3, 3), (1, 1, 1), grid, 1))
    _, c, k = w.shape
    w_krsc = w.permute(2, 0, 1).reshape(k, 3, 3, 3, c)
    ref = np.asarray(jax_dg_subm_conv(
        jnp.asarray(feats.float().numpy(), jnp.bfloat16),
        jnp.asarray(keys.numpy()),
        jnp.asarray(w_krsc.float().numpy(), jnp.bfloat16),
        spatial_shape=grid, batch_size=1, dilation=(1, 1, 1), window=128,
        interpret=True), np.float32)
    scale = np.abs(ref).max()
    assert got.dtype == torch.bfloat16 and scale > 0
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=probe_sk.TOL * scale)
    results = probe_sk.main(device="cpu", shape=shape, n_target=n_target)
    assert list(results.values()) == [True]
    assert ": OK" in capsys.readouterr().out
