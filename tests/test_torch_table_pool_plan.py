"""The host plans of the match-table kernel (B1, ``csrc/dg_pos.cu``) and
the sorted-key pool (B6, ``csrc/sk_pool.cu``), and their plain versions
against the JAX package at the edge inputs of
``spconv_tpu_torch/tools/table_cases.py`` (the card tests hold each kernel
against its plain version at the same inputs).

The plans are pinned at every launch of the five configurations that
``chip_smoke.py`` runs: BenchNet's seven stages, CenterPoint's subm and
affine tables, the U-Net's divide tables, the decoder chain's tables and
the six BenchNet pools.  The pools are held against the JAX
``sk_pool2_ad`` (interpret mode) here, the tables against the JAX package
in ``test_torch_table_edges.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import sorted_pool as TS
from spconv_tpu_torch.tools import table_count as TCN
from spconv_tpu_torch.tools.table_cases import (POOL_CASES, pool_case,
                                                table_case)

from test_torch_sk_pool import F32_MEAN_TOL, _jax_sk, _out_shape, _port_keys

# the SMs of the H100 SXM the plans are pinned for
SMS = 132

# (label, rows, ksize, stride, divide) -> (tile, groups a pass, passes,
# pool, sort, smem bytes, grid): every B1 launch of the five
# configurations (rows as chip_smoke.py's runs give them); tile 0 is the
# direct path
B1_LAUNCHES = {
    "benchnet_s0": ((125952, (3, 3, 3), None, False),
                    (128, 3, 1, 4096, False, 22324, 984)),
    "benchnet_s1": ((62464, (3, 3, 3), None, False),
                    (128, 3, 1, 4096, False, 22324, 488)),
    "benchnet_s2": ((28160, (3, 3, 3), None, False),
                    (64, 3, 1, 4096, False, 19508, 440)),
    "benchnet_s3": ((11776, (3, 3, 3), None, False),
                    (32, 3, 1, 4096, False, 18100, 368)),
    "benchnet_s4": ((4608, (3, 3, 3), None, False),
                    (0, 0, 0, 0, False, 0, 486)),
    "benchnet_s5": ((2048, (3, 3, 3), None, False),
                    (0, 0, 0, 0, False, 0, 216)),
    "benchnet_s6": ((512, (3, 3, 3), None, False),
                    (0, 0, 0, 0, False, 0, 54)),
    "cp_subm0": ((113664, (3, 3, 3), None, False),
                 (128, 3, 1, 4096, False, 22324, 888)),
    "cp_subm1": ((112128, (3, 3, 3), None, False),
                 (128, 3, 1, 4096, False, 22324, 876)),
    "cp_subm2": ((56320, (3, 3, 3), None, False),
                 (128, 3, 1, 4096, False, 22324, 440)),
    "cp_subm3": ((23040, (3, 3, 3), None, False),
                 (64, 3, 1, 4096, False, 19508, 360)),
    "cp_down1": ((112128, (3, 3, 3), (2, 2, 2), False),
                 (128, 3, 1, 4096, False, 22324, 876)),
    "cp_down2": ((56320, (3, 3, 3), (2, 2, 2), False),
                 (128, 3, 1, 4096, False, 22324, 440)),
    "cp_down3": ((23040, (3, 3, 3), (2, 2, 2), False),
                 (64, 3, 1, 4096, False, 19508, 360)),
    "cp_out": ((20992, (3, 1, 1), (2, 1, 1), False),
               (0, 0, 0, 0, False, 0, 246)),
    "unet_divide0": ((113664, (3, 3, 3), (2, 2, 2), True),
                     (128, 3, 1, 4096, True, 36148, 888)),
    "unet_divide1": ((112128, (3, 3, 3), (2, 2, 2), True),
                     (128, 3, 1, 4096, True, 36148, 876)),
    "chain_affine": ((111744, (3, 3, 3), (2, 2, 2), False),
                     (128, 3, 1, 4096, False, 22324, 873)),
    "chain_divide": ((113664, (3, 3, 3), (2, 2, 2), True),
                     (128, 3, 1, 4096, True, 36148, 888)),
    "chain_divide_transposed": ((1039616, (2, 2, 2), (2, 2, 2), True),
                                (128, 2, 1, 4096, True, 25892, 8122)),
    "chain_affine_transposed": ((113664, (2, 2, 2), (2, 2, 2), False),
                                (128, 2, 1, 4096, False, 21796, 888)),
}

# (parents, channels, itemsize) -> (tile, lanes, threads, vec, pool, smem
# bytes, grid): the six BenchNet pools, bf16 and f32
B6_LAUNCHES = {
    "pool0_bf16": ((62464, 64, 2), (128, 8, 256, True, 2048, 17700, 488)),
    "pool0_f32": ((62464, 64, 4), (128, 16, 256, True, 2048, 17700, 488)),
    "pool1_bf16": ((28160, 96, 2), (128, 16, 256, True, 2048, 17700, 220)),
    "pool1_f32": ((28160, 96, 4), (128, 32, 256, True, 2048, 17700, 220)),
    "pool2_bf16": ((11776, 128, 2), (64, 16, 256, True, 2048, 13092, 184)),
    "pool2_f32": ((11776, 128, 4), (64, 32, 256, True, 2048, 13092, 184)),
    "pool3_bf16": ((4608, 160, 2), (32, 32, 256, True, 2048, 10788, 144)),
    "pool3_f32": ((4608, 160, 4), (32, 32, 256, True, 2048, 10788, 144)),
    "pool4_bf16": ((2048, 192, 2), (8, 32, 256, True, 2048, 9060, 256)),
    "pool4_f32": ((2048, 192, 4), (8, 32, 256, True, 2048, 9060, 256)),
    "pool5_bf16": ((512, 224, 2), (8, 32, 256, True, 2048, 9060, 64)),
    "pool5_f32": ((512, 224, 4), (8, 32, 256, True, 2048, 9060, 64)),
}


@pytest.mark.parametrize("label", list(B1_LAUNCHES))
def test_b1_plan_at_every_launch(label):
    """The tile, groups a pass, pool, shared memory and grid of every B1
    launch: the direct path at the small tables, else at least two blocks
    an SM where the rows allow it, at most one block's shared memory,
    every group in one pass, the rows sorted by residue class only in
    divide mode with a stride."""
    (n, ksize, stride, divide), want = B1_LAUNCHES[label]
    plan = TD.b1_plan(n, ksize, stride, divide, sms=SMS)
    assert tuple(plan) == want
    if plan.tile == 0:  # the direct path
        assert n * int(np.prod(ksize)) <= TD.B1_DIRECT
        return
    assert plan.smem <= TD.SMEM_MAX and plan.pool == TD.B1_POOL
    assert plan.grid == -(-n // plan.tile)
    assert plan.grid >= 2 * SMS or plan.tile == TD.B1_TILES[-1]
    assert plan.groups * plan.passes >= int(np.prod(ksize[:-2]))
    assert plan.sort == (divide and stride is not None
                         and int(np.prod(stride)) > 1)


def test_b1_plan_takes_the_direct_path_for_small_tables():
    """At most ``B1_DIRECT`` (row, offset) probes take the direct path
    (tile 0, one thread a probe); more, the windowed one; the windowed plan
    of a small table stays available for the tests and the card's
    checks."""
    small = TD.b1_plan(4608, (3, 3, 3), sms=SMS)
    assert small.tile == 0 and small.grid == -(-4608 * 27 // 256)
    assert TD.b1_plan(4855, (3, 3, 3), sms=SMS).tile == 32
    assert TD.b1_window_plan(4608, (3, 3, 3), sms=SMS).tile == 32
    windows = TCN.b1_windows(torch.zeros(8, dtype=torch.int32),
                             torch.zeros(8, dtype=torch.int32),
                             TD.TableGeom.subm((3, 3, 3), (1, 1, 1),
                                               (4, 4, 4)), 64, small)
    assert tuple(windows.shape) == (0, 3)
    assert TCN.b1_fallbacks(windows, small, 10**6) == (0, 0)


def test_b1_plan_splits_passes_and_opts_in():
    """A divide table stages its results: a kernel whose groups do not fit
    in 48 KB takes several passes, smaller tiles before the opt-in, and
    one whose line does not fit at all is refused."""
    plan = TD.b1_plan(200_000, (5, 5, 5), (2, 2, 2), True, sms=SMS)
    assert plan.passes > 1 and plan.groups * plan.passes >= 5
    assert plan.smem <= 48 << 10
    big = TD.b1_plan(200_000, (3, 31, 31), (2, 2, 2), True, sms=SMS)
    assert big.tile == 32 and big.groups == 1 and big.passes == 3
    assert 48 << 10 < big.smem <= TD.SMEM_MAX
    with pytest.raises(ValueError, match="does not fit"):
        TD.b1_plan(200_000, (3, 64, 64), (2, 2, 2), True, sms=SMS)
    # without staged results every group fits in one pass
    assert TD.b1_plan(200_000, (7, 7, 7), sms=SMS).passes == 1


@pytest.mark.parametrize("label", list(B6_LAUNCHES))
def test_b6_plan_at_every_pool(label):
    """The tile, lanes, threads, pool and grid of each BenchNet pool:
    lanes cover a row's 16-byte chunks, a pool launches a block an SM or
    full 256-thread blocks, and the shared memory fits without the
    opt-in."""
    (m, c, itemsize), want = B6_LAUNCHES[label]
    plan = TS.b6_plan(m, c, itemsize, 3, sms=SMS)
    assert tuple(plan) == want
    chunks = c * itemsize // 16
    assert plan.lanes >= min(32, chunks) and plan.threads % 32 == 0
    assert plan.grid >= SMS or plan.threads == 256
    assert plan.smem <= 48 << 10


def test_b6_plan_takes_the_scalar_path():
    """C that does not fill 16-byte chunks, or features that are not
    16-byte aligned, take one channel a lane."""
    assert not TS.b6_plan(5000, 12, 2, 3, sms=SMS).vec
    assert TS.b6_plan(5000, 12, 4, 3, sms=SMS).vec
    assert not TS.b6_plan(5000, 64, 2, 3, aligned=False, sms=SMS).vec
    assert TS.b6_plan(5000, 6, 4, 3, sms=SMS).lanes == 8
    # a late pool keeps full blocks rather than more of them
    assert TS.b6_plan(512, 224, 2, 3, sms=SMS).tile == 8


def _keys(inds, shape, batch):
    return TC.linearize(torch.from_numpy(inds), shape, batch)[0]


def _b1_windows(name, tg_of, kernel):
    """``(windows, (fallen back, not sampled))`` of B1's windowed plan at
    table edge input ``name``: ``tg_of(shape)`` the table's geometry,
    searched in the case's own keys."""
    inds, shape, batch, _, _ = table_case(name)
    keys = _keys(inds, shape, batch)
    tg = tg_of(shape)
    plan = TD.b1_window_plan(keys.shape[0], kernel, tg.stride, tg.divide,
                             sms=SMS)
    windows = TCN.b1_windows(keys, keys, tg, TC.grid_sentinel(shape, batch),
                             plan)
    return windows, TCN.b1_fallbacks(windows, plan, keys.shape[0])


def _b6_windows(name, itemsize=4):
    """``(windows, (fallen back, not sampled))`` of B6's children at pool
    edge input ``name``: B1's affine table with kernel 2 and stride 2 on
    B6's plan, one pass of ``2**(ndim - 2)`` groups."""
    _, inds, shape, batch = pool_case(name)
    ndim = len(shape)
    in_keys, out_keys = _port_keys(inds, shape, batch, inds.shape[0])
    plan = TS.b6_plan(out_keys.shape[0], POOL_CASES[name][-1], itemsize,
                      ndim, sms=SMS)
    tg = TD.TableGeom.regular(False, ksize=(2,) * ndim, stride=(2,) * ndim,
                              padding=(0,) * ndim, dilation=(1,) * ndim,
                              in_shape=shape, out_shape=_out_shape(shape))
    b1 = TD.B1Plan(plan.tile, 2 ** max(ndim - 2, 0), 1, plan.pool, False,
                   plan.smem, plan.grid)
    windows = TCN.b1_windows(out_keys, in_keys, tg,
                             TC.grid_sentinel(_out_shape(shape), batch), b1)
    return windows, TCN.b1_fallbacks(windows, b1, in_keys.shape[0],
                                     plan.threads)


def test_slab_windows_overflow_the_pool():
    """The slab's windows do not fit in B1's and B6's pools, so the card
    samples them there (``b1_fallbacks``, the host count
    the counting build's is held to); the benchmark-like random case takes
    none."""
    inds, shape, batch, subm, _ = table_case("slab")
    keys = _keys(inds, shape, batch)
    tg = TD.TableGeom.subm(*subm[0], shape)
    plan = TD.b1_plan(keys.shape[0], subm[0][0], sms=SMS)
    windows = TCN.b1_windows(keys, keys, tg,
                             TC.grid_sentinel(shape, batch), plan)
    assert tuple(windows.shape) == (plan.grid, 1)
    assert plan.tile > 0  # the windowed path
    # every block's but the last, which holds only sentinel rows; one
    # window a pass, so each keeps the whole pool for its sample
    assert TCN.b1_fallbacks(windows, plan, keys.shape[0]) == (
        int((windows > 4096).sum()), 0)
    assert int((windows > 4096).sum()) == plan.grid - 1
    _, counts = _b1_windows("batch_tail", lambda shape: TD.TableGeom.subm(
        (3, 3, 3), (1, 1, 1), shape), (3, 3, 3))
    assert counts == (0, 0)
    # the pool slab: its children's windows against B6's pool
    assert _b6_windows("slab")[1][0] > 0


@pytest.mark.parametrize("mode", ["subm", "subm_reversed", "affine",
                                  "divide"])
def test_b1_full_pool_leaves_windows_unsampled(mode):
    """At the "full_pool" input a block's first fitting window holds
    exactly B1's pool, so the windows after it that do not fit get no
    sample (the kernel searches them in global memory from the start)
    rather than one past the pool: the host count of such windows is above
    0 in every mode."""
    ksize, one = (3, 3, 3), (1, 1, 1)
    if mode.startswith("subm"):
        tg_of = lambda shape: TD.TableGeom.subm(  # noqa: E731
            ksize, one, shape, mode == "subm_reversed")
    else:
        tg_of = lambda shape: TD.TableGeom.regular(  # noqa: E731
            mode == "divide", ksize=ksize, stride=one, padding=one,
            dilation=one, in_shape=shape, out_shape=shape)
    windows, (fell, unsampled) = _b1_windows("full_pool", tg_of, ksize)
    assert fell >= unsampled > 0
    full = torch.tensor([0, 4096, 4096] if mode in ("subm", "affine")
                        else [4096, 4096, 0])
    assert (windows == full).all(1).any()


@pytest.mark.parametrize("itemsize", [4, 2])
def test_b6_full_pool_leaves_windows_unsampled(itemsize):
    """At the pool "full_pool" input each block's first window holds
    exactly B6's pool (128 parents a tile in f32 and bf16), so its second
    gets no sample."""
    windows, (fell, unsampled) = _b6_windows("full_pool", itemsize)
    assert fell == unsampled > 0
    assert (windows == torch.tensor([2048, 2048])).all(1).sum() == unsampled


def test_plans_follow_the_sm_count():
    """The B1 and B6 tiles are sized by the card's SMs: fewer SMs keep a
    larger tile where the grid still gives two B1 blocks (one B6 block)
    an SM."""
    assert TD.b1_plan(28160, (3, 3, 3), sms=SMS).tile == 64
    assert TD.b1_plan(28160, (3, 3, 3), sms=100).tile == 128
    assert TS.b6_plan(11776, 128, 2, 3, sms=SMS).tile == 64
    assert TS.b6_plan(11776, 128, 2, 3, sms=90).tile == 128
    # the sweep's tile override (tools/b6_tiles.py)
    swept = TS.b6_plan(11776, 128, 2, 3, sms=SMS, tile=16)
    assert swept.tile == 16 and swept.grid == 736 and swept.threads == 256
    for sms in (78, 114, 132):
        plan = TD.b1_plan(62464, (3, 3, 3), sms=sms)
        assert plan.grid >= 2 * sms and plan.tile == 128


@pytest.mark.parametrize("mode", ["max", "mean"])
@pytest.mark.parametrize("name", list(POOL_CASES))
def test_edge_pools_match_jax(name, mode):
    """``sk_pool2`` (B6's plain version on the CPU) against the JAX
    ``sk_pool2_ad`` (interpret mode) at each pool edge input, f32: max
    exact, mean within ``F32_MEAN_TOL`` of max|ref|."""
    feats, inds, shape, batch = pool_case(name)
    bound = inds.shape[0]
    in_keys, out_keys = _port_keys(inds, shape, batch, bound)
    got = TS.sk_pool2(torch.from_numpy(feats), in_keys, out_keys,
                      in_shape=shape, out_shape=_out_shape(shape),
                      batch_size=batch, mode=mode).numpy()
    ref = np.asarray(_jax_sk(feats, inds, shape, batch, bound, mode)(
        jnp.asarray(feats)))
    live = out_keys.numpy() != int(np.prod(_out_shape(shape))) * batch
    assert live.any() and not got[~live].any()
    if mode == "max":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=F32_MEAN_TOL * np.abs(ref).max())


def test_table_count_edits_apply_to_the_kernel_source():
    """The counting build's edits (``tools/table_count.py``'s ``COUNT``)
    each find their text once in ``csrc/dg_pos.cu``, so the build counts
    what the kernel's search returns."""
    from spconv_tpu_torch._build import SRC_DIR
    from spconv_tpu_torch.tools.ablation import ablated_source

    src = (SRC_DIR / "dg_pos.cu").read_text()
    for old, _ in TCN.COUNT[1]:
        assert src.count(old) == 1, old
    assert "windows_fallen_back" in ablated_source("dg_pos.cu",
                                                   TCN.COUNT[1])
