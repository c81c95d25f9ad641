"""The bf16 wgrad kernel's tile variants and row splits
(``ops/dg_conv.py::wgrad_variant``), chosen on the host from the shapes,
pinned at every wgrad launch of the configurations that train; the MMA rows
the kernel issues per matched pair; and the weight gradient at narrow
widths against the JAX package's in interpret mode on the CPU.

The row counts are the buffers ``chip_smoke.py`` runs: BenchNet's stage
buffers on ``basic.synthetic_scan(0)`` (pool bounds calibrated on seed 0),
the U-Net's and the ``docs/USAGE.md`` chain's on
``centerpoint.synthetic_centerpoint_input(0)`` (113,000 voxels in 113,664
rows; bounds calibrated in f32 on seed 0).  A wgrad runs over the rows of
its conv's input ``x``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv as jax_dg_subm_conv

from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD

from test_torch_dg_conv import (DIL, KSIZE, KV, SHAPE, _jax_plans,
                                _port_pos, _port_pos_to_jax, _sorted_input)

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100
WAVE = 132            # the H100's SMs
SCRATCH = 64 << 20    # bytes of f32 partials, at most

# BenchNet: the stage buffers (input, then the six calibrated pools)
_BENCH_N = (125_952, 62_464, 28_160, 11_776, 4_608, 2_048, 512)
# the CenterPoint scan's rows and its first two downsamples' buffers (the
# U-Net's stages), and the chain's strided output
_CP_N = (113_664, 112_128, 56_320)
_CHAIN_DOWN = 111_744


def _launches():
    """(config, layer, path, N rows of x, C, K, kv) of every wgrad launch a
    training step runs."""
    ch = TB.CHANNELS
    out = [("bench", f"conv{layer}", "subm", _BENCH_N[layer // 2],
            ch[layer], ch[layer + 1], 27) for layer in range(14)]
    n0, n1, n2 = _CP_N
    out += [  # SparseUNet(5, (16, 32, 64), 16)
        ("unet", "enc_subm.0", "subm", n0, 5, 16, 27),
        ("unet", "enc_subm.1", "subm", n1, 32, 32, 27),
        ("unet", "enc_subm.2", "subm", n2, 64, 64, 27),
        ("unet", "dec_subm.0", "subm", n1, 64, 32, 27),
        ("unet", "dec_subm.1", "subm", n0, 32, 16, 27),
        ("unet", "enc_down.0", "strided", n0, 16, 32, 27),
        ("unet", "enc_down.1", "strided", n1, 32, 64, 27),
        ("unet", "dec_up.0", "inverse", n2, 64, 32, 27),
        ("unet", "dec_up.1", "inverse", n1, 32, 16, 27),
    ]
    out += [  # SubMConv3d(32, 64) -> SparseConv3d(64, 128, s2) ->
        # SparseInverseConv3d(128, 64) -> SparseConvTranspose3d(64, 32, 2, s2)
        ("chain", "subm", "subm", n0, 32, 64, 27),
        ("chain", "down", "strided", n0, 64, 128, 27),
        ("chain", "up", "inverse", _CHAIN_DOWN, 128, 64, 27),
        ("chain", "deconv", "transposed", n0, 64, 32, 8),
    ]
    return out


_LAUNCHES = _launches()


def test_every_wgrad_launch_of_the_training_configurations_is_listed():
    """BenchNet's 14, the U-Net's 5 subm + 2 strided + 2 inverse, the
    chain's 1 + 1 + 1 + 1 (its input needs no gradient, its weights do)."""
    count = {}
    for cfg, _, path, *_ in _LAUNCHES:
        count[(cfg, path)] = count.get((cfg, path), 0) + 1
    assert count == {("bench", "subm"): 14, ("unet", "subm"): 5,
                     ("unet", "strided"): 2, ("unet", "inverse"): 2,
                     ("chain", "subm"): 1, ("chain", "strided"): 1,
                     ("chain", "inverse"): 1, ("chain", "transposed"): 1}


@pytest.mark.parametrize("cfg,layer,path,n,c,k_out,kv", _LAUNCHES,
                         ids=[f"{s[0]}-{s[1]}" for s in _LAUNCHES])
def test_wgrad_variant_at_every_launch(cfg, layer, path, n, c, k_out, kv):
    """The shared memory fits; the scalar gather exactly where the rows
    are not 16-byte vectors; the grid covers each ``dW[k]`` once (channel
    and column tiles over C and K, one offset a grid row, splits over all
    rows, the last ones possibly empty); the partials stay within 64 MB;
    the splits match ``wgrad_splits``."""
    for aligned in (True, False):
        v = TD.wgrad_variant(n, c, k_out, kv, aligned=aligned,
                             dout_aligned=not aligned)
        bm, bn = TD.WGRAD_TILES[v.tile][:2]
        assert (v.bm, v.bn) == (bm, bn)
        assert TD.wgrad_smem_bytes(v.tile) <= SMEM_LIMIT
        assert v.vec == (aligned and c % 8 == 0)
        assert v.dvec == (not aligned and k_out % 8 == 0)
        tiles, offsets, splits = v.grid
        ct, nt = -(-c // bm), -(-k_out // bn)
        assert tiles == ct * nt and offsets == kv
        assert (ct - 1) * bm < c <= ct * bm and (nt - 1) * bn < k_out <= nt * bn
        rows = TD.wgrad_rows_per_split(n, splits)
        # every row in one split; the last splits may be empty
        assert rows % 32 == 0 and splits * rows >= n
        assert rows - 32 < -(-n // splits)
        assert splits == 1 or splits * kv * c * k_out * 4 <= SCRATCH
        assert splits == TD.wgrad_splits(n, kv, c, k_out)


# (N, C, K, kv) -> (BM, BN, splits), by name
_PINNED = {
    (125_952, 3, 64, 27): (16, 64, 59),      # BenchNet conv0: C = 3, scalar
    (125_952, 64, 64, 27): (64, 64, 79),     # conv1
    (62_464, 64, 96, 27): (64, 128, 40),     # conv2: K = 96, 128 wide
    (62_464, 96, 96, 27): (128, 128, 20),    # conv3
    (11_776, 160, 160, 27): (128, 128, 5),   # conv7: 2 x 2 tiles
    (2_048, 224, 224, 27): (128, 128, 4),    # conv11
    (512, 256, 256, 27): (64, 128, 1),       # conv13: narrower, 216 blocks
    (113_664, 5, 16, 27): (16, 64, 59),      # U-Net enc_subm.0
    (112_128, 32, 32, 27): (32, 64, 59),     # U-Net enc_subm.1
    (111_744, 128, 64, 27): (128, 64, 40),   # the chain's inverse conv
    (113_664, 64, 32, 8): (64, 64, 222),     # the chain's transposed conv
}


@pytest.mark.parametrize("shape", sorted(_PINNED))
def test_wgrad_variant_pinned(shape):
    v = TD.wgrad_variant(*shape)
    assert (v.bm, v.bn, v.grid[2]) == _PINNED[shape]


@pytest.mark.parametrize("c", [3, 5, 12, 20, 8, 64, 160])
def test_wgrad_scalar_gather_exactly_when_rows_are_not_vectors(c):
    """x's gather: C % 8 != 0 or a pointer off 16 bytes takes the scalar
    gather; dout's the same with K."""
    assert TD.wgrad_variant(3072, c, 64).vec == (c % 8 == 0)
    assert not TD.wgrad_variant(3072, c, 64, aligned=False).vec
    assert TD.wgrad_variant(3072, 64, c).dvec == (c % 8 == 0)
    assert not TD.wgrad_variant(3072, 64, c, dout_aligned=False).dvec


def test_wgrad_tiles_follow_c_and_k():
    """BM is the narrowest of 16, 32, 64, 128 that covers C; BN 64 for K <=
    64, else 128; a wide tile narrows to 64 channels when a call has fewer
    blocks than a wave; past 128 the tiles repeat."""
    bm = [TD.wgrad_variant(10**5, c, 64).bm for c in (3, 16, 17, 32, 48, 64,
                                                       96, 128, 256)]
    assert bm == [16, 16, 32, 32, 64, 64, 128, 128, 128]
    assert [TD.wgrad_variant(10**5, 64, k).bn for k in (16, 64, 65, 256)] \
        == [64, 64, 128, 128]
    assert TD.wgrad_variant(10**5, 256, 256).grid[0] == 4
    small = TD.wgrad_variant(512, 256, 256)
    assert (small.bm, small.bn, small.grid) == (64, 128, (8, 27, 1))


def test_wgrad_smem_bytes_layout():
    """A ring of 4 stages of the ``[BJ, BM + 8]`` x chunk and the ``[BJ,
    BN + 8]`` dout chunk, then 1,024 listed pairs and 16 warp counts.  The
    blocks an SM holds at once, by registers (128 a thread: 512 threads)
    and by shared memory (228 KB, 1 KB of each block reserved): 3 of the
    16- and 32-channel tiles, 4 of the 64 x 64 one, 2 of the 256-thread
    ones, 1 of the 512-thread one."""
    assert TD.WGRAD_TILES[5] == (128, 128, 4, 4, 32)
    assert TD.wgrad_smem_bytes(5) == 4 * 32 * (136 + 136) * 2 + 8192 + 64
    assert TD.WGRAD_TILES[0] == (16, 64, 1, 4, 64)
    assert TD.wgrad_smem_bytes(0) == 4 * 64 * (24 + 72) * 2 + 8192 + 64
    resident = [min(512 // (32 * wm * wn),
                    228 * 1024 // (TD.wgrad_smem_bytes(t) + 1024))
                for t, (_, _, wm, wn, _) in enumerate(TD.WGRAD_TILES)]
    assert resident == [3, 3, 4, 2, 2, 1]
    # the splits aim at four waves of those blocks
    for n, c, k_out in ((125_952, 3, 64), (112_128, 32, 32),
                        (125_952, 64, 64), (62_464, 96, 96)):
        v = TD.wgrad_variant(n, c, k_out)
        assert v.grid[2] == -(-4 * WAVE * resident[v.tile] // (27 * v.grid[0]))


def test_wgrad_mma_rows_count_whole_slices_of_listed_rows():
    """Each (offset, split) block multiplies its matched rows in whole
    16-row slices, wherever in the split the rows lie."""
    pos = torch.full((2, 700), -1, dtype=torch.int32)
    pos[0, [0, 50, 699]] = 1
    pos[1, ::2] = 3
    s = TD.wgrad_splits(700, 2, 64, 64)
    assert s == 2 and TD.wgrad_rows_per_split(700, s) == 352
    # offset 0: 2 rows in split 0, 1 in split 1; offset 1: 176 and 174
    assert TD.wgrad_mma_rows(pos, 64, 64) == (16 + 16 + 176 + 176, 353)


def test_wgrad_mma_rows_at_benchnet_stage0_are_near_one_per_pair():
    """At BenchNet's stage 0 (``synthetic_scan(0)``, the reversed table)
    the listed rows leave at most 10 % padding; the kernel before them
    multiplied 2.36 rows per matched pair."""
    shape = (80, 1600, 1600)
    voxels, coors, _ = TB.synthetic_scan(0, shape, 125_562)
    x = TB.make_bench_input(voxels, coors, shape, device="cpu")
    keys, _ = TC.linearize(x.indices, x.spatial_shape, 1)
    rev = TD.build_dg_pos(keys, ksize=(3, 3, 3), dilation=(1, 1, 1),
                          spatial_shape=x.spatial_shape, batch_size=1,
                          reverse=True)
    for c, k_out in ((3, 64), (64, 64)):
        issued, pairs = TD.wgrad_mma_rows(rev, c, k_out)
        assert pairs == int((rev >= 0).sum()) > 10**6
        assert pairs <= issued <= 1.1 * pairs


@pytest.mark.parametrize("k_out", [16, 32])
def test_dg_wgrad_narrow_widths_match_jax(k_out):
    """The weight gradient at C = 3 and K = 16 or 32 (a 16-row dW tile,
    narrower than its 64-column one) through ``DGConvFn``'s plain path
    against ``jax.grad`` of the posmode Pallas conv (``_dg_bwd_kernel`` in
    interpret mode), bf16, within 1.6e-2*max|ref| (one bf16 rounding)."""
    c = 3
    feats, inds = _sorted_input(7, 700, c, 768)
    rng = np.random.RandomState(11)
    w = (rng.randn(k_out, *KSIZE, c) / np.sqrt(KV * c)).astype(np.float32)
    cot = rng.randn(768, k_out).astype(np.float32)
    pos_t = _port_pos(inds)
    keys_j, _ = JC.linearize(jnp.asarray(inds), SHAPE, 1)
    plans = _jax_plans(keys_j, 384)
    pos_j = _port_pos_to_jax(pos_t)

    def loss(ww):
        o = jax_dg_subm_conv(
            jnp.asarray(feats, jnp.bfloat16), keys_j, ww, spatial_shape=SHAPE,
            batch_size=1, dilation=DIL, window=384, plans=plans, pos=pos_j,
            interpret=True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(w, jnp.bfloat16))
                     .astype(jnp.float32))
    x = torch.from_numpy(feats).bfloat16()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    out = TD.dg_subm_conv(x, wt, pos_t, _port_pos(inds, reverse=True))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert wt.grad.dtype == torch.bfloat16 and wt.grad.shape == ref.shape
    np.testing.assert_allclose(wt.grad.float().numpy(), ref, rtol=0,
                               atol=1.6e-2 * np.abs(ref).max())


def test_wgrad_ablation_edits_apply_to_the_kernel_source():
    """``spconv_tpu_torch.tools.wgrad_ablation`` rebuilds
    ``csrc/dg_wgrad.cu`` with texts replaced; each must be in the source, so
    a change of the kernel that moves one fails here rather than on the
    card.  The counting build adds one count per k16 slice after the
    padding test, and its reader."""
    from spconv_tpu_torch.tools import ablation as AB
    from spconv_tpu_torch.tools import wgrad_ablation as A

    assert [name for name, _ in A.ABLATIONS] == ["as is", "no MMA",
                                                 "no copy"]
    for _, edits in A.ABLATIONS:
        src = AB.ablated_source("dg_wgrad.cu", edits)
        assert all(old not in src and new in src for old, new in edits)
    src = AB.ablated_source("dg_wgrad.cu", A.COUNT[1])
    assert src.count("atomicAdd(&slices_issued, 1ull)") == 1
    assert src.index("break;  // padding from here on") < src.index(
        "atomicAdd(&slices_issued")
    assert src.count('extern "C" int dg_wgrad_slices_issued(') == 1
    with pytest.raises(RuntimeError, match="holds no"):
        AB.ablated_source("dg_wgrad.cu", [("no such text", "")])
