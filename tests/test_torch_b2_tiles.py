"""B2's bf16 tile variants (``ops/dg_conv.py::b2_variant``), chosen on the
host from the shapes, pinned at every gather-GEMM layer shape of the five
configurations the port runs; and the input gradient, whose bf16 kernel
now reads ``W[k]`` as it is, against its plain version and the JAX
package's din in interpret mode on the CPU.

The row counts are the buffers ``chip_smoke.py`` runs: BenchNet's stage
buffers on ``basic.synthetic_scan(0)`` (pool bounds calibrated on seed 0),
the CenterPoint encoder's, the U-Net's and the ``docs/USAGE.md`` chain's on
``centerpoint.synthetic_centerpoint_input(0)`` (113,000 voxels in 113,664
rows; bounds calibrated in f32 on seed 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops import coords as JC
from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv as jax_dg_subm_conv

from spconv_tpu_torch.benchmark import basic as TB
from spconv_tpu_torch.ops import dg_conv as TD

from test_torch_dg_conv import (DIL, KSIZE, KV, SHAPE, _jax_plans,
                                _port_pos, _port_pos_to_jax, _sorted_input)

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100
WAVE = 132            # the H100's SMs

# BenchNet: the stage buffers (input, then the six calibrated pools)
_BENCH_N = (125_952, 62_464, 28_160, 11_776, 4_608, 2_048, 512)
# CenterPoint: the input rows and the three downsamples' buffers; the
# output conv's (k 3x1x1, s 2x1x1)
_CP_N = (113_664, 112_128, 56_320, 23_040)
_CP_OUT = 20_992
# the chain's strided output and transposed output buffers
_CHAIN_N = (111_744, 1_039_616)


def _shapes():
    """(config, layer, path, N output rows, GEMM C, GEMM K) of every B2
    launch: the forwards, and the dgrads (C and K of the weight swapped)
    a training step runs."""
    ch = TB.CHANNELS
    out = []
    for layer in range(14):
        n = _BENCH_N[layer // 2]
        out.append(("bench", f"conv{layer}", "fwd", n, ch[layer],
                    ch[layer + 1]))
        if layer:  # the input features need no gradient
            out.append(("bench", f"conv{layer}", "dgrad", n, ch[layer + 1],
                        ch[layer]))
    widths = (16, 32, 64, 128)
    out.append(("cp", "conv_input", "fwd", _CP_N[0], 5, 16))
    for si, c in enumerate(widths):
        for j in range(4):
            out.append(("cp", f"subm{si}.{j}", "fwd", _CP_N[si], c, c))
    for si, (c, k) in enumerate(((16, 32), (32, 64), (64, 128))):
        out.append(("cp", f"down{si + 1}", "strided", _CP_N[si + 1], c, k))
    out.append(("cp", "out", "strided", _CP_OUT, 128, 128))
    n0, n1, n2 = _CP_N[:3]
    out += [  # SparseUNet(5, (16, 32, 64), 16)
        ("unet", "enc_subm.0", "fwd", n0, 5, 16),
        ("unet", "enc_down.0", "strided", n1, 16, 32),
        ("unet", "enc_subm.1", "fwd", n1, 32, 32),
        ("unet", "enc_down.1", "strided", n2, 32, 64),
        ("unet", "enc_subm.2", "fwd", n2, 64, 64),
        ("unet", "dec_up.0", "inverse", n1, 64, 32),
        ("unet", "dec_subm.0", "fwd", n1, 64, 32),
        ("unet", "dec_up.1", "inverse", n0, 32, 16),
        ("unet", "dec_subm.1", "fwd", n0, 32, 16),
        ("unet", "enc_subm.1", "dgrad", n1, 32, 32),
        ("unet", "enc_subm.2", "dgrad", n2, 64, 64),
        ("unet", "dec_subm.0", "dgrad", n1, 32, 64),
        ("unet", "dec_subm.1", "dgrad", n0, 16, 32),
        ("unet", "enc_down.0", "dgrad_strided", n0, 32, 16),
        ("unet", "enc_down.1", "dgrad_strided", n1, 64, 32),
        ("unet", "dec_up.0", "dgrad_inverse", n2, 32, 64),
        ("unet", "dec_up.1", "dgrad_inverse", n1, 16, 32),
    ]
    c_out, t_out = _CHAIN_N
    out += [  # SubMConv3d(32, 64) -> SparseConv3d(64, 128, s2) ->
        # SparseInverseConv3d(128, 64) -> SparseConvTranspose3d(64, 32, 2, s2)
        ("chain", "subm", "fwd", n0, 32, 64),
        ("chain", "down", "strided", c_out, 64, 128),
        ("chain", "up", "inverse", n0, 128, 64),
        ("chain", "deconv", "transposed", t_out, 64, 32),
        ("chain", "down", "dgrad_strided", n0, 128, 64),
        ("chain", "up", "dgrad_inverse", c_out, 64, 128),
        ("chain", "deconv", "dgrad_transposed", n0, 32, 64),
    ]
    return out


_SHAPES = _shapes()


def test_every_b2_launch_of_the_five_configurations_is_listed():
    """BenchNet's 14 forwards and 13 dgrads, CenterPoint's 17 + 4
    forwards, the U-Net's 9 forwards and 8 dgrads, the chain's 4 + 3."""
    count = {}
    for cfg, _, path, *_ in _SHAPES:
        kind = "dgrad" if path.startswith("dgrad") else "fwd"
        count[(cfg, kind)] = count.get((cfg, kind), 0) + 1
    assert count == {("bench", "fwd"): 14, ("bench", "dgrad"): 13,
                     ("cp", "fwd"): 21, ("unet", "fwd"): 9,
                     ("unet", "dgrad"): 8, ("chain", "fwd"): 4,
                     ("chain", "dgrad"): 3}


@pytest.mark.parametrize("cfg,layer,path,n,c,k_out", _SHAPES,
                         ids=[f"{s[0]}-{s[1]}-{s[2]}" for s in _SHAPES])
def test_b2_variant_at_every_layer_shape(cfg, layer, path, n, c, k_out):
    """The shared memory fits; the scalar gather exactly where C % 8 != 0
    or the features are misaligned; the tile covers K, or column tiles
    only past K = 256 or at an N too small to fill a wave at 64 rows a
    block; the grid covers the output once."""
    trans = path.startswith("dgrad")
    for aligned in (True, False):
        v = TD.b2_variant(n, c, k_out, aligned=aligned)
        assert (v.bm, v.bn) == TD.B2_TILES[v.tile][:2]
        assert TD.b2_smem_bytes(v.tile, trans) <= SMEM_LIMIT
        assert v.vec == (aligned and c % 8 == 0)
        assert v.grid == (-(-n // v.bm), -(-k_out // v.bn))
        if v.bn < k_out:
            assert k_out > 256 or -(-n // 64) < WAVE
        else:
            assert v.grid[1] == 1


# (N, C, K) -> the tile's (BM, BN), by name
_PINNED = {
    (125_952, 3, 64): (64, 64),       # BenchNet conv0: scalar gather
    (125_952, 64, 64): (64, 64),      # conv1
    (62_464, 64, 96): (64, 128),      # conv2: K = 96 on a 128-wide tile
    (11_776, 128, 160): (64, 256),    # conv6: all of K = 160 in one tile
    (4_608, 160, 192): (64, 128),     # conv8: 72 blocks at 256 wide
    (2_048, 192, 224): (64, 64),      # conv10: column tiles at a small N
    (512, 256, 256): (64, 64),        # conv13: 8 x 4 blocks
    (113_664, 5, 16): (128, 16),      # CenterPoint conv_input
    (112_128, 32, 32): (128, 32),     # CenterPoint subm1
    (23_040, 128, 128): (64, 128),    # CenterPoint subm3
    (1_039_616, 64, 32): (128, 32),   # the chain's transposed conv
    (3_072, 12, 320): (64, 128),      # past 256 columns, small N
    (200_000, 64, 320): (64, 256),    # past 256 columns: 2 column tiles
}


@pytest.mark.parametrize("shape", sorted(_PINNED))
def test_b2_variant_pinned(shape):
    v = TD.b2_variant(*shape)
    assert (v.bm, v.bn) == _PINNED[shape]


def test_b2_variant_column_tiles_past_256():
    """K = 320 at a large N: the widest tile and two column tiles."""
    v = TD.b2_variant(200_000, 64, 320)
    assert v.bn == 256 and v.grid == (3125, 2) and v.vec


@pytest.mark.parametrize("c", [3, 5, 12, 20, 8, 64, 160])
def test_b2_scalar_gather_exactly_when_rows_are_not_vectors(c):
    """C % 8 != 0 or a pointer off 16 bytes: the scalar gather; C % 8 ==
    0 and aligned: the 16-byte one."""
    assert TD.b2_variant(3072, c, 64).vec == (c % 8 == 0)
    assert not TD.b2_variant(3072, c, 64, aligned=False).vec


def test_b2_smem_bytes_layout():
    """A ring of 4 stages of the [BM, BK + 8] gather chunk and the weight
    chunk ([BK, BN + 8], or [BN, BK + 8] transposed), then 32 offsets' rows
    and 65 ints of lists: the widest tile is the largest; every variant
    fits two blocks on an SM (228 KB, 1 KB of each reserved)."""
    assert TD.B2_TILES[4] == (64, 256, 32)
    assert TD.b2_smem_bytes(4, False) == 4 * (64 * 80 + 32 * 264 * 2) \
        + (32 * 64 + 65) * 4
    assert TD.b2_smem_bytes(4, True) == 4 * (64 * 80 + 256 * 80) \
        + (32 * 64 + 65) * 4
    assert TD.B2_TILES[0] == (128, 16, 64)
    assert TD.b2_smem_bytes(0, True) == 4 * (128 * 144 + 16 * 144) \
        + (32 * 128 + 65) * 4
    sizes = [TD.b2_smem_bytes(t, tr) for t in range(len(TD.B2_TILES))
             for tr in (False, True)]
    assert max(sizes) == TD.b2_smem_bytes(4, True)
    assert 2 * (max(sizes) + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dg_dgrad_untransposed_weight_matches_plain_and_jax(dtype):
    """``dg_dgrad`` takes ``[kv, C, K]`` as it is (the bf16 kernel reads
    ``W[k]^T`` in place): on the CPU it is the plain version, and the din of ``jax.vjp`` of the
    posmode Pallas conv (``_dg_bwd_kernel`` in interpret mode) within
    5e-5 * max|ref| in f32 (sums in another order) and 1.6e-2 in bf16 (one
    bf16 rounding)."""
    c, k_out = 12, 24
    feats, inds = _sorted_input(2, 700, c, 768)
    rng = np.random.RandomState(4)
    w = (rng.randn(k_out, *KSIZE, c) / np.sqrt(KV * c)).astype(np.float32)
    cot = rng.randn(768, k_out).astype(np.float32)
    cot[700:] = 0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    rev = _port_pos(inds, reverse=True)
    weight_kv = TD.weight_krsc_to_kv(torch.from_numpy(w).to(tdt))
    dout = torch.from_numpy(cot).to(tdt)
    din = TD.dg_dgrad(dout, weight_kv, rev)
    assert din.dtype == tdt and tuple(din.shape) == (768, c)
    assert torch.equal(din, TD.dg_dgrad_plain(dout, weight_kv, rev))

    keys_j, _ = JC.linearize(jnp.asarray(inds), SHAPE, 1)
    plans = _jax_plans(keys_j, 384)
    pos_j = _port_pos_to_jax(_port_pos(inds))

    def conv(f):
        return jax_dg_subm_conv(
            f, keys_j, jnp.asarray(w, jdt), spatial_shape=SHAPE,
            batch_size=1, dilation=DIL, window=384, plans=plans, pos=pos_j,
            interpret=True)

    _, vjp = jax.vjp(conv, jnp.asarray(feats, jdt))
    ref = np.asarray(vjp(jnp.asarray(cot, jdt))[0].astype(jnp.float32))
    tol = 5e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(din.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    assert not din[700:].any()


def test_b2_ablation_edits_apply_to_the_kernel_source():
    """``spconv_tpu_torch.tools.b2_ablation`` rebuilds ``csrc/dg_fwd.cu``
    with lines replaced; each line must be in the source once, so a change
    of the kernel that moves one fails here rather than on the card."""
    from spconv_tpu_torch.tools import ablation as AB
    from spconv_tpu_torch.tools import b2_ablation as A

    assert [name for name, _ in A.ABLATIONS] == ["as is", "no MMA",
                                                 "no copy"]
    src = (AB.SRC_DIR / "dg_fwd.cu").read_text()
    for _, edits in A.ABLATIONS:
        assert all(src.count(old) == 1 for old, _ in edits)
        out = AB.ablated_source("dg_fwd.cu", edits)
        assert all(out.count(new) >= 1 for _, new in edits)


def test_b2_ablation_counts_issued_mma_rows():
    """The issued-row count of ``b2_ablation``: a tile multiplies all its
    rows at an offset where any of them matches; sorting rows by their
    match mask groups the rows that match alike."""
    from spconv_tpu_torch.tools.b2_ablation import issued_rows, mask_sorted

    m = np.zeros((27, 128), bool)
    m[0, :5] = True
    m[1, [3, 70]] = True
    assert issued_rows(m, 16) == 3 * 16 / 7  # offset 0: tile 0; 1: 0, 4
    assert issued_rows(m, 64) == 3 * 64 / 7
    s = mask_sorted(m)
    assert s.sum() == 7 and sorted(s.sum(axis=0).tolist())[-6:] == [1] * 5 + [2]
    assert issued_rows(s, 64) == 2 * 64 / 7  # every match in the last tile
