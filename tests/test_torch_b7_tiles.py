"""B7's int8 tile variants (``ops/dg_conv.py::b7_variant``), chosen on the
host from the shapes, pinned at every B7 launch of the int8 CenterPoint
request, the int8 down/inverse pair and S4; their shared memory; the
host model of the MMA rows the kernel issues; the ablation's edits; the
``[kv, K, C]`` weight the int8 module folds for the kernel; and the packed
first layer (C = 5) against the JAX package's int8 kernel in interpret mode
on the CPU.

The row counts are the buffers ``chip_smoke.py`` runs: the CenterPoint
encoder's on ``centerpoint.synthetic_centerpoint_input(0)`` (113,000
voxels in 113,664 rows; bounds calibrated in f32 on seed 0) and BenchNet's
stage 0 on ``basic.synthetic_scan(0)`` (125,952 rows) for S4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spconv_tpu.ops.pallas.dg_conv import dg_subm_conv_q

import spconv_tpu_torch as st
from spconv_tpu_torch.benchmark import centerpoint as TCP
from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.quantization import QuantizedSparseConv

from test_torch_quant import SHAPE, WINDOW, _subm_case

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100
SM_SMEM = 228 * 1024  # bytes an SM holds; 1 KB of each block reserved
WAVE = 132            # the H100's SMs

# CenterPoint: the input rows and the three downsamples' buffers; the
# output conv's (k 3x1x1, s 2x1x1)
_CP_N = (113_664, 112_128, 56_320, 23_040)
_CP_OUT = 20_992
_BENCH_N0 = 125_952  # BenchNet's stage 0, where S4 runs


def _launches():
    """(config, layer, path, N output rows, C, K) of every B7 launch: an
    int8 CenterPoint request (17 subm, 4 strided), the int8 down/inverse
    pair at the U-Net's enc_down.0 / dec_up.1 geometry, and S4 at
    ``bench.py``'s ``run_int8`` widths."""
    out = [("cp", "conv_input", "subm", _CP_N[0], 5, 16)]
    for si, c in enumerate((16, 32, 64, 128)):
        out += [("cp", f"subm{si}.{j}", "subm", _CP_N[si], c, c)
                for j in range(4)]
    for si, (c, k) in enumerate(((16, 32), (32, 64), (64, 128))):
        out.append(("cp", f"down{si + 1}", "strided", _CP_N[si + 1], c, k))
    out.append(("cp", "out", "strided", _CP_OUT, 128, 128))
    out += [("pair", "down0", "strided", _CP_N[1], 16, 32),
            ("pair", "up0", "inverse", _CP_N[0], 32, 16),
            ("s4", "C=K=64", "search", _BENCH_N0, 64, 64),
            ("s4", "C=K=128", "search", _BENCH_N0, 128, 128)]
    return out


_LAUNCHES = _launches()


def test_every_b7_launch_is_listed():
    """17 subm and 4 strided B7 launches an int8 CenterPoint request, the
    pair's strided and inverse, S4's two widths."""
    count = {}
    for cfg, _, path, *_ in _LAUNCHES:
        count[(cfg, path)] = count.get((cfg, path), 0) + 1
    assert count == {("cp", "subm"): 17, ("cp", "strided"): 4,
                     ("pair", "strided"): 1, ("pair", "inverse"): 1,
                     ("s4", "search"): 2}


@pytest.mark.parametrize("cfg,layer,path,n,c,k_out", _LAUNCHES,
                         ids=[f"{s[0]}-{s[1]}" for s in _LAUNCHES])
def test_b7_variant_at_every_launch(cfg, layer, path, n, c, k_out):
    """The shared memory fits, two blocks an SM; the scalar gather exactly
    where C % 16 != 0 or the features are misaligned; packed exactly where
    C is at most half the step; the tile covers K (every int8 layer of the
    repo has K <= 128) in one column tile; the grid covers the output
    once."""
    for aligned in (True, False):
        v = TD.b7_variant(n, c, k_out, aligned=aligned)
        assert (v.bm, v.bn) == TD.B7_TILES[v.tile][:2]
        assert TD.b7_smem_bytes(v.tile) <= SMEM_LIMIT
        assert 2 * (TD.b7_smem_bytes(v.tile) + 1024) <= SM_SMEM
        assert v.vec == (aligned and c % 16 == 0)
        assert v.packed == (c <= TD.B7_TILES[v.tile][2] // 2)
        assert v.grid == (-(-n // v.bm), -(-k_out // v.bn))
        assert v.bn >= k_out and v.grid[1] == 1
        assert np.prod(v.grid) >= WAVE


# (N, C, K) -> (BM, BN, vec, packed)
_PINNED = {
    (113_664, 5, 16): (128, 16, False, True),    # conv_input: scalar
    (113_664, 16, 16): (128, 16, True, True),    # subm0
    (112_128, 16, 32): (128, 32, True, True),    # down1, the pair's down0
    (112_128, 32, 32): (128, 32, True, True),    # subm1: 4 offsets a step
    (113_664, 32, 16): (128, 16, True, True),    # the pair's inverse
    (56_320, 32, 64): (64, 64, True, True),      # down2
    (56_320, 64, 64): (64, 64, True, True),      # subm2: 2 offsets a step
    (23_040, 64, 128): (64, 128, True, False),   # down3: 64-channel steps
    (23_040, 128, 128): (64, 128, True, False),  # subm3
    (20_992, 128, 128): (64, 128, True, False),  # out
    (125_952, 64, 64): (64, 64, True, True),     # S4, run_int8 C = K = 64
    (125_952, 128, 128): (64, 128, True, False),  # S4, C = K = 128
    (3_072, 12, 20): (128, 32, False, True),     # ragged C and K
    (3_072, 16, 128): (64, 64, True, True),      # 48 blocks: narrowed
    (3_072, 80, 16): (128, 16, True, False),     # C > 64: one offset a step
    (3_072, 72, 48): (64, 64, False, False),     # the same, byte loads
    (200_000, 64, 320): (64, 128, True, False),  # past 128: column tiles
}


@pytest.mark.parametrize("shape", sorted(_PINNED))
def test_b7_variant_pinned(shape):
    v = TD.b7_variant(*shape)
    assert (v.bm, v.bn, v.vec, v.packed) == _PINNED[shape]


def test_b7_variant_column_tiles_past_128_and_at_a_small_n():
    """K = 320 at a large N: the widest tile and three column tiles; K =
    128 at 48 row tiles narrows to 64 columns, two column tiles."""
    assert TD.b7_variant(200_000, 64, 320).grid == (3125, 3)
    assert TD.b7_variant(3_072, 16, 128).grid == (48, 2)


@pytest.mark.parametrize("c", [5, 12, 20, 16, 32, 64, 128])
def test_b7_scalar_gather_exactly_when_rows_are_not_vectors(c):
    """C = 5 (the first layer of every int8 encoder), C = 12 and 20: byte
    loads; a misaligned contiguous view (its data pointer off 16 bytes, as
    the wrapper reads it) too; C % 16 == 0 and aligned: 16-byte copies."""
    assert TD.b7_variant(113_664, c, 16).vec == (c % 16 == 0)
    base = torch.zeros(3072 * c + 1, dtype=torch.int8)
    view = base[1:].view(3072, c)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert not TD.b7_variant(3072, c, 16,
                             aligned=view.data_ptr() % 16 == 0).vec


def test_b7_smem_bytes_layout():
    """A ring of 4 stages of the gathered [BM, BK + 16] chunk and W[k]^T's
    [BN, BK + 16] (int8), then 32 offsets' rows and 65 ints of lists; the
    128 x 32 tile is the largest, and every tile fits two blocks an SM."""
    assert TD.B7_TILES == ((128, 16, 128), (128, 32, 128), (64, 64, 128),
                           (64, 128, 64))
    assert TD.b7_smem_bytes(0) == 4 * (128 + 16) * 144 + (32 * 128 + 65) * 4
    assert TD.b7_smem_bytes(3) == 4 * (64 + 128) * 80 + (32 * 64 + 65) * 4
    sizes = [TD.b7_smem_bytes(t) for t in range(len(TD.B7_TILES))]
    assert max(sizes) == TD.b7_smem_bytes(1) == 108_804
    assert 2 * (max(sizes) + 1024) <= SM_SMEM
    # the bytes a step moves per row are B2's at the same tile (BK bf16
    # elements there, BK int8 channels here)
    for (bm, bn, bk), (bm2, bn2, bk2) in zip(TD.B7_TILES, TD.B2_TILES):
        assert (bm, bn, bk) == (bm2, bn2, 2 * bk2)


def _simulate(pos, c, k_out):
    """The MMA rows of one column tile, by walking the kernel's loops: per
    block of BM rows and group of 32 offsets, the live offsets in order,
    then its steps and k32 slices, a 16-row tile multiplying a slice where
    it matches one of the slice's offsets."""
    kv, n = pos.shape
    v = TD.b7_variant(n, c, k_out)
    bm, _, bk = TD.B7_TILES[v.tile]
    m = (pos >= 0).numpy()
    rows = 0
    for row0 in range(0, n, bm):
        for k0 in range(0, kv, 32):
            live = [[bool(m[k, r0:min(r0 + 16, n)].any())
                     for r0 in range(row0, row0 + bm, 16)]
                    for k in range(k0, min(k0 + 32, kv))]
            offs = [kk for kk, bits in enumerate(live) if any(bits)]
            if c <= 16:
                for i in range(0, len(offs), 2):
                    pair = offs[i:i + 2]
                    rows += 16 * sum(any(live[kk][t] for kk in pair)
                                     for t in range(bm // 16))
                continue
            for kk in offs:
                for c0 in range(0, c, bk):
                    for ks in range(bk // 32):
                        if c0 + 32 * ks < c:
                            rows += 16 * sum(live[kk])
    return rows


@pytest.mark.parametrize("c,k_out", [(5, 16), (16, 32), (20, 16),
                                     (64, 64), (128, 128)])
@pytest.mark.parametrize("kv", [27, 125])
def test_b7_mma_rows_model_walks_the_kernel(c, k_out, kv):
    """The host model equals a walk of the kernel's loops on a random
    table of 700 rows (partial blocks, one or four offset groups)."""
    g = torch.Generator().manual_seed(kv + c)
    pos = torch.randint(0, 700, (kv, 700), generator=g, dtype=torch.int32)
    pos[torch.rand((kv, 700), generator=g) > 0.02] = -1
    issued, needed = TD.b7_mma_rows(pos, c, k_out)
    assert issued == _simulate(pos, c, k_out)
    pairs = int((pos >= 0).sum())
    assert needed == (-(-pairs // 2) if c <= 16 else pairs * -(-c // 32))


def test_b7_mma_rows_count_whole_tiles_of_live_offsets():
    """A hand-made table: C = 64 (64-row blocks) multiplies each live
    16-row tile twice (two k32 slices); C = 16 (128-row blocks) pairs a
    block's live offsets in one slice each."""
    pos = torch.full((27, 256), -1, dtype=torch.int32)
    pos[0, [0, 20]] = 1   # block 0: tiles 0 and 1
    pos[5, 100] = 2       # 64-row block 1 tile 2; 128-row block 0 tile 6
    pos[9, 5] = 3         # block 0: tile 0
    pos[26, 255] = 4      # the last tile
    assert TD.b7_mma_rows(pos, 64, 64) == (16 * 2 * 5, 2 * 5)
    # 128-row block 0: offsets (0, 5) -> tiles {0, 1, 6}, (9) -> {0};
    # block 1: offset 26 -> tile 7
    assert TD.b7_mma_rows(pos, 16, 16) == (16 * (3 + 1 + 1), 3)


def test_b7_mma_rows_at_centerpoint_stage0():
    """On the CenterPoint scan's stage-0 table (113,664 rows, 27 offsets)
    the kernel issues about twice the rows its matched pairs need (a 16-row
    tile multiplies wherever one row matches), packed (C = 5, 16) and
    not."""
    x, _ = TCP.synthetic_centerpoint_input(0, device="cpu")
    keys, _ = TC.linearize(x.indices, x.spatial_shape, 1)
    pos = TD.build_dg_pos(keys, ksize=(3, 3, 3), dilation=(1, 1, 1),
                          spatial_shape=x.spatial_shape, batch_size=1)
    assert pos.shape == (27, 113_664)
    pairs = int((pos >= 0).sum())
    packed = TD.b7_mma_rows(pos, 5, 16)
    assert packed == TD.b7_mma_rows(pos, 16, 16)
    assert packed[1] == -(-pairs // 2)
    r32 = TD.b7_mma_rows(pos, 32, 32)
    assert r32[1] == pairs
    assert TD.b7_mma_rows(pos, 128, 128) == (4 * r32[0], 4 * pairs)
    for issued, needed in (packed, r32):
        assert issued % 16 == 0 and needed < issued <= 2.5 * needed
    # the packed slices pair offsets: fewer rows than one offset a slice
    assert packed[0] < r32[0]


def test_b7_ablation_edits_apply_to_the_kernel_source():
    """``spconv_tpu_torch.tools.b7_ablation`` rebuilds ``csrc/dg_fwd_q.cu``
    with texts replaced; each must be in the source once, so a change of
    the kernel that moves one fails here rather than on the card.  The
    counting build adds one count per (k32 slice, 16-row tile) a warp of
    the first column stripe multiplies, and its reader."""
    from spconv_tpu_torch.tools import ablation as AB
    from spconv_tpu_torch.tools import b7_ablation as A

    assert [name for name, _ in A.ABLATIONS] == ["as is", "no MMA",
                                                 "no copy", "sync fill"]
    src = (AB.SRC_DIR / "dg_fwd_q.cu").read_text()
    for _, edits in A.ABLATIONS + (A.COUNT,):
        assert all(src.count(old) == 1 for old, _ in edits)
    for _, edits in A.ABLATIONS:
        out = AB.ablated_source("dg_fwd_q.cu", edits)
        # an edit that inserts text keeps its anchor inside the new text
        assert all(new in out and out.count(old) == new.count(old)
                   for old, new in edits)
    out = AB.ablated_source("dg_fwd_q.cu", A.COUNT[1])
    assert out.count("atomicAdd(&slices_issued, 1ull)") == 1
    assert 'extern "C" int dg_fwd_q_slices_issued' in out


def test_refold_derives_the_kernel_weight_layout():
    """``QuantizedSparseConv.refold`` folds ``weight_kc``, the ``[kv, K,
    C]`` weight B7 reads, contiguous, once, as a non-persistent buffer, and
    ``weight_kv`` is its ``[kv, C, K]`` view: the state dict keeps the KRSC
    ``weight_i8`` alone, and a refold after a weight change follows it."""
    conv = st.SubMConv3d(5, 16, 3, indice_key="s0", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    q = QuantizedSparseConv(conv, np.full(16, 0.01, np.float32), 0.05, 0.1,
                            act_type="relu")
    assert q.weight_kc.shape == (27, 16, 5) and q.weight_kc.is_contiguous()
    assert torch.equal(q.weight_kv, TD.weight_krsc_to_kv(q.weight_i8))
    assert q.weight_kv.data_ptr() == q.weight_kc.data_ptr()
    assert "weight_kc" not in q.state_dict()
    assert "weight_kv" not in q.state_dict()
    q.weight_i8[0] = 7
    q.refold()
    assert torch.equal(q.weight_kv, TD.weight_krsc_to_kv(q.weight_i8))
    assert (q.weight_kc[:, 0] == 7).all()


def test_dg_fwd_q_checks_the_folded_weight():
    """The weight is taken contiguous ``[kv, C, K]`` or as the ``[kv, C,
    K]`` view of a contiguous ``[kv, K, C]`` (the int8 modules' layout);
    any other layout raises."""
    x = torch.zeros((64, 5), dtype=torch.int8)
    w = torch.zeros((27, 5, 16), dtype=torch.int8)
    pos = torch.full((27, 64), -1, dtype=torch.int32)
    scale = torch.ones(16)
    folded = w.transpose(1, 2).contiguous().transpose(1, 2)
    for weight in (w, folded):
        out = TD.dg_fwd_q(x, weight, pos, scale, None)
        assert out.shape == (64, 16) and not out.any()
    wide = torch.zeros((27, 5, 32), dtype=torch.int8)
    for bad in (wide[:, :, ::2], torch.zeros((5, 27, 16), dtype=torch.int8
                                             ).transpose(0, 1)):
        with pytest.raises(ValueError, match="contiguous"):
            TD.dg_fwd_q(x, bad, pos, scale, None)


def test_dg_fwd_q_packed_first_layer_matches_pallas():
    """C = 5 -> K = 16 with bias and ReLU (the first layer of every int8
    encoder: the packed, scalar-gather variant on the card) through
    ``dg_fwd_q`` on the CPU, every row bit for bit against
    ``dg_subm_conv_q`` in interpret mode."""
    x, w, scale, bias, _, keys = _subm_case(5, 5, 16)
    scale = scale * 3  # 5 channels: put some outputs past +-127
    pos = TD.build_dg_pos(keys, ksize=(3, 3, 3), dilation=(1, 1, 1),
                          spatial_shape=SHAPE, batch_size=1)
    w_kv = TD.weight_krsc_to_kv(torch.from_numpy(w))
    before = dict(TD.launch_counts)
    got = TD.dg_fwd_q(torch.from_numpy(x), w_kv, pos,
                      torch.from_numpy(scale), torch.from_numpy(bias),
                      act="relu")
    assert TD.launch_counts == before
    ref = np.asarray(dg_subm_conv_q(
        jnp.asarray(x), jnp.asarray(keys.numpy()), jnp.asarray(w),
        jnp.asarray(scale), jnp.asarray(bias), spatial_shape=SHAPE,
        batch_size=1, dilation=(1, 1, 1), act="relu", window=WINDOW,
        interpret=True))
    assert (ref == 127).any() and (ref == 0).any() and (ref > 0).any()
    np.testing.assert_array_equal(got.numpy(), ref)
