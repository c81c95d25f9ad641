"""The probe GEMMs' host plan (``ops/probes.py::gemm_plan``) on the CPU:
enough blocks at the probes' shapes, shared memory within a block's
limit, every warp's K slice covering ``[0, K)`` once, and tiles covering
M and N with their tails masked, at the shapes the card tests run."""

import itertools

import pytest

from spconv_tpu_torch.ops import probes as P

SMS = 132  # the H100's
SMEM_MAX = 232_448  # a block's dynamic shared memory on Hopper

# the probes' shapes, the card tests' ragged ones, one for each tile and
# one whose warps stage their slice in several rounds
SHAPES = [(128, 432, 128), (128, 256, 128), (70, 40, 90), (1, 1, 1),
          (129, 33, 65), (64, 1000, 48), (256, 432, 256), (512, 96, 512),
          (192, 72, 224), (64, 3000, 48), (32, 4096, 32), (3, 0, 5)]


@pytest.mark.parametrize("m,k,n,is_int8", [(128, 432, 128, False),
                                           (128, 256, 128, True)])
def test_probe_shapes_fill_the_card(m, k, n, is_int8):
    """At least 64 blocks at the probes' shapes (4 with the former 64 x 64
    tiles), each warp staging its whole slice in one round: 16 x 16
    tiles, 7 warps of 4 MMA steps (bf16) or 8 of 1 (s8)."""
    plan = P.gemm_plan(m, k, n, is_int8, SMS)
    assert plan.grid >= 64
    assert (plan.bm, plan.bn, plan.kw) == (16, 16, 8 if is_int8 else 7)
    assert plan.grid == -(-m // plan.bm) * -(-n // plan.bn)
    assert plan.ks <= plan.kc
    assert plan.vec


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("is_int8", [False, True])
def test_plan_covers_k_and_the_tiles(m, k, n, is_int8):
    plan = P.gemm_plan(m, k, n, is_int8, SMS)
    depth = 32 if is_int8 else 16
    assert (plan.bm, plan.bn) in P.GEMM_TILES
    assert plan.bn >= 16 or not is_int8
    assert 1 <= plan.kw <= P.GEMM_WARPS
    assert plan.ks % depth == 0 and plan.kc % depth == 0
    assert 0 < plan.smem <= SMEM_MAX
    # warp w sums [w * ks, min((w + 1) * ks, K)): each k once, no warp idle
    slices = [range(w * plan.ks, min((w + 1) * plan.ks, k))
              for w in range(plan.kw)]
    assert sorted(itertools.chain(*slices)) == list(range(k))
    assert k == 0 or all(len(s) for s in slices)
    # the tiles cover M and N; the last of each is cut at the edge
    gm, gn = -(-m // plan.bm), -(-n // plan.bn)
    assert plan.grid == gm * gn
    assert (gm - 1) * plan.bm < m <= gm * plan.bm
    assert (gn - 1) * plan.bn < n <= gn * plan.bn
    # 16-byte loads only where K and N fill them
    vec_unit = 16 if is_int8 else 4
    assert plan.vec == (k % vec_unit == 0 and n % vec_unit == 0)


@pytest.mark.parametrize("is_int8", [False, True])
def test_shapes_reach_every_tile_and_round(is_int8):
    """The card tests' shapes reach every tile the plan can pick, one and
    several rounds a warp, and both load paths."""
    plans = [P.gemm_plan(m, k, n, is_int8, SMS) for m, k, n in SHAPES]
    assert ({(p.bm, p.bn) for p in plans}
            == {t for t in P.GEMM_TILES if t[1] >= 16 or not is_int8})
    assert {p.ks > p.kc for p in plans} == {False, True}
    assert {p.vec for p in plans} == {False, True}


def test_plan_shared_memory_mirrors_the_kernel():
    """The kernel refuses a plan whose ``smem`` is not its own
    ``gemm_smem<T>(kw)``; here, that sum for two tiles by hand."""
    bf = P.gemm_plan(128, 432, 128, False, SMS, tile=(16, 16), kw=7)
    # a 16 x 72 bf16 A stage, a 64 x 24 B stage, a 16 x 20 f32 partial
    assert bf.smem == 7 * (2 * (16 * 72 + 64 * 24) + 16 * 20 * 4)
    s8 = P.gemm_plan(128, 256, 128, True, SMS, tile=(32, 32), kw=4)
    # 32 x 80 bytes of A, 64 x 32 of b's rows, 32 x 80 of its columns
    assert s8.smem == 4 * (32 * 80 + 64 * 32 + 32 * 80 + 32 * 36 * 4)
    assert (s8.kw, s8.ks, s8.kc) == (4, 64, 64)


def test_every_tile_and_warp_count_fits():
    for (bm, bn), is_int8 in itertools.product(P.GEMM_TILES, (False, True)):
        if is_int8 and bn < 16:
            with pytest.raises(ValueError, match="tile"):
                P.gemm_plan(64, 4096, 64, is_int8, SMS, tile=(bm, bn))
            continue
        plan = P.gemm_plan(64, 4096, 64, is_int8, SMS, tile=(bm, bn),
                           kw=P.GEMM_WARPS)
        assert plan.kw == P.GEMM_WARPS
        assert plan.smem <= SMEM_MAX


def test_unaligned_operands_take_element_loads():
    assert not P.gemm_plan(128, 432, 128, False, SMS, aligned=False).vec
    assert not P.gemm_plan(128, 256, 128, True, SMS, aligned=False).vec
