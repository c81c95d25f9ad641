"""The probe join's, gathers' and rank's host plans (``ops/probes.py::
join_plan``, ``gather_plan``, ``rank_plan``) on the CPU: the plans at the
probes' shapes on the H100,
the keys searched in global memory past those counted in registers, the
one-element path where the columns or the table's alignment do not fit
16-byte vectors, ragged row counts, and every output element written by
exactly one lane (the kernels' index maps, replayed here) on cards of
132, 66 and 1 SMs, the rank's keys each read once; and the sweep's
ablations and the parent rank's build, each text in the kernel source."""

import itertools

import numpy as np
import pytest

from spconv_tpu_torch.ops import probes as P
from spconv_tpu_torch.tools import join_gather_tiles as JG
from spconv_tpu_torch.tools.ablation import ablated_source

SMS = (132, 66, 1)
# (t_n, w_n, c) of the probes' joins (int8, f32) and of the card tests:
# the ragged 33 columns, the one-element path's, keys past those counted
# (searched in global memory), one probe among many keys
JOINS = [(128, 256, 128), (256, 1024, 64), (50, 300, 33), (100, 777, 36),
         (64, 500, 8), (40, 1024, 64), (100, 2000, 64), (40, 3000, 64),
         (1, 5000, 64), (1, 9001, 128), (64, 300, 64)]
# the probes' gathers (C = 8-128 rows of 128, the int32 gather's 16), the
# card tests' ragged row counts, and a long one
GATHER_ROWS = (8, 16, 32, 64, 128, 7, 33, 129, 200, 1, 1000)
GATHER_WIDTHS = (128, 4, 8, 64, 132, 256, 1000)
# the rank's keys (one, ragged, the probe's 128, the most counted) and row
# widths (one lane, ragged, the probe's 128)
RANK_KEYS = (1, 100, 128, 1024)
RANK_LANES = (1, 7, 128)


def join_cover(plan, t_n, c):
    """How many times ``join_kernel`` on ``plan`` writes each element of
    ``out [t_n, c]``: block b's warp w serves probe ``b * (threads // 32) +
    w`` (if below t_n), its lane l writing ``per`` elements (4 where
    ``plan.vec``, else 1) at ``v = l * per``, stepping by ``32 * per``
    while ``v < c``."""
    per = 4 if plan.vec else 1
    hits = np.zeros((t_n, c), np.int64)
    for b, w, lane in itertools.product(range(plan.grid),
                                        range(plan.threads // 32), range(32)):
        t = b * (plan.threads // 32) + w
        if t >= t_n:
            continue
        for v in range(lane * per, c, 32 * per):
            hits[t, v:v + per] += 1
    return hits


def gather_cover(plan, rows, width):
    """How many times ``lane_gather_kernel`` (or, where ``plan.rw`` > 1 or
    broadcast, ``broadcast_rows_kernel``) on ``plan`` writes each element
    of ``out [rows, width]``: block b's warp w serves rows ``[(b * rb + w)
    * rw, ... + rw)`` below rows; its lane l writes the 16-byte vectors
    ``l, l + 32, ...`` of each."""
    hits = np.zeros((rows, width), np.int64)
    w4 = width // 4
    for b, w, lane in itertools.product(range(plan.grid), range(plan.rb),
                                        range(32)):
        r0 = (b * plan.rb + w) * plan.rw
        for r in range(r0, min(r0 + plan.rw, rows)):
            for e in range(lane, w4, 32):
                hits[r, 4 * e:4 * e + 4] += 1
    return hits


def test_join_probe_plans_on_the_h100():
    """int8 (128 probes, 256 keys, 128 columns): 64 blocks of 2 warps;
    f32 (256 probes, 1,024 keys, 64 columns): 64 blocks of 4 warps; a
    warp a probe, its keys counted in registers, one 16-byte output vector
    a lane (was a 128-thread block per probe searched by one thread, one
    element a thread)."""
    assert P.join_plan(128, 256, 128, 132) == P.JoinPlan(
        True, 64, "count", 64)
    assert P.join_plan(256, 1024, 64, 132) == P.JoinPlan(
        True, 128, "count", 64)


@pytest.mark.parametrize("t_n,w_n,c", JOINS)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False])
def test_join_plan_covers_every_output_once(t_n, w_n, c, sms, aligned):
    """Every output element written once; 16-byte vectors exactly where
    ``c`` holds whole vectors and the table is aligned; at least ``sms //
    3`` blocks where the smallest block gives that many; keys counted in
    registers up to ``JOIN_COUNT_KEYS``, the warp's search in global
    memory past it."""
    plan = P.join_plan(t_n, w_n, c, sms, aligned=aligned)
    assert plan.vec == (aligned and c % 4 == 0)
    assert plan.threads in P.JOIN_THREADS
    smallest = P.join_plan(t_n, w_n, c, sms, aligned=aligned,
                           threads=P.JOIN_THREADS[-1])
    if smallest.grid >= sms // 3:
        assert plan.grid >= sms // 3
    assert plan.search == ("count" if w_n <= P.JOIN_COUNT_KEYS else "warp")
    assert (join_cover(plan, t_n, c) == 1).all()


@pytest.mark.parametrize("threads", P.JOIN_THREADS)
@pytest.mark.parametrize("search", P.JOIN_SEARCHES)
def test_join_sweep_plans_cover_the_probes(threads, search):
    """Every plan of ``tools/join_gather_tiles.py``'s sweep covers each
    probe's output once."""
    for t_n, w_n, c in JOINS[:2]:
        plan = P.join_plan(t_n, w_n, c, 132, threads=threads, search=search)
        assert (plan.threads, plan.search) == (threads, search)
        assert (join_cover(plan, t_n, c) == 1).all()


def test_join_keys_choose_where_they_are_searched():
    """Up to ``JOIN_COUNT_KEYS`` keys are counted in registers, one more
    searched in global memory by the warp; counting more is refused, as is
    an unknown search."""
    at = P.join_plan(1, P.JOIN_COUNT_KEYS, 64, 132)
    assert at.search == "count"
    past = P.join_plan(1, P.JOIN_COUNT_KEYS + 1, 64, 132)
    assert past.search == "warp"
    assert past.grid == 1 and past.threads == P.JOIN_THREADS[-1]
    assert P.join_plan(3, 301, 8, 132, search="warp").search == "warp"
    for kwargs, match in (
            ({"w_n": P.JOIN_COUNT_KEYS + 1, "search": "count"}, "counted"),
            ({"w_n": 300, "search": "binary"}, "search")):
        with pytest.raises(ValueError, match=match):
            P.join_plan(1, c=64, sms=132, **kwargs)


def test_join_columns_choose_the_path():
    """c = 33 and 6 take one element a lane, 36 and 8 16-byte vectors,
    and an unaligned table one element a lane."""
    got = {c: P.join_plan(64, 300, c, 132).vec for c in (33, 6, 36, 8)}
    assert got == {33: False, 6: False, 36: True, 8: True}
    assert not P.join_plan(64, 300, 64, 132, aligned=False).vec


def test_join_plan_refuses_a_block_that_is_no_whole_warps():
    with pytest.raises(ValueError, match="threads"):
        P.join_plan(64, 300, 64, 132, threads=48)


def test_gather_probe_plans_on_the_h100():
    """The lane gather of 128 rows of 128: 64 blocks of 2 warps, each
    warp's row in its own 512 bytes of shared memory (was 128 blocks of one
    warp staging the row behind a block barrier); 8 rows: 8 blocks of one
    warp; the row broadcast of 8 rows: one warp writing all 8, nothing
    staged (was 8 one-warp blocks, each staging the row)."""
    assert P.gather_plan(128, 128, 132) == P.GatherPlan(2, 1, 1024, 64)
    assert P.gather_plan(8, 128, 132) == P.GatherPlan(1, 1, 512, 8)
    assert P.gather_plan(8, 128, 132, broadcast=True) == P.GatherPlan(
        1, P.BROADCAST_ROWS, 0, 1)
    assert P.gather_plan(601, 128, 132, broadcast=True) == P.GatherPlan(
        1, P.BROADCAST_ROWS, 0, 76)


@pytest.mark.parametrize("rows", GATHER_ROWS)
@pytest.mark.parametrize("width", GATHER_WIDTHS)
@pytest.mark.parametrize("sms", SMS)
def test_gather_plan_covers_every_element_once(rows, width, sms):
    """Every output element written once, rows the block's warps do not
    divide included; the staged rows within 48 KB; at least ``sms // 3``
    blocks where one warp a block gives that many."""
    plan = P.gather_plan(rows, width, sms)
    assert plan.rw == 1 and plan.rb in P.GATHER_WARPS
    assert plan.smem == plan.rb * 4 * width
    assert plan.smem <= 48 * 1024
    if rows >= sms // 3:
        assert plan.grid >= sms // 3
    assert (gather_cover(plan, rows, width) == 1).all()


@pytest.mark.parametrize("rb", P.GATHER_WARPS + (16,))
@pytest.mark.parametrize("width", [128, 132])
@pytest.mark.parametrize("rows", (8, 128, 7, 129))
def test_gather_sweep_plans_cover_every_element_once(rb, width, rows):
    """Every plan of the sweep (and the card tests) writes each element of
    a gather of 128-wide (and 132-wide: a lane with two vectors) rows
    once."""
    plan = P.gather_plan(rows, width, 132, rb=rb)
    assert (plan.rb, plan.smem) == (rb, rb * 4 * width)
    assert plan.grid == -(-rows // rb)
    assert (gather_cover(plan, rows, width) == 1).all()


@pytest.mark.parametrize("rb", [1, 2, 4, 8])
@pytest.mark.parametrize("rw", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [8, 1, 25, 601])
def test_broadcast_plans_cover_every_element_once(rb, rw, rows):
    """The row broadcast on every warp and row split of the sweep, to
    output row counts the split does not divide, stages nothing and writes
    each element once."""
    plan = P.gather_plan(rows, 128, 132, broadcast=True, rb=rb, rw=rw)
    assert plan.smem == 0
    assert plan.grid == -(-rows // (rb * rw))
    assert (gather_cover(plan, rows, 128) == 1).all()


def test_gather_wide_rows_take_fewer_warps():
    """A staged row of 4,096 elements (16 KB) allows 2 warps a block, one
    of 12,288 (48 KB) one; wider rows, a width that is no multiple of 4
    and several rows a warp of the gather are refused."""
    assert P.gather_plan(100, 4096, 1).rb == 2
    assert P.gather_plan(100, 12288, 1).rb == 1
    for kwargs, match in (({"width": 12292}, "48 KB"),
                          ({"width": 130}, "multiple of 4"),
                          ({"width": 128, "rw": 2}, "rows a warp")):
        with pytest.raises(ValueError, match=match):
            P.gather_plan(64, sms=132, **kwargs)


@pytest.mark.parametrize("name,edits", JG.ABLATIONS,
                         ids=[name for name, _ in JG.ABLATIONS])
def test_sweep_ablations_are_in_the_kernel_source(name, edits):
    """Each text the sweep's ablations replace is in ``csrc/probes.cu``
    (``ablated_source`` raises otherwise), and each ablation but "as is"
    changes the source."""
    src = ablated_source("probes.cu", edits)
    assert (src == ablated_source("probes.cu", ())) == (name == "as is")


def rank_cover(plan, rows, lanes):
    """How many times ``rank_kernel`` on ``plan`` writes each element of
    ``out [rows, lanes]``: block b's warp w serves row ``b * rb + w`` (if
    below rows), from element ``row * lanes`` of a 16-byte aligned
    ``out``: lane l writes head element l (l < head), the 16-byte vectors
    l, l + 32, ... of the body, and tail element l (l < tail)."""
    hits = np.zeros(rows * lanes, np.int64)
    for b, w in itertools.product(range(plan.grid), range(plan.rb)):
        r = b * plan.rb + w
        if r >= rows:
            continue
        head, vectors, tail = P.rank_row_split(r, lanes)
        row0 = r * lanes
        assert (row0 + head) % 4 == 0 or vectors == 0
        for lane in range(32):
            if lane < head:
                hits[row0 + lane] += 1
            for v in range(lane, vectors, 32):
                hits[row0 + head + 4 * v:row0 + head + 4 * v + 4] += 1
            if lane < tail:
                hits[row0 + head + 4 * vectors + lane] += 1
    return hits.reshape(rows, lanes)


def rank_key_reads(plan, w_n):
    """How many times a warp of ``rank_kernel`` on ``plan`` with the keys
    counted reads each key: with ``kvec`` lane l loads the 16-byte vectors
    l, l + 32, ... of the first ``4 * (W // 4)`` keys, then the last
    ``key_tail`` one a lane; else every key one a lane."""
    reads = np.zeros(w_n, np.int64)
    start = 0
    if plan.kvec:
        for lane in range(32):
            for v in range(lane, w_n // 4, 32):
                reads[4 * v:4 * v + 4] += 1
        start = 4 * (w_n // 4)
    assert w_n - start == plan.key_tail
    for lane in range(32):
        reads[start + lane:w_n:32] += 1
    return reads


def test_rank_probe_plan_on_the_h100():
    """The probe's rank (16 rows of 128 lanes into 128 aligned keys) on 132
    SMs: 16 blocks of one warp, the keys counted 16 bytes a lane with no
    tail, each row one 16-byte vector a lane."""
    plan = P.rank_plan(16, 128, 128, 132)
    assert plan == P.RankPlan("count", True, 0, 1, 16)
    assert all(P.rank_row_split(r, 128) == (0, 32, 0) for r in range(16))


@pytest.mark.parametrize("w_n", RANK_KEYS)
@pytest.mark.parametrize("lanes", RANK_LANES)
@pytest.mark.parametrize("rows", (16, 1, 33, 200))
@pytest.mark.parametrize("sms", SMS)
def test_rank_plan_covers_every_output_once(w_n, lanes, rows, sms):
    """Every element of the rank's output written once at each key count,
    row width, row count and card: the warps a block the largest of
    ``RANK_WARPS`` with a third of the SMs' blocks (else 1), the grid
    covering the rows; the keys counted, each read once, with ``W % 4``
    read one a lane after the 16-byte loads (all of them, one a lane,
    where the keys are not aligned)."""
    for aligned in (True, False):
        plan = P.rank_plan(rows, w_n, lanes, sms, aligned=aligned)
        want = next((w for w in P.RANK_WARPS if -(-rows // w) >= sms // 3),
                    1)
        assert plan.rb == want and plan.grid == -(-rows // want)
        assert plan.search == "count" and plan.kvec == aligned
        assert plan.key_tail == (w_n % 4 if aligned else w_n)
        assert (rank_cover(plan, rows, lanes) == 1).all()
        assert (rank_key_reads(plan, w_n) == 1).all()


@pytest.mark.parametrize("rb", P.RANK_WARPS + (16,))
@pytest.mark.parametrize("search", P.RANK_SEARCHES)
def test_rank_sweep_plans_cover_the_probe(rb, search):
    """Each plan of the sweep (every warp count, both searches) writes each
    element of the probe's ``[16, 128]`` output once; the search reads no
    key one a lane."""
    plan = P.rank_plan(16, 128, 128, 132, rb=rb, search=search)
    assert plan.rb == rb and plan.grid == -(-16 // rb)
    assert plan.key_tail == 0 and plan.kvec == (search == "count")
    assert (rank_cover(plan, 16, 128) == 1).all()


def test_rank_keys_choose_the_search():
    """Up to ``RANK_COUNT_KEYS`` keys are counted, more searched (the
    warp's ballot lower bound); a count past it, an unknown search and a
    block of 0 or 33 warps are refused."""
    assert P.rank_plan(16, P.RANK_COUNT_KEYS, 8, 132).search == "count"
    plan = P.rank_plan(16, P.RANK_COUNT_KEYS + 1, 8, 132)
    assert plan.search == "warp" and not plan.kvec and plan.key_tail == 0
    for kwargs, match in (({"w_n": 1025, "search": "count"}, "counted"),
                          ({"w_n": 8, "search": "binary"}, "no search"),
                          ({"w_n": 8, "rb": 0}, "warps a block"),
                          ({"w_n": 8, "rb": 33}, "warps a block")):
        with pytest.raises(ValueError, match=match):
            P.rank_plan(16, lanes=8, sms=132, **kwargs)


def test_rank_parent_build_is_in_the_kernel_source():
    """The parent rank's build replaces texts that are in
    ``csrc/probes.cu`` and launches its kernel in place of the plan's."""
    src = ablated_source("probes.cu", JG.PARENT_RANK[1])
    assert "rank_parent_kernel<<<rows, 128, 0, s>>>" in src
    assert src.count("__global__ void rank_parent_kernel") == 1
