"""The probe copy's and transpose's host plans (``ops/probes.py::
copy_plan``, ``transpose_plan``) on the CPU: the copy's 256-thread
blocks, the transpose's ``sms // 3`` blocks where the work allows (on
cards of 132, 66 and 1 SMs), every output element written by exactly one
thread (the kernels' index maps, replayed here), and the one-element or
masked path for unaligned or ragged inputs, at the shapes the card tests
run."""

import itertools

import numpy as np
import pytest

from spconv_tpu_torch.ops import probes as P

SMS = (132, 66, 1)
# (rows, width, kind) at the probes' shapes: 64 int8 rows (widened), 64
# bf16 rows, 64 4-byte rows (probe_dma_align's int32 and f32), the 16-row
# f32 chunk, and the 8-row tail of tests/test_torch_probes.py
COPY_PROBES = [(64, 128, 0), (64, 128, 1), (64, 128, 2), (16, 128, 2),
               (8, 128, 1)]
# copies of one row, a few blocks and many blocks
ROWS = (1, 64, 1000)
# the card tests' widths: the 16-byte path, the one-element path, and the
# widths where the kind decides (int8 and 4-byte hold whole vectors at 8
# and 12, bf16 at 8 only)
WIDTHS = (128, 7, 8, 12)
VEC_ELEMS = {0: 4, 1: 8, 2: 4}  # output elements of a 16-byte vector
# the transpose's probe shape, the card tests' ragged and skinny ones
TRANSPOSES = [(128, 128), (100, 37), (1, 65), (4096, 8), (8, 4096),
              (64, 96), (3, 4)]


def copy_cover(plan, rows, width):
    """How many times ``copy_rows_kernel`` on ``plan`` writes each element
    of ``out [rows, width]``: block b's thread (x, y) writes row ``b * ty
    + y`` (if below rows) at ``c = x * per``, stepping by ``tx * per``
    while ``c < width``, ``per`` elements a step."""
    hits = np.zeros((rows, width), np.int64)
    for b, y, x in itertools.product(range(plan.grid), range(plan.ty),
                                     range(plan.tx)):
        r = b * plan.ty + y
        if r >= rows:
            continue
        for c in range(x * plan.per, width, plan.tx * plan.per):
            hits[r, c:c + plan.per] += 1
    return hits


def transpose_cover(plan, m, n):
    """How many times ``transpose_regs_kernel`` on ``plan`` writes each
    element of ``out [n, m]`` (counted at ``a``'s index ``[i, j]``)."""
    hits = np.zeros((m, n), np.int64)
    gx, gy = -(-m // (4 * plan.p)), -(-n // (4 * plan.q))
    assert plan.grid == gx * gy
    for bx, by, p, q in itertools.product(range(gx), range(gy),
                                          range(plan.p), range(plan.q)):
        i, j = 4 * (bx * plan.p + p), 4 * (by * plan.q + q)
        if i < m and j < n:
            hits[i:i + 4, j:j + 4] += 1  # numpy cuts the ragged edge
    return hits


@pytest.mark.parametrize("rows,width,kind", COPY_PROBES)
def test_copy_probes_take_16_byte_vectors_and_256_thread_blocks(rows, width,
                                                               kind):
    """At the probes' shapes a thread writes one 16-byte vector, a block
    has ``COPY_THREADS`` threads, as many whole rows as fit, and the grid
    covers the rows once."""
    plan = P.copy_plan(rows, width, kind)
    assert plan.vec and plan.per == VEC_ELEMS[kind]
    assert plan.tx == width // plan.per
    assert plan.tx * plan.ty == P.COPY_THREADS
    assert plan.grid == -(-rows // plan.ty)
    assert (copy_cover(plan, rows, width) == 1).all()


def test_copy_probe_plans():
    """The probes' copies on 256-thread blocks, as the kernel this one
    replaced, but a thread writes one 16-byte vector (int8 reads 4 bytes
    for it, was 16 for four vectors): the int8 widen 8 blocks of 32 x 8
    (was 2), bf16 4 of 16 x 16, the f32 chunk 2 of 32 x 8."""
    assert P.copy_plan(64, 128, 0) == P.CopyPlan(True, 4, 32, 8, 8)
    assert P.copy_plan(64, 128, 1) == P.CopyPlan(True, 8, 16, 16, 4)
    assert P.copy_plan(16, 128, 2) == P.CopyPlan(True, 4, 32, 8, 2)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", ROWS)
def test_copy_plan_covers_every_element_once(width, kind, aligned, rows):
    """Every output element written once at each card-test width, with
    16-byte vectors exactly where the width holds whole vectors of the
    kind and ``x`` is aligned, else one element a thread; a block of at
    most ``COPY_THREADS`` threads that holds whole rows."""
    plan = P.copy_plan(rows, width, kind, aligned=aligned)
    assert plan.vec == (aligned and width % VEC_ELEMS[kind] == 0)
    assert plan.per == (VEC_ELEMS[kind] if plan.vec else 1)
    assert plan.tx * plan.ty <= P.COPY_THREADS < plan.tx * (plan.ty + 1)
    assert (copy_cover(plan, rows, width) == 1).all()


def test_copy_widths_choose_the_path_by_kind():
    """Widths 8 and 12 split the kinds: 12 bf16 elements are no whole
    16-byte vector, 12 int8 ones are (4 bytes in, 16 out)."""
    vec = {(w, k): P.copy_plan(64, w, k).vec
           for w in (7, 8, 12) for k in (0, 1, 2)}
    assert vec == {(7, 0): False, (7, 1): False, (7, 2): False,
                   (8, 0): True, (8, 1): True, (8, 2): True,
                   (12, 0): True, (12, 1): False, (12, 2): True}


@pytest.mark.parametrize("threads", [16, 32, 64, 128, 256, 512, 1024])
def test_copy_sweep_blocks_cover_the_probes(threads):
    """Every block size of ``tools/copy_tiles.py``'s sweep covers each
    probe's output once."""
    for rows, width, kind in COPY_PROBES:
        plan = P.copy_plan(rows, width, kind, threads=threads)
        assert plan.tx * plan.ty <= threads
        assert (copy_cover(plan, rows, width) == 1).all()


@pytest.mark.parametrize("m,n", TRANSPOSES)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False])
def test_transpose_plan_covers_every_element_once(m, n, sms, aligned):
    """Every element of ``a`` transposed once; 16-byte accesses exactly
    where m and n are multiples of 4 and ``a`` is aligned (else the
    masked path); at least ``sms // 3`` blocks where the smallest tile
    gives that many; lanes cut to the 4-wide blocks along each side."""
    plan = P.transpose_plan(m, n, sms, aligned=aligned)
    assert plan.vec == (aligned and m % 4 == 0 and n % 4 == 0)
    assert plan.p <= max(1, 1 << (-(-m // 4) - 1).bit_length())
    assert plan.q <= max(1, 1 << (-(-n // 4) - 1).bit_length())
    smallest = P.transpose_plan(m, n, sms, aligned=aligned,
                                tile=P.TRANSPOSE_TILES[-1])
    if smallest.grid >= sms // 3:
        assert plan.grid >= sms // 3
    assert (transpose_cover(plan, m, n) == 1).all()


def test_transpose_probe_plan_on_the_h100():
    """128 x 128 on 132 SMs: 64 blocks of 4 x 4 threads, a 4 x 4 block a
    thread with 16-byte accesses (was 16 blocks of 256 threads through a
    shared-memory tile)."""
    assert P.transpose_plan(128, 128, 132) == P.TransposePlan(4, 4, True, 64)
    assert P.transpose_plan(4096, 8, 132) == P.TransposePlan(16, 2, True, 64)


@pytest.mark.parametrize("m,n", TRANSPOSES)
@pytest.mark.parametrize("tile", P.TRANSPOSE_TILES + ((4, 2), (2, 2)))
def test_transpose_sweep_tiles_cover_every_element_once(m, n, tile):
    """Every lane pair of ``tools/copy_tiles.py``'s sweep, cut to the
    shape, transposes each element of ``a`` once, on the 16-byte path
    where m and n are multiples of 4 and on the masked path elsewhere."""
    plan = P.transpose_plan(m, n, 132, tile=tile)
    assert plan.vec == (m % 4 == 0 and n % 4 == 0)
    assert plan.p <= tile[0] and plan.q <= tile[1]
    assert (transpose_cover(plan, m, n) == 1).all()


def test_copy_plan_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        P.copy_plan(64, 128, 3)
