"""The edge inputs of the match tables (B1, ``csrc/dg_pos.cu``) and the
sorted-key pool (B6, ``csrc/sk_pool.cu``): key-sorted site buffers made
from a seed with numpy, each where the kernels' windowed search
(``csrc/dg_search.cuh``'s ``WindowRows``) meets a case the benchmark scans
reach rarely or never.  The CPU tests hold the plain versions against the
JAX package at these inputs, the card tests and ``chip_smoke.py`` each
kernel against its plain version.

``table_case(name)`` and ``pool_case(name)`` give the inputs; nothing here
imports torch.
"""

import numpy as np

# name: (shape, batch, sites a batch (None: every site), sentinel rows at
# the tail, subm kernels [(ksize, dilation)], regular convs [(ksize,
# stride, padding, dilation)])
TABLE_CASES = {
    # a dense 2-D slab: a tile's probes span one or two rows of 5,000
    # sites, so every window is over B1's pool and sampled (and the table
    # has enough probes for B1's windowed path)
    "slab": ((3, 5000), 1, None, 29, [((3, 3), (1, 1))],
             [((3, 3), (2, 2), (1, 1), (1, 1))]),
    # a dense 3 x 2 x 4,030 grid: a 64-row tile inside one plane finds
    # windows of exactly 4,096 keys (two lines of the plane), so the first
    # that fits fills B1's pool and the next ones are left with none of it
    # (searched in global memory, no sample); the regular conv with stride
    # 1 gives its affine and divide tables the same windows
    "full_pool": ((3, 2, 4030), 1, None, 7, [((3, 3, 3), (1, 1, 1))],
                  [((3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1))]),
    # two batches of 500 sites: the batch boundary and a sentinel tail of
    # 45 rows fall inside one tile
    "batch_tail": ((6, 17, 23), 2, 500, 45, [((3, 3, 3), (1, 1, 1))],
                   [((3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1))]),
    # every site of a small grid: probes leave it through every face
    "faces": ((4, 5, 6), 1, None, 3, [((3, 3, 3), (1, 1, 1))],
              [((3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1)),
               ((3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1))]),
    # dilation 2 on the fastest axis: a line's probes are 2 keys apart
    "dil2": ((6, 17, 23), 1, 800, 11, [((3, 3, 3), (1, 1, 2))],
             [((3, 3, 3), (2, 2, 2), (1, 1, 2), (1, 1, 2))]),
    "ndim1": ((400,), 2, 150, 9, [((5,), (1,)), ((3,), (2,))],
              [((3,), (2,), (1,), (1,))]),
    "ndim2": ((20, 31), 1, 300, 7, [((3, 3), (1, 1))],
              [((3, 3), (2, 2), (1, 1), (1, 1))]),
    "ndim4": ((5, 7, 6, 9), 1, 900, 13, [((3, 3, 3, 3), (1, 1, 1, 1))],
              [((3, 3, 3, 3), (2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1))]),
    # kernel 5^3: five groups of 25 offsets
    "k5": ((6, 17, 23), 1, 1200, 5, [((5, 5, 5), (1, 1, 1))],
           [((5, 5, 5), (2, 2, 2), (2, 2, 2), (1, 1, 1))]),
    # even kernels: no centre offset; a k2 s2 conv and a mixed one
    "even": ((6, 17, 23), 1, 900, 5, [((2, 3, 4), (1, 1, 1))],
             [((2, 2, 2), (2, 2, 2), (0, 0, 0), (1, 1, 1)),
              ((2, 3, 4), (1, 2, 2), (0, 1, 1), (1, 1, 1))]),
}

# name: (shape, batch, sites a batch (None: every site), sentinel rows,
# channels)
POOL_CASES = {
    # C = 12: not a multiple of 8, so bf16 takes the scalar path (f32 the
    # 16-byte one); two batches and a sentinel tail inside one tile
    "c12_batch_tail": ((9, 21, 17), 2, 700, 40, 12),
    # C = 6: the scalar path in both dtypes
    "c6": ((9, 21, 17), 1, 600, 5, 6),
    "ndim1": ((301,), 2, 120, 7, 16),
    "ndim2": ((13, 21), 1, 150, 9, 24),
    "ndim4": ((5, 7, 6, 9), 1, 600, 11, 40),
    # a dense slab: a tile's children span whole input rows of 1,500 sites,
    # over B6's window pool
    "slab": ((2, 4, 1500), 1, None, 3, 8),
    # a dense 2 x 2 x 1,792 grid, C = 8: a 128-parent tile's first window
    # holds exactly B6's 2,048 keys, so the second is left with none of the
    # pool (searched in global memory, no sample)
    "full_pool": ((2, 2, 1792), 1, None, 5, 8),
}


def sorted_sites(shape, batch, n, tail, seed=0) -> np.ndarray:
    """``[rows, ndim + 1]`` int32 sites, batch first, ascending in key,
    then ``tail`` rows of -1: ``n`` distinct random sites a batch, or every
    site where ``n`` is None."""
    rng = np.random.RandomState(seed)
    vol = int(np.prod(shape))
    parts = []
    for b in range(batch):
        flat = (np.arange(vol) if n is None
                else np.sort(rng.choice(vol, size=min(n, vol),
                                        replace=False)))
        coords = np.stack(np.unravel_index(flat, shape), axis=-1)
        parts.append(np.concatenate(
            [np.full((len(flat), 1), b), coords], axis=-1))
    sites = np.concatenate(parts).astype(np.int32)
    out = np.full((len(sites) + tail, len(shape) + 1), -1, np.int32)
    out[:len(sites)] = sites  # batch-major, each batch ascending
    return out


def table_case(name, seed=0):
    """``(indices, shape, batch, subm kernels, regular convs)`` of
    ``TABLE_CASES[name]``."""
    shape, batch, n, tail, subm, regular = TABLE_CASES[name]
    return sorted_sites(shape, batch, n, tail, seed), shape, batch, subm, \
        regular


def pool_case(name, seed=0):
    """``(features [rows, C] f32, zero on the tail, indices, shape,
    batch)`` of ``POOL_CASES[name]``."""
    shape, batch, n, tail, c = POOL_CASES[name]
    inds = sorted_sites(shape, batch, n, tail, seed)
    rng = np.random.RandomState(seed + 1)
    feats = rng.uniform(-1, 1, (len(inds), c)).astype(np.float32)
    feats[inds[:, 0] < 0] = 0
    return feats, inds, shape, batch
