"""The windows B1 (``csrc/dg_pos.cu``) could not stage whole, counted on
the card and modelled on the host, and what its shared-memory windows
save.

The counting build (``COUNT``): ``dg_pos.cu`` as it is, with a device
counter that each block's thread 0 raises by the number of its windows
that did not fit in the pool whole (``dg::WindowRows::search``'s return:
those whose searches end in global memory, sampled or not staged at all),
read by ``dg_pos_windows_fallen_back``.  ``fallen_back`` runs one table
through it and returns the count beside the table.  ``b1_windows`` and
``b1_fallbacks`` are the same count on the host, from the keys, and the
number of those windows that the kernel does not sample because the rest
of the pool holds fewer keys than they are.

``main()`` prints, for each BenchNet stage's forward table (on
``benchmark.basic.synthetic_scan(0)``, pool bounds calibrated on seed 0,
as ``chip_smoke.py`` builds them) and the dense "slab" and "full_pool"
inputs of ``tools/table_cases.py``: the windows, those counted on the card
and on the host (and, on the host, those not sampled), and the table's ms
as it is and with a pool of 0 keys (no window staged, so every search is
in global memory: the windowed walk without its shared memory).  CUDA
events over 20 launches after a warm-up.

Run:  python -m spconv_tpu_torch.tools.table_count
"""

import ctypes
import sys
from typing import Tuple

import numpy as np
import torch

from .._build import BUILD_DIR, load_library
from ..benchmark import basic as B
from ..modules import SparseMaxPool3d
from ..ops import coords as C
from ..ops import dg_conv as D
from .ablation import build, cuda_ms
from .table_cases import table_case

COUNT = ("count", [
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long windows_fallen_back;\n"),
    ("    (void)fell_back;  // windows searched in global memory this pass\n",
     "    if (threadIdx.x == 0 && fell_back > 0) {\n"
     "      atomicAdd(&windows_fallen_back,\n"
     "                static_cast<unsigned long long>(fell_back));\n"
     "    }\n"),
    ("}  // namespace\n", """}  // namespace

// the windows counted so far into *out; zeroed if reset
extern "C" int dg_pos_windows_fallen_back(unsigned long long* out,
                                          int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, windows_fallen_back,
                                       sizeof(*out));
  const unsigned long long zero = 0;
  if (e == cudaSuccess && reset) {
    e = cudaMemcpyToSymbol(windows_fallen_back, &zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""),
])
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
COUNT_ARGTYPES = {
    "dg_pos_launch": [_VP, _I32, _VP, _I32, ctypes.POINTER(_I32)]
    + [_I32] * 8 + [_VP, _VP],
    "dg_pos_windows_fallen_back": [ctypes.POINTER(ctypes.c_ulonglong), _I32],
}
SHAPE = (80, 1600, 1600)
N_VOXELS = 125_562


def b1_windows(rows: torch.Tensor, table: torch.Tensor, tg: D.TableGeom,
               sentinel: int, plan: D.B1Plan) -> torch.Tensor:
    """``[grid, groups]`` int64: the length of the window of searched keys
    that each block of ``plan`` finds for each offset group (0 where the
    group has no valid probe), as the kernel finds it where the table is
    not staged whole (:func:`b1_fallbacks`): the keys between the least
    and the largest valid probe of the block's rows over the group's
    offsets.  A direct plan has no window: ``[0, groups]``."""
    ndim = len(tg.ksize)
    per_group = tg.ksize[-1] * (tg.ksize[-2] if ndim >= 2 else 1)
    if plan.tile == 0:
        return torch.zeros((0, int(np.prod(tg.ksize)) // per_group),
                           dtype=torch.int64)
    n = rows.shape[0]
    b, coords = D._decode(rows, tg.row_dims)
    offs = torch.as_tensor(C.kernel_offsets(tg.ksize), dtype=torch.int64,
                           device=rows.device)
    kv = offs.shape[0]
    ok = (rows != sentinel)[None].expand(kv, n).clone()
    probe = b[None].expand(kv, n)
    for a in range(ndim):
        ka = offs[:, a:a + 1]
        s, d, p = tg.stride[a], tg.dilation[a], tg.padding[a]
        if tg.divide:
            t = coords[a][None] - (ka * d - p)
            ok &= (t >= 0) & (t % s == 0)
            c = t // s
        else:
            c = coords[a][None] * s + ka * d - p
            ok &= c >= 0
        ok &= c < tg.tab_dims[a]
        probe = probe * tg.tab_dims[a] + c
    groups = kv // per_group
    group = torch.arange(kv, device=rows.device) // per_group
    block = torch.arange(n, device=rows.device) // plan.tile
    idx = (block[None] * groups + group[:, None])[ok]
    vals = probe[ok]
    size = plan.grid * groups
    lo_key = torch.full((size,), 2**31, dtype=torch.int64,
                        device=rows.device).scatter_reduce(
                            0, idx, vals, "amin")
    hi_key = torch.full((size,), -1, dtype=torch.int64,
                        device=rows.device).scatter_reduce(
                            0, idx, vals, "amax")
    t64 = table.long()
    lo = torch.searchsorted(t64, lo_key)
    hi = torch.searchsorted(t64, hi_key + 1)
    return torch.where(hi_key >= lo_key, hi - lo, 0).reshape(plan.grid,
                                                            groups)


def b1_fallbacks(windows: torch.Tensor, plan: D.B1Plan, n_table: int,
                 threads: int = 256) -> Tuple[int, int]:
    """``(fallen back, not sampled)``: how many of ``windows``
    (:func:`b1_windows`) the kernel searches in global memory, for a table
    of ``n_table`` keys, and how many of those it stages no sample of.
    None on the direct path or where the table is staged whole (at most the
    pool and 16 keys a thread; no window is searched then); else, per
    block and pass, the groups' windows take the pool in group order, one
    that no longer fits is not staged whole, and where the rest of the
    pool holds fewer keys than such windows none of them is sampled."""
    if plan.tile == 0 or n_table <= min(plan.pool, 16 * threads):
        return 0, 0
    fell = unsampled = 0
    for g0 in range(0, windows.shape[1], plan.groups):
        used = torch.zeros_like(windows[:, 0])
        out = torch.zeros_like(used)
        for g in range(g0, min(g0 + plan.groups, windows.shape[1])):
            fits = windows[:, g] <= plan.pool - used
            used = used + torch.where(fits, windows[:, g], 0)
            out = out + (~fits).long()
        fell += int(out.sum())
        unsampled += int(out[plan.pool - used < out].sum())
    return fell, unsampled


def fallen_back(count_lib, rows, table, tg, sentinel, plan):
    """``(windows fallen back, table)`` of one B1 table of ``rows``
    searched in ``table`` through the counting build, on ``plan``."""
    kv = 1
    for k in tg.ksize:
        kv *= k
    pos = torch.empty((kv, rows.shape[0]), dtype=torch.int32,
                      device=rows.device)
    got = ctypes.c_ulonglong(0)

    def read(reset):
        err = count_lib.dg_pos_windows_fallen_back(ctypes.byref(got), reset)
        if err:
            raise RuntimeError(f"dg_pos_windows_fallen_back: CUDA error "
                               f"{err}")

    torch.cuda.synchronize()
    read(1)
    err = D.launch_b1(count_lib, rows, table, tg, sentinel, plan, pos)
    if err:
        raise RuntimeError(f"dg_pos_launch (counting build): CUDA error "
                           f"{err}")
    torch.cuda.synchronize()
    read(0)
    return got.value, pos


def stage_keys(dev):
    """The sorted keys and grid of each BenchNet stage."""
    x0 = B.make_bench_input(*B.synthetic_scan(0, SHAPE, N_VOXELS),
                            device=dev)
    bounds = B.measure_pool_bounds(SHAPE, x0)
    geo = [x0]
    for s in range(6):
        geo.append(SparseMaxPool3d(2, 2, out_bound=bounds[s])(geo[-1]))
    return [(C.linearize(g.indices, g.spatial_shape, 1)[0], g.spatial_shape)
            for g in geo]


def main():
    dev = torch.device("cuda")
    sms = D.sm_count(dev.index or 0)
    count_lib = build("dg_pos.cu", (COUNT,), COUNT_ARGTYPES,
                      BUILD_DIR / "table_count")[COUNT[0]]
    lib = load_library()
    cases = [(f"stage {s}", k, 1) for s, k in enumerate(stage_keys(dev))]
    for name in ("slab", "full_pool"):
        inds, shape, batch, _, _ = table_case(name)
        cases.append((name, (C.linearize(torch.from_numpy(inds).to(dev),
                                         shape, batch)[0], shape), batch))
    print(f"{torch.cuda.get_device_name(0)}; B1 forward tables: windows, "
          "fallen back (card / host), not sampled (host), ms as is / pool 0")
    for name, (keys, dims), batch in cases:
        ksize, dil = ((3,) * len(dims), (1,) * len(dims))
        tg = D.TableGeom.subm(ksize, dil, dims)
        sent = C.grid_sentinel(dims, batch)
        plan = D.b1_plan(keys.shape[0], ksize, sms=sms)
        windows = b1_windows(keys, keys, tg, sent, plan)
        fell, unsampled = b1_fallbacks(windows, plan, keys.shape[0])
        card, pos = fallen_back(count_lib, keys, keys, tg, sent, plan)
        want = D.dg_pos_plain(keys, ksize=ksize, dilation=dil,
                              spatial_shape=dims, batch_size=batch)
        if not torch.equal(pos, want):
            raise RuntimeError(f"{name}: the counting build's table "
                               "differs from plain")
        out = torch.empty_like(pos)
        times = [cuda_ms(lambda: D.launch_b1(lib, keys, keys, tg, sent, p,
                                             out), 20)
                 for p in (plan, plan._replace(pool=0))]
        print(f"{name:9s} rows {keys.shape[0]:7d} tile {plan.tile:3d} "
              f"windows {windows.numel():5d}  fallen back {card:5d} / "
              f"{fell:5d}  not sampled {unsampled:5d}  ms {times[0]:.4f} / "
              f"{times[1]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
