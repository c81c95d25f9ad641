"""The sweep behind the probe join's, gathers' and rank's plans
(``ops/probes.py::join_plan``, ``gather_plan``, ``rank_plan``) and where
their time goes, on the card.

1. The join at the probes' two shapes (int8: 128 probes into 256 keys of a
   ``[256, 128]`` table; f32: 256 probes into 1,024 keys of ``[1024,
   64]``; the keys in runs of two, a third of the probes matching) on
   every plan ``join_plan`` can give: each block size of ``JOIN_THREADS``
   with the keys counted in registers, and with the warp's ballot search
   in global memory; the lane gather of an f32 ``[128, 128]`` on 1-16
   warps a block; the row broadcast of 8 rows on 1-8 warps a block and
   1-8 rows a warp; the rank of 16 rows of 128 lanes into 128 keys on
   1-16 warps a block, the keys counted and searched, beside the parent's
   kernel (one 128-thread block a row, thread 0's binary search: the
   ``PARENT_RANK`` build).  Each beside the plan's choice (``*``) and the
   PyTorch call (``torch.searchsorted``, the join's search half and the
   rank's search; ``torch.gather``; ``x[3].expand(8, -1) * 4``, checked
   bit-equal to plain too); each output checked bit-equal to plain.
2. ``csrc/probes.cu`` rebuilt with parts taken out (``tools/ablation.py``)
   and timed on the plans' launches: as is, launch only (every block
   returns at once; the rank's too), searches only (the join loads its probe and keys and
   searches, then reads no table row and stores nothing), no search (the
   join's matched rows taken from the probe's value: no key read), no
   probe load (the probes known to the kernel) and no stores (the loaded
   and summed bits feed a branch that never stores).

Each time: the median of seven readings of CUDA events over 100 launches
after a warm-up, inputs warm in L2, the candidates of a row read in turn
in each round.

Run:  python -m spconv_tpu_torch.tools.join_gather_tiles
"""

import ctypes
import itertools
import sys

import torch

from .._build import BUILD_DIR, load_library
from ..ops import dg_conv as D
from ..ops import probes as P
from .ablation import build, interleaved_ms

# a store kept only where the stored bits hash to a value no input gives
# (ptxas would drop loads whose values nothing reads)
_NEVER = "(0xDEADBEEFu ^ static_cast<unsigned>({}))"
_JOIN_FIRST = "const int p = t < t_n ? __ldg(probes + t) : 0;"
_JOIN_STORE = "*reinterpret_cast<Vec<Tacc, V>*>(o) = acc;"
_JOIN_AFTER_SEARCH = "if (t >= t_n) return;"
_GATHER_FIRST = "const int w4 = width >> 2;"
_BCAST_FIRST = "const int r1 = min(r0 + rw, rows);"
_BCAST_STORE = ("reinterpret_cast<float4*>(out + static_cast<size_t>(r) * "
                "width)[e] = v;")
_RANK_FIRST = "if (r >= rows) return;  // the whole warp: a warp owns one row"


def _hash4(v):
    return (f"(__float_as_uint({v}.x) ^ __float_as_uint({v}.y) ^ "
            f"__float_as_uint({v}.z) ^ __float_as_uint({v}.w))")


ABLATIONS = (
    ("as is", ()),
    ("launch only", (
        (_JOIN_FIRST, "if (t_n >= 0) return;\n  " + _JOIN_FIRST),
        (_GATHER_FIRST, "if (rows >= 0) return;\n  " + _GATHER_FIRST),
        (_BCAST_FIRST, "if (rows >= 0) return;\n  " + _BCAST_FIRST),
        (_RANK_FIRST, "if (rows >= 0) return;"))),
    ("searches only", (
        (_JOIN_AFTER_SEARCH,
         "if (t >= t_n || static_cast<unsigned>(r.x) * 65599u + "
         "static_cast<unsigned>(r.y) != " + _NEVER.format("t_n")
         + ") return;"),)),
    # the matched rows [p, p + 2) taken from the probe alone: no key read,
    # no search (the output is wrong by design)
    ("no search", (
        ("const int2 r = equal_range<SEARCH>(keys, w_n, p);",
         "const int2 r = make_int2(min(p, w_n), min(p + 2, w_n));"),)),
    # the probes known to the block (3 t): no probe load
    ("no probe load", ((_JOIN_FIRST, "const int p = 3 * t;"),)),
    ("no stores", (
        (_JOIN_STORE,
         "unsigned h = 0;\n    for (int j = 0; j < V; ++j) h ^= "
         "*reinterpret_cast<const unsigned*>(&acc.v[j]);\n    if (h == "
         + _NEVER.format("t_n") + ") " + _JOIN_STORE),
        ("os[e] = o;",
         "if ((o.x ^ o.y ^ o.z ^ o.w) == " + _NEVER.format("rows")
         + ") os[e] = o;"),
        (_BCAST_STORE, "if (" + _hash4("v") + " == " + _NEVER.format("rows")
         + ") " + _BCAST_STORE))),
)
# the ablations that leave the output right
_EXACT = ("as is", "no probe load")
# the ablations that change the join only
_JOIN_ONLY = ("searches only", "no search", "no probe load")
# the ablations that change the rank
_RANK = ("as is", "launch only")

# The parent's rank kernel, for the comparison: one block of 128 threads a
# row, thread 0 running a binary search in global memory while the others
# wait at the barrier, then the row written 4 bytes a thread.  Built in
# place of the plan's kernels (every plan's launch takes it).
_PARENT_RANK_KERNEL = """
__global__ void rank_parent_kernel(const int* __restrict__ keys, int w_n,
                                   const int* __restrict__ probes, int lanes,
                                   int* __restrict__ out) {
  __shared__ int rank;
  const int r = blockIdx.x;
  if (threadIdx.x == 0) {
    const int p = probes[static_cast<size_t>(r) * lanes];
    int lo = 0;
    int hi = w_n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    rank = lo;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    out[static_cast<size_t>(r) * lanes + l] = rank;
  }
}

"""
_RANK_LAUNCH = 'extern "C" int probe_rank_launch('
_RANK_DISPATCH = "  if (search == kRankSearch) {"
PARENT_RANK = ("parent rank", (
    (_RANK_LAUNCH, _PARENT_RANK_KERNEL + _RANK_LAUNCH),
    (_RANK_DISPATCH, "  if (rows > 0) {\n    rank_parent_kernel<<<rows, 128, 0, "
                     "s>>>(ks, w_n, pr, lanes, o);\n  } else if (search == "
                     "kRankSearch) {")))
RANK_ARGTYPES = {"probe_rank_launch": [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p, *[ctypes.c_int] * 6,
                                       ctypes.c_void_p, ctypes.c_void_p]}


def join_cases(dev):
    """``{row: (probes, keys, table)}`` at the probes' shapes, as
    ``chip_smoke.py`` phase 12 times them."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for row, (t_n, w_n, c, dt) in {
            "probe_join_int8": (128, 256, 128, torch.int8),
            "probe_join_f32": (256, 1024, 64, torch.float32)}.items():
        probes = torch.arange(t_n, device=dev, dtype=torch.int32) * 3
        keys = torch.arange(w_n, device=dev, dtype=torch.int32) // 2 * 2
        table = (torch.randint(-127, 127, (w_n, c), device=dev,
                               generator=g).to(dt)
                 if dt == torch.int8 else
                 torch.randn((w_n, c), device=dev, generator=g))
        cases[row] = (probes, keys, table)
    return cases


def rank_case(dev):
    """``(keys, probes)`` at the rank probe's shape (``tools/probe_dg.py``'s
    ``kr``): 128 sorted keys below 10,000, 16 rows of 128 lanes."""
    g = torch.Generator(device=dev).manual_seed(2)
    keys = torch.sort(torch.randint(0, 10_000, (128,), device=dev,
                                    dtype=torch.int32, generator=g)).values
    probes = torch.randint(0, 10_000, (16, 128), device=dev,
                           dtype=torch.int32, generator=g)
    return keys, probes


def rank_sweep(lib, parent, keys, probes, sms):
    """The rank on every plan :func:`ops.probes.rank_plan` can give for
    ``keys`` and ``probes`` (each of ``RANK_WARPS`` and 16 warps a block,
    the keys counted and searched), on the parent's kernel (``parent``:
    the ``PARENT_RANK`` build) and ``torch.searchsorted``, each output but
    the last checked bit-equal to plain; their ms read in turn.  Returns
    ``(plans, the rule's plan, plans' ms, parent ms, searchsorted ms)``."""
    rows, lanes = probes.shape
    w_n = keys.shape[0]
    ref = P.lane_rank_plain(keys, probes)
    rule = P.rank_plan(rows, w_n, lanes, sms)
    sweep = [P.rank_plan(rows, w_n, lanes, sms, rb=rb, search=sr)
             for sr in P.RANK_SEARCHES for rb in P.RANK_WARPS + (16,)]
    first = probes[:, 0].contiguous()
    fns = []
    for plan, dll in [(p, lib) for p in sweep] + [(rule, parent)]:
        out = torch.empty_like(ref)
        if P.launch_rank(dll, keys, probes, plan, out):
            raise RuntimeError(f"rank {plan}: launch failed")
        _check_equal("rank", plan, out, ref)
        fns.append(lambda dll=dll, plan=plan, out=out: P.launch_rank(
            dll, keys, probes, plan, out))
    fns.append(lambda: torch.searchsorted(keys, first))
    ms = interleaved_ms(fns)
    return sweep, rule, ms[:len(sweep)], ms[-2], ms[-1]


def _check_equal(row, plan, out, ref):
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise RuntimeError(f"{row} {plan}: output differs from plain")


def _print(row, lead, plans, rule, ms, label):
    cells = [f"{label(p)} {t:.5f}{'*' if p == rule else ''}"
             for p, t in zip(plans, ms)]
    print(f"  {row:20s} {lead}: " + "  ".join(cells), flush=True)


def main():
    dev = torch.device("cuda")
    sms = D.sm_count(dev.index or 0)
    lib = load_library()
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; probe join and "
          "gathers, ms a launch (* the plan's)")
    joins = join_cases(dev)
    plans = {}
    for row, (probes, keys, table) in joins.items():
        ref = P.keyed_sum_plain(probes, keys, table)
        t_n, (w_n, c) = probes.shape[0], table.shape
        rule = plans[row] = P.join_plan(t_n, w_n, c, sms)
        sweep = [P.join_plan(t_n, w_n, c, sms, threads=n, search=sr)
                 for sr in P.JOIN_SEARCHES for n in P.JOIN_THREADS]
        fns = [lambda: torch.searchsorted(keys, probes)]
        for plan in sweep:
            out = torch.empty_like(ref)
            if P.launch_join(lib, probes, keys, table, plan, out):
                raise RuntimeError(f"{row} {plan}: launch failed")
            _check_equal(row, plan, out, ref)
            fns.append(lambda plan=plan, out=out: P.launch_join(
                lib, probes, keys, table, plan, out))
        ms = interleaved_ms(fns)
        _print(row, f"searchsorted {ms[0]:.5f}", sweep, rule, ms[1:],
               lambda p: f"{p.search}/{p.grid}x{p.threads}")

    g = torch.Generator(device=dev).manual_seed(1)
    xg = torch.rand((128, 128), device=dev, generator=g)
    idx = torch.randint(0, 128, (128, 128), device=dev, dtype=torch.int32,
                        generator=g)
    idx64 = idx.long()
    ref = P.lane_gather_plain(xg, idx)
    rule = plans["probe_lane_gather"] = P.gather_plan(128, 128, sms)
    sweep = [P.gather_plan(128, 128, sms, rb=rb)
             for rb in P.GATHER_WARPS + (16,)]
    fns = [lambda: torch.gather(xg, 1, idx64)]
    for plan in sweep:
        out = torch.empty_like(ref)
        if P.launch_gather(lib, xg, idx, plan, out):
            raise RuntimeError(f"lane gather {plan}: launch failed")
        _check_equal("lane gather", plan, out, ref)
        fns.append(lambda plan=plan, out=out: P.launch_gather(lib, xg, idx,
                                                              plan, out))
    ms = interleaved_ms(fns)
    _print("probe_lane_gather", f"torch.gather {ms[0]:.5f}", sweep, rule,
           ms[1:], lambda p: f"{p.grid}x{p.rb}")

    xs = torch.rand((8, 128), device=dev, generator=g)
    ref = P.row_broadcast_plain(xs, 3, 4.0, 8)
    rule = plans["probe_row_broadcast"] = P.gather_plan(8, 128, sms,
                                                        broadcast=True)
    sweep = [P.gather_plan(8, 128, sms, broadcast=True, rb=rb, rw=rw)
             for rw, rb in itertools.product((1, 2, 4, 8), (1, 2, 4, 8))
             if rb * rw <= 8]
    # one PyTorch call writing the same 8 rows (the row's view expanded)
    def torch_call():
        return xs[3].expand(8, -1) * 4.0

    _check_equal("row broadcast", "torch call", torch_call(), ref)
    fns = [torch_call]
    for plan in sweep:
        out = torch.empty_like(ref)
        if P.launch_broadcast(lib, xs, 3, 4.0, plan, out):
            raise RuntimeError(f"row broadcast {plan}: launch failed")
        _check_equal("row broadcast", plan, out, ref)
        fns.append(lambda plan=plan, out=out: P.launch_broadcast(
            lib, xs, 3, 4.0, plan, out))
    ms = interleaved_ms(fns)
    _print("probe_row_broadcast", f"torch call {ms[0]:.5f}", sweep, rule,
           ms[1:], lambda p: f"{p.grid}x{p.rb}x{p.rw}")

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("probes.cu", ABLATIONS + (PARENT_RANK,),
                 {"probe_join_launch": [vp, i32, vp, i32, vp, *[i32] * 6,
                                        vp, vp],
                  "probe_gather_launch": [vp, i32, vp, *[i32] * 4, vp, vp],
                  "probe_broadcast_launch": [vp, i32, i32, ctypes.c_float,
                                             *[i32] * 4, vp, vp],
                  **RANK_ARGTYPES},
                 BUILD_DIR / "join_gather_ablation")

    keys, rp = rank_case(dev)
    sweep, rule, ms, parent_ms, ss_ms = rank_sweep(
        lib, libs[PARENT_RANK[0]], keys, rp, sms)
    plans["probe_rank"] = rule
    _print("probe_rank", f"searchsorted {ss_ms:.5f}, parent {parent_ms:.5f}",
           sweep, rule, ms, lambda p: f"{p.search}/{p.grid}x{p.rb}")
    print("ablations of csrc/probes.cu on the plans' launches, ms a launch")
    runs = {}
    for row, args in joins.items():
        runs[row] = (lambda dll, out, a=args, p=plans[row]: P.launch_join(
            dll, *a, p, out), P.keyed_sum_plain(*args))
    runs["probe_lane_gather"] = (
        lambda dll, out: P.launch_gather(dll, xg, idx,
                                         plans["probe_lane_gather"], out),
        P.lane_gather_plain(xg, idx))
    runs["probe_row_broadcast"] = (
        lambda dll, out: P.launch_broadcast(dll, xs, 3, 4.0,
                                            plans["probe_row_broadcast"],
                                            out),
        P.row_broadcast_plain(xs, 3, 4.0, 8))
    runs["probe_rank"] = (
        lambda dll, out: P.launch_rank(dll, keys, rp, plans["probe_rank"],
                                       out), P.lane_rank_plain(keys, rp))
    for row, (launch, ref) in runs.items():
        if row == "probe_rank":
            names = list(_RANK)
        else:
            names = [n for n in libs if n != PARENT_RANK[0] and (
                row.startswith("probe_join") or n not in _JOIN_ONLY)]
        fns = []
        for name in names:
            out = torch.zeros_like(ref)
            if launch(libs[name], out):
                raise RuntimeError(f"{row} {name}: launch failed")
            if name in _EXACT:
                _check_equal(row, name, out, ref)
            fns.append(lambda dll=libs[name], out=out: launch(dll, out))
        cells = [f"{name}: {t:.5f}"
                 for name, t in zip(names, interleaved_ms(fns))]
        print(f"  {row:20s} " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
