"""The sweep behind the probe join's and gathers' plans
(``ops/probes.py::join_plan``, ``gather_plan``) and where their time goes,
on the card.

1. The join at the probes' two shapes (int8: 128 probes into 256 keys of a
   ``[256, 128]`` table; f32: 256 probes into 1,024 keys of ``[1024,
   64]``; the keys in runs of two, a third of the probes matching) on
   every plan ``join_plan`` can give: each block size of ``JOIN_THREADS``
   with the keys counted in registers, and with the warp's ballot search
   in global memory; the lane gather of an f32 ``[128, 128]`` on 1-16
   warps a block; the row broadcast of 8 rows on 1-8 warps a block and
   1-8 rows a warp.  Each beside the plan's choice (``*``) and the
   PyTorch call (``torch.searchsorted``, the join's search half;
   ``torch.gather``; ``x[3].expand(8, -1) * 4``, checked bit-equal to
   plain too); each output checked bit-equal to plain.
2. ``csrc/probes.cu`` rebuilt with parts taken out (``tools/ablation.py``)
   and timed on the plans' launches: as is, launch only (every block
   returns at once), searches only (the join loads its probe and keys and
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


def _hash4(v):
    return (f"(__float_as_uint({v}.x) ^ __float_as_uint({v}.y) ^ "
            f"__float_as_uint({v}.z) ^ __float_as_uint({v}.w))")


ABLATIONS = (
    ("as is", ()),
    ("launch only", (
        (_JOIN_FIRST, "if (t_n >= 0) return;\n  " + _JOIN_FIRST),
        (_GATHER_FIRST, "if (rows >= 0) return;\n  " + _GATHER_FIRST),
        (_BCAST_FIRST, "if (rows >= 0) return;\n  " + _BCAST_FIRST))),
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
    libs = build("probes.cu", ABLATIONS,
                 {"probe_join_launch": [vp, i32, vp, i32, vp, *[i32] * 6,
                                        vp, vp],
                  "probe_gather_launch": [vp, i32, vp, *[i32] * 4, vp, vp],
                  "probe_broadcast_launch": [vp, i32, i32, ctypes.c_float,
                                             *[i32] * 4, vp, vp]},
                 BUILD_DIR / "join_gather_ablation")
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
    for row, (launch, ref) in runs.items():
        names = [n for n in libs if row.startswith("probe_join")
                 or n not in _JOIN_ONLY]
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
