"""The host plans in C++ (``spconv_tpu_torch/csrc/plans.h``) against the
Python plans they mirror, field for field.

A small harness of ``plans.h`` (no torch and no CUDA headers; about a
second of ``g++``) reads one query a line and prints the plan.  Each query
goes through the Python function too: ``b1_plan`` and ``b1_window_plan``
(B1's table), ``b2_variant`` (B2's bf16 tile), ``b7_variant`` (B7's int8
tile), ``b6_plan`` (B6's pool), and the geometry packing of
``TableGeom.ints``, ``_search_args``, ``launch_b6`` and ``grid_sentinel``.
The grid: rows ``N`` at the edges of the tiles, of B1's direct path and of
a wave, the channel pairs of BenchNet, CenterPoint and the U-Net (both
ways round, for dgrad), kernels 2, 3 and (3, 1, 1), strides 1 and 2,
divide on and off, aligned and not, one SM and the H100's 132.  Python's
``-(-a // b)`` and ``int.bit_length()`` at 0 are where a C++ copy slips:
rows 1 and 127 and single-unit pool rows pin them.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

from spconv_tpu_torch.ops import coords as TC
from spconv_tpu_torch.ops import dg_conv as TD
from spconv_tpu_torch.ops import sorted_pool as TS

CSRC = Path(__file__).resolve().parents[1] / "spconv_tpu_torch" / "csrc"

N = (1, 127, 128, 4097, 131072, 131073, 10**6)
SMS = (1, 132)
KSIZES = ((2, 2, 2), (3, 3, 3), (3, 1, 1))
STRIDES = ((1, 1, 1), (2, 2, 2))
# (C, K) of every conv of BenchNet (benchmark/basic.py CHANNELS), the
# CenterPoint encoder (16, 32, 64, 128 from 5 inputs) and the U-Net
# (16, 32, 64 from 5 inputs, 16 classes); dgrad runs each the other way
_BENCH = (3, 64, 64, 96, 96, 128, 128, 160, 160, 192, 192, 224, 224, 256,
          256)
_FWD = ({(a, b) for a, b in zip(_BENCH, _BENCH[1:])}
        | {(5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
           (64, 128), (128, 128)}
        | {(64, 32), (32, 16), (16, 16), (16, 16)})
PAIRS = sorted(_FWD | {(k, c) for c, k in _FWD})
CHANNELS = sorted({c for pair in PAIRS for c in pair})

HARNESS = r"""
#include <iostream>
#include <string>
#include <vector>

#include "plans.h"

using namespace spconv_plans;

static std::vector<int> ints(std::istream& in, int n) {
  std::vector<int> v(n);
  for (int& x : v) in >> x;
  return v;
}

static void print(const std::vector<long long>& v) {
  for (size_t i = 0; i < v.size(); ++i) std::cout << (i ? " " : "") << v[i];
  std::cout << "\n";
}

int main() {
  std::string kind;
  while (std::cin >> kind) {
    try {
      if (kind == "b1" || kind == "b1w") {
        long long n;
        int sms, divide, ndim;
        std::cin >> n >> sms >> divide >> ndim;
        std::vector<int> ksize = ints(std::cin, ndim);
        std::vector<int> stride = ints(std::cin, ndim);
        B1Plan p = kind == "b1" ? b1_plan(n, ksize, stride, divide, sms)
                                : b1_window_plan(n, ksize, stride, divide, sms);
        print({p.tile, p.groups, p.passes, p.pool, p.sort, p.smem, p.grid});
      } else if (kind == "b2" || kind == "b7") {
        long long n, c, k;
        int aligned;
        std::cin >> n >> c >> k >> aligned;
        Variant v = kind == "b2" ? b2_variant(n, c, k, aligned)
                                 : b7_variant(n, c, k, aligned);
        std::vector<long long> out{v.tile, v.bm, v.bn, v.grid_rows,
                                   v.grid_cols, v.vec};
        if (kind == "b7") out.push_back(v.packed);
        print(out);
      } else if (kind == "b6") {
        long long m;
        int c, itemsize, ndim, aligned, sms;
        std::cin >> m >> c >> itemsize >> ndim >> aligned >> sms;
        B6Plan p = b6_plan(m, c, itemsize, ndim, aligned, sms);
        print({p.tile, p.lanes, p.threads, p.vec, p.pool, p.smem, p.grid});
      } else if (kind == "table") {
        int ndim;
        std::cin >> ndim;
        std::vector<std::vector<int>> f;
        for (int i = 0; i < 6; ++i) f.push_back(ints(std::cin, ndim));
        auto g = table_geom_ints(f[0], f[1], f[2], f[3], f[4], f[5]);
        print(std::vector<long long>(g.begin(), g.end()));
      } else if (kind == "search") {
        int ndim;
        std::cin >> ndim;
        std::vector<int> dims = ints(std::cin, ndim);
        std::vector<int> ksize = ints(std::cin, ndim);
        std::vector<int> dil = ints(std::cin, ndim);
        auto g = search_geom_ints(dims, ksize, dil);
        print(std::vector<long long>(g.begin(), g.end()));
      } else if (kind == "pool") {
        int ndim;
        std::cin >> ndim;
        std::vector<int> in_dims = ints(std::cin, ndim);
        std::vector<int> out_dims = ints(std::cin, ndim);
        auto g = pool_geom_ints(in_dims, out_dims);
        print(std::vector<long long>(g.begin(), g.end()));
      } else if (kind == "sentinel") {
        long long batch;
        int ndim;
        std::cin >> batch >> ndim;
        print({static_cast<long long>(grid_sentinel(ints(std::cin, ndim),
                                                    batch))});
      } else {
        std::cout << "unknown\n";
      }
    } catch (const std::exception&) {
      std::cout << "raise\n";
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """Runs a list of query lines through the harness; returns its lines."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    d = tmp_path_factory.mktemp("plans")
    (d / "plans_dump.cpp").write_text(HARNESS)
    r = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-Wall", "-Werror", "-I", str(CSRC),
         "-o", str(d / "plans_dump"), str(d / "plans_dump.cpp")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]

    def run(queries):
        r = subprocess.run([str(d / "plans_dump")],
                           input="".join(q + "\n" for q in queries),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr[-3000:]
        out = r.stdout.splitlines()
        assert len(out) == len(queries)
        return out

    return run


def _line(fields):
    return " ".join(str(int(f)) for f in fields)


def _py(fn):
    """``fn()``'s fields as the harness prints them, or "raise"."""
    try:
        out = fn()
    except (ValueError, NotImplementedError):
        return "raise"
    flat = []
    for f in out:
        flat.extend(f if isinstance(f, tuple) else (f,))
    return _line(flat)


def _ints(*vs):
    return " ".join(str(int(x)) for v in vs for x in v)


def _check(plans, cases):
    """``cases``: [(query, python thunk)]; every line equal."""
    got = plans([q for q, _ in cases])
    want = [_py(fn) for _, fn in cases]
    bad = [(q, g, w) for (q, _), g, w in zip(cases, got, want) if g != w]
    assert not bad, bad[:10]
    return want


@pytest.mark.parametrize("n", N)
def test_b1_plan_matches_python(plans, n):
    """``b1_plan`` (direct or windowed) over kernels, strides, divide and
    SM counts."""
    cases = []
    for ksize in KSIZES:
        for stride in STRIDES:
            for divide in (False, True):
                for sms in SMS:
                    q = f"b1 {n} {sms} {int(divide)} 3 {_ints(ksize, stride)}"
                    cases.append((q, lambda n=n, k=ksize, s=stride, d=divide,
                                  m=sms: TD.b1_plan(n, k, s, d, sms=m)))
    _check(plans, cases)


@pytest.mark.parametrize("n", N)
def test_b1_window_plan_matches_python(plans, n):
    """``b1_window_plan`` at every row count (the direct path's sizes
    too), at ndim 1-4, with the sorted divide tiles and a kernel whose line
    of offsets does not fit in shared memory (both raise)."""
    kernels = [(k, s) for k in KSIZES for s in STRIDES] + [
        ((5,), (2,)), ((3, 3), (2, 2)), ((3, 3, 3, 3), (2, 2, 2, 2)),
        ((1, 9, 9), (2, 2, 2)), ((1, 50, 50), (2, 2, 2))]
    cases = []
    for ksize, stride in kernels:
        for divide in (False, True):
            for sms in SMS:
                q = (f"b1w {n} {sms} {int(divide)} {len(ksize)} "
                     f"{_ints(ksize, stride)}")
                cases.append((q, lambda n=n, k=ksize, s=stride, d=divide,
                              m=sms: TD.b1_window_plan(n, k, s, d, sms=m)))
    want = _check(plans, cases)
    assert "raise" in want


@pytest.mark.parametrize("n", N)
def test_b2_variant_matches_python(plans, n):
    """``b2_variant`` at every channel pair, aligned or not, and K past
    256 (column tiles)."""
    cases = [(f"b2 {n} {c} {k} {int(a)}",
              lambda c=c, k=k, a=a: TD.b2_variant(n, c, k, aligned=a))
             for c, k in PAIRS + [(64, 512), (8, 1)] for a in (True, False)]
    _check(plans, cases)


@pytest.mark.parametrize("n", N)
def test_b7_variant_matches_python(plans, n):
    """``b7_variant`` (tile, grid, vec, packed) at every channel pair."""
    cases = [(f"b7 {n} {c} {k} {int(a)}",
              lambda c=c, k=k, a=a: TD.b7_variant(n, c, k, aligned=a))
             for c, k in PAIRS + [(64, 256), (16, 1)] for a in (True, False)]
    _check(plans, cases)


@pytest.mark.parametrize("m", N)
def test_b6_plan_matches_python(plans, m):
    """``b6_plan`` over channels (one 16-byte unit and less: lanes from
    ``bit_length`` at 0), f32 and bf16, ndim 1-4, aligned or not."""
    cases = []
    for c in CHANNELS + [1, 2, 4, 6, 12]:
        for itemsize in (4, 2):
            for ndim in (1, 2, 3, 4):
                for aligned in (True, False):
                    for sms in SMS:
                        q = (f"b6 {m} {c} {itemsize} {ndim} {int(aligned)} "
                             f"{sms}")
                        cases.append((q, lambda c=c, i=itemsize, d=ndim,
                                      a=aligned, s=sms: TS.b6_plan(
                                          m, c, i, d, aligned=a, sms=s)))
    _check(plans, cases)


GEOMS = [
    # (row_dims, tab_dims, stride, ksize, dilation, padding, divide)
    ((41, 1024, 1024), (80, 1024, 1024), (2, 1, 1), (3, 1, 1), (1, 1, 1),
     (1, 0, 0), False),
    ((80, 1024, 1024), (41, 1024, 1024), (2, 1, 1), (3, 1, 1), (1, 1, 1),
     (1, 0, 0), True),
    ((9, 10), (9, 10), (1, 1), (3, 3), (2, 2), (2, 2), False),
    ((7,), (4,), (2,), (2,), (1,), (0,), True),
    ((3, 4, 5, 6), (2, 2, 3, 3), (2, 2, 2, 2), (3, 3, 3, 3), (1, 1, 1, 1),
     (1, 1, 1, 1), False),
]


@pytest.mark.parametrize("geom", range(len(GEOMS)))
def test_geometry_packing_matches_python(plans, geom):
    """``TableGeom.ints``, ``_search_args``' geometry and ``launch_b6``'s,
    each padded to four axes as the kernels read it."""
    rows, tab, stride, ksize, dil, pad, divide = GEOMS[geom]
    ndim = len(ksize)
    tg = TD.TableGeom(rows, tab, stride, ksize, dil, pad, divide, False)
    sg = TD.SearchGeom.of(ksize, dil, rows, 1)
    got = plans([f"table {ndim} {_ints(rows, tab, stride, ksize, dil, pad)}",
                 f"search {ndim} {_ints(rows, ksize, dil)}",
                 f"pool {ndim} {_ints(tab, rows)}"])
    assert got[0] == _line(list(tg.ints()))
    assert got[1] == _line(list(TD._search_args(sg, "S1")[0]))
    pool = (ctypes.c_int * (1 + 2 * 4))(
        ndim, *(list(rows) + [1] * (4 - ndim)),
        *(list(tab) + [1] * (4 - ndim)))
    assert got[2] == _line(list(pool))


def test_grid_sentinel_matches_python(plans):
    """The sentinel of int32 and int64 grids, and the refusal past the
    two-word keys' capacity."""
    grids = [(1, (80, 1024, 1024)), (4, (160, 2048, 2048)), (2, (7,)),
             (1, (2**16, 2**16, 2**16)), (3, (1, 1, 1, 1)),
             (2**20, (2**20, 2**20, 2**20))]
    cases = [(f"sentinel {b} {len(s)} {_ints(s)}",
              lambda b=b, s=s: (TC.grid_sentinel(s, b),))
             for b, s in grids]
    want = _check(plans, cases)
    assert want[-1] == "raise" and want[1] == str(4 * 160 * 2048 * 2048)
