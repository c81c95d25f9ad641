"""The sweep behind B6's tile rule (``ops/sorted_pool.py::b6_plan``): each
tile of ``B6_TILES`` timed at the six BenchNet pools, bf16 and f32, max,
against the tile the rule picks.

The pools are those of ``chip_smoke.py``'s BenchNet (``benchmark.basic``'s
``synthetic_scan(0)``, pool bounds calibrated on seed 0, as
``tools/table_count.py`` builds the stages), each stage's keys pooled into
the next's at the stage's width (``benchmark.basic.CHANNELS``), features
uniform in [-1, 1) from seed 0.  Every tile's output is checked equal to
the rule's.  CUDA events over 20 launches after a warm-up.

Run:  python -m spconv_tpu_torch.tools.b6_tiles
"""

import sys

import torch

from .._build import load_library
from ..benchmark import basic as B
from ..ops import dg_conv as D
from ..ops import sorted_pool as S
from .ablation import cuda_ms
from .table_count import stage_keys


def main():
    dev = torch.device("cuda")
    sms = D.sm_count(dev.index or 0)
    lib = load_library()
    stages = stage_keys(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}; B6 max, ms a pool at each "
          f"tile of {S.B6_TILES} (* the rule's)")
    for p in range(len(stages) - 1):
        (in_keys, in_dims), (out_keys, out_dims) = stages[p], stages[p + 1]
        c = B.CHANNELS[2 * p + 1]
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.rand((in_keys.shape[0], c), generator=gen,
                            device=dev) * 2 - 1).to(dt)
            args = (x, in_keys, out_keys, in_dims, out_dims, 1, "max")
            m = out_keys.shape[0]
            rule = S.b6_plan(m, c, x.element_size(), len(in_dims), sms=sms)
            want = torch.empty((m, c), dtype=dt, device=dev)
            if S.launch_b6(lib, *args, rule, want):
                raise RuntimeError(f"pool{p}: B6 launch failed")
            cells = []
            for tile in S.B6_TILES:
                plan = S.b6_plan(m, c, x.element_size(), len(in_dims),
                                 sms=sms, tile=tile)
                out = torch.empty_like(want)
                ms = cuda_ms(lambda: S.launch_b6(lib, *args, plan, out), 20)
                if not torch.equal(out, want):
                    raise RuntimeError(f"pool{p} tile {tile}: output "
                                       "differs from the rule's tile")
                cells.append(f"{tile}:{ms:.4f}"
                             f"{'*' if tile == rule.tile else ''}")
            print(f"pool{p} M {m:6d} C {c:3d} {str(dt)[6:]:8s} "
                  + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
