#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (every check raises, so a failure exits non-zero before the last
line is printed):
1. the card: CUDA must be available; prints nvidia-smi's name and power
   limit;
2. builds the CUDA kernels from ``spconv_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version at every stage shape
   of the benchmark net on a synthetic scan, in f32 and bf16, with CUDA-event
   times of both;
4. serves the full-width bf16 benchmark net (14 SubMConv3d, 6 max pools) on
   three synthetic scans after one warm-up, through the port's kernels, and
   checks launch counts, output sanity, per-stage coordinates against a
   plain-version run on the card, and an f32 run against plain;
5. prints a JSON line of the kernels, then the result line.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (80, 1600, 1600)
KSIZE = (3, 3, 3)
DIL = (1, 1, 1)
N_VOXELS = 125_562  # the reference's real scan has this many
REQUEST_SEEDS = (0, 1, 2)
# kernel vs plain, as fractions of max|plain|: f32 sums in another order;
# bf16 may also flip one output rounding (2**-7 relative)
TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
NET_F32_TOL = 1e-4  # whole net, f32, kernel vs plain


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` launches on the current stream,
    after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_forward_stages(torch, net, x):
    """The benchmark net's forward with the plain versions of both kernels
    in place of the kernels, on whatever device ``x`` is on."""
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D

    stages = []
    for stage in range(7):
        if stage:
            x = net.pools[stage - 1](x)
        keys, _ = C.linearize(x.indices, x.spatial_shape, x.batch_size)
        pos = D.dg_pos_plain(keys, ksize=KSIZE, dilation=DIL,
                             spatial_shape=x.spatial_shape,
                             batch_size=x.batch_size)
        for conv in net.convs[2 * stage:2 * stage + 2]:
            out = D.dg_fwd_plain(x.features,
                                 D.weight_krsc_to_kv(conv.weight), pos)
            out = torch.where(x.valid_mask[:, None], out,
                              torch.zeros_like(out))
            x = SparseConvTensor(out, x.indices, x.spatial_shape,
                                 x.batch_size, keys_sorted=True)
        stages.append(x)
    return stages


def main():
    if not (ROOT / "spconv_tpu_torch" / "__init__.py").is_file():
        fail(f"no spconv_tpu_torch package beside {Path(__file__).name}; "
             "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    DTYPES = (torch.float32, torch.bfloat16)

    # ---- 1. the card -------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False; "
          "this smoke run has no CPU path")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----------------------------------------------------
    from spconv_tpu_torch._build import build_library, load_library

    path, secs, log = build_library()
    load_library()
    print(f"build: {path.name} in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.modules import SparseMaxPool3d
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D

    # ---- 3. each kernel against its plain version --------------------
    t0 = time.perf_counter()
    scans = {s: B.synthetic_scan(s, SHAPE, N_VOXELS) for s in REQUEST_SEEDS}
    print(f"synthetic scans: {time.perf_counter() - t0:.2f} s on the host, "
          f"{[len(scans[s][0]) for s in REQUEST_SEEDS]} voxels")
    x0 = B.make_bench_input(*scans[0], device=dev)
    bounds = B.measure_pool_bounds(SHAPE, x0)
    print(f"pool bounds (calibrated on seed 0, +5 %): {bounds}")

    # the stage inputs: pools only (convs keep coordinates)
    geo = [x0]
    for s in range(6):
        geo.append(SparseMaxPool3d(2, 2, out_bound=bounds[s])(geo[-1]))
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"dg_pos": 0.0, "dg_fwd": 0.0}

    def fwd_cases(g, pos, c, k):
        """B2 kernel against plain on random features of the active rows
        of ``g`` and random [27, c, k] weights, per dtype: yields
        ``(x, w, max|d|/max|ref|)`` after checking the tolerance."""
        xf = torch.randn((g.indices.shape[0], c), device=dev,
                         generator=gen) * g.valid_mask[:, None]
        wf = torch.randn((27, c, k), device=dev, generator=gen) \
            / float(np.sqrt(27 * c))
        for dt in DTYPES:
            name = str(dt)[6:]
            x, w = xf.to(dt).contiguous(), wf.to(dt).contiguous()
            got = D.dg_fwd(x, w, pos).float()
            ref = D.dg_fwd_plain(x, w, pos).float()
            torch.cuda.synchronize()
            diff = (got - ref).abs().max().item()
            rel = diff / max(ref.abs().max().item(), 1e-30)
            check(np.isfinite(rel) and rel <= TOL[name],
                  f"dg_fwd {name} C={c} K={k} N={x.shape[0]}: "
                  f"{rel:.3e} > {TOL[name]}")
            check(not got[~g.valid_mask].any(),
                  f"dg_fwd wrote non-zero invalid rows (C={c} K={k})")
            err["dg_fwd"] = max(err["dg_fwd"], diff)
            yield x, w, rel

    tot = {"dg_pos": [0.0, 0.0], "dg_fwd": [0.0, 0.0]}  # bf16 net sums
    tables = []
    print("stage  N_buf  active  kernel            dtype      C    K   "
          "max|d|/max|ref|  kernel_ms  plain_ms")
    for s, g in enumerate(geo):
        n, act = g.indices.shape[0], int(g.num_voxels)
        keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=g.spatial_shape,
                    batch_size=1)
        pk = D.build_dg_pos(keys, **geom)
        tables.append(pk)
        pp = D.dg_pos_plain(keys, **geom)
        torch.cuda.synchronize()
        d = (pk.long() - pp.long()).abs().max().item() if n else 0
        err["dg_pos"] = max(err["dg_pos"], float(d))
        check(d == 0, f"dg_pos differs from plain at stage {s}")
        km = cuda_ms(torch, lambda: D.build_dg_pos(keys, **geom), 20)
        pm = cuda_ms(torch, lambda: D.dg_pos_plain(keys, **geom), 5)
        tot["dg_pos"][0] += km
        tot["dg_pos"][1] += pm
        print(f"{s:5d} {n:6d} {act:7d}  dg_pos            int32      -    - "
              f"  {float(d):15.3e}  {km:9.4f}  {pm:8.4f}")
        for layer in (2 * s, 2 * s + 1):
            c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
            for dt, (x, w, rel) in zip(DTYPES, fwd_cases(g, pk, c, k)):
                km = cuda_ms(torch, lambda: D.dg_fwd(x, w, pk), 10)
                pm = cuda_ms(torch, lambda: D.dg_fwd_plain(x, w, pk), 3)
                if dt == torch.bfloat16:
                    tot["dg_fwd"][0] += km
                    tot["dg_fwd"][1] += pm
                print(f"{s:5d} {n:6d} {act:7d}  dg_fwd  conv{layer:<3d}    "
                      f"{str(dt)[6:]:9s} {c:4d} {k:4d}  {rel:15.3e}  "
                      f"{km:9.4f}  {pm:8.4f}")
    # every other width at the stage-0 shape too (checked, not timed)
    for layer in range(2, 14):
        c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
        rels = [rel for _, _, rel in fwd_cases(geo[0], tables[0], c, k)]
        print(f"    0 stage-0 shape  dg_fwd conv{layer} widths C={c} K={k}: "
              f"max|d|/max|ref| f32 {rels[0]:.3e}, bf16 {rels[1]:.3e}")
    print(f"per bf16 forward: dg_pos {tot['dg_pos'][0]:.4f} ms "
          f"(plain {tot['dg_pos'][1]:.4f}), dg_fwd {tot['dg_fwd'][0]:.4f} ms "
          f"(plain {tot['dg_fwd'][1]:.4f})")

    # ---- 4. serve ----------------------------------------------------
    net = B.BenchNet(SHAPE, dtype=torch.bfloat16, pool_bounds=bounds,
                     device=dev, seed=0).eval()
    net32 = B.BenchNet(SHAPE, dtype=torch.float32, pool_bounds=bounds,
                       device=dev, seed=0).eval()
    with torch.inference_mode():
        net(B.make_bench_input(*scans[0], dtype=torch.bfloat16,
                               device=dev))  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        served = []
        for seed in REQUEST_SEEDS:
            x = B.make_bench_input(*scans[seed], dtype=torch.bfloat16,
                                   device=dev)
            torch.cuda.synchronize()
            pos0, fwd0 = D.dg_pos_launches, D.dg_fwd_launches
            t0 = time.perf_counter()
            stages = net.forward_stages(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check((D.dg_pos_launches - pos0, D.dg_fwd_launches - fwd0)
                  == (7, 14), f"request {seed}: launches "
                  f"{D.dg_pos_launches - pos0}/{D.dg_fwd_launches - fwd0}, "
                  "expected 7 dg_pos / 14 dg_fwd")
            served.append((seed, x, stages, ms))
        launches = {"dg_pos": D.dg_pos_launches,
                    "dg_fwd": D.dg_fwd_launches}

        for seed, x, stages, ms in served:
            out = stages[-1]
            active = [int(t.num_voxels) for t in stages]
            check(active[-1] > 0, f"request {seed}: empty output")
            check(bool(torch.isfinite(out.features).all()),
                  f"request {seed}: non-finite output")
            check(tuple(out.features.shape[1:]) == (256,),
                  f"request {seed}: output width {out.features.shape}")
            for s, t in enumerate(stages[1:], 1):
                # the pool that opened this stage kept every output
                check(t.num_out_total is None
                      or int(t.num_out_total) == int(t.num_voxels),
                      f"request {seed}: pool {s} overflowed its bound")
            ref = plain_forward_stages(torch, net, x)
            for s, (g, r) in enumerate(zip(stages, ref)):
                check(torch.equal(g.indices, r.indices),
                      f"request {seed}: stage {s} coordinates differ from "
                      "the plain run")
            bf_rel = ((out.features.float() - ref[-1].features.float())
                      .abs().max() / ref[-1].features.float().abs().max())
            x32 = B.make_bench_input(*scans[seed], device=dev)
            got32 = net32(x32).features
            ref32 = plain_forward_stages(torch, net32, x32)[-1].features
            rel32 = ((got32 - ref32).abs().max()
                     / ref32.abs().max()).item()
            check(rel32 <= NET_F32_TOL, f"request {seed}: f32 net "
                  f"{rel32:.3e} > {NET_F32_TOL} of max|ref|")
            matched = B.matched_offsets_per_voxel(stages[0], "c0")
            print(f"request seed={seed} input=synthetic ms={ms:.3f} "
                  f"active_per_stage={active} "
                  f"stage0_matched_offsets={matched:.3f} "
                  f"f32_net_rel_err={rel32:.3e} "
                  f"bf16_net_rel_vs_plain={bf_rel.item():.3e}")

    kernels = [
        {"name": "dg_pos", "route": "cuda",
         "source": "spconv_tpu_torch/csrc/dg_pos.cu",
         "replaces": "spconv_tpu/ops/pallas/dg_conv.py:710",
         "launches": launches["dg_pos"], "max_abs_err": err["dg_pos"],
         "ms": tot["dg_pos"][0], "plain_ms": tot["dg_pos"][1]},
        {"name": "dg_fwd", "route": "cuda",
         "source": "spconv_tpu_torch/csrc/dg_fwd.cu",
         "replaces": "spconv_tpu/ops/pallas/dg_conv.py:339",
         "launches": launches["dg_fwd"], "max_abs_err": err["dg_fwd"],
         "ms": tot["dg_fwd"][0], "plain_ms": tot["dg_fwd"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
