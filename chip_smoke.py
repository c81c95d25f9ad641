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
   times of both: the match table forward and reversed, the gather-GEMM
   forward, dgrad and wgrad;
4. serves the full-width bf16 benchmark net (14 SubMConv3d, 6 max pools) on
   three synthetic scans after one warm-up, through the port's kernels, and
   checks launch counts, output sanity, per-stage coordinates against a
   plain-version run on the card, and an f32 run against plain;
   It also holds the strided conv's kernels (the affine match table and
   the gather-GEMM on it) and the subm kernels against their plain versions
   at every layer shape of the CenterPoint encoder on its synthetic scan;
5. trains: one SGD step of the bf16 net per synthetic scan after a warm-up
   step, with launch counts, finite non-zero grads and step times; the f32
   net's grads through the kernels against the same step through the plain
   versions of the backward; and an ``algo="sk"`` conv pair against
   ``algo="dg"``;
6. serves the CenterPoint encoder (``centerpoint_encoder(in_channels=5,
   bn=False)``, bf16, buffers calibrated on seed 0) to its BEV map on three
   synthetic 113,000-voxel scans after one warm-up, and checks launch
   counts, per-stage coordinates against a plain-version run on the card,
   an f32 run against plain, a finite non-zero BEV map, and an
   ``algo="sk"`` downsample against ``algo="dg"``;
7. prints a JSON line of the kernels, then the result line.
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
# wgrad sums up to ~126k products per entry in another order
WGRAD_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
NET_F32_TOL = 1e-4  # whole net forward, f32, kernel vs plain
# whole-net weight grads, f32, kernels vs a run whose forward also goes
# through B2 but whose backward takes the plain versions, per tensor: sums
# in another order.  (With the plain forward as well, a max pool may break
# a near-tie the other way and route a gradient to another child; that
# comparison is printed, not gated.)
GRAD_F32_TOL = 1e-4
SK_STAGE = 2  # the 96 -> 128 -> 128 pair of the net
CP_STRIDED = ("down1", "down2", "down3", "out")  # indice_keys, in order
# per CenterPoint request: 4 subm and 4 affine tables, 17 subm and 4
# strided gather-GEMMs (models/second.py)
CP_LAUNCHES = dict(dg_pos=4, dg_pos_rev=0, dg_pos_affine=4, dg_fwd=17,
                   dg_fwd_strided=4, dg_dgrad=0, dg_wgrad=0)


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


def rel_err(torch, got, ref):
    """``(max|got - ref|, that / max|ref|)`` in f32."""
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def plain_conv_fn(torch, D, fwd):
    """An autograd Function whose backward takes the plain versions
    ``dg_dgrad_plain`` and ``dg_wgrad_plain`` the way ``DGSubmConvFn``
    runs the kernels; its forward is ``fwd`` (``dg_fwd_plain``, or the B2
    kernel to hold the backward alone against the kernels)."""

    class PlainConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, pos, pos_rev):
            ctx.save_for_backward(x, w, pos_rev)
            return fwd(x, w, pos)

        @staticmethod
        def backward(ctx, dout):
            x, w, pos_rev = ctx.saved_tensors
            dout = dout.to(x.dtype).contiguous()
            din = (D.dg_dgrad_plain(dout, w, pos_rev)
                   if ctx.needs_input_grad[0] else None)
            return din, D.dg_wgrad_plain(x, dout, pos_rev), None, None

    return PlainConv


def plain_forward_stages(torch, net, x, train=False, kernel_fwd=False):
    """The benchmark net's forward with the plain versions of the kernels
    in place of the kernels, on whatever device ``x`` is on; with
    ``train``, differentiable through the plain backward, and with
    ``kernel_fwd`` as well, whose convs' forward runs B2."""
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D

    plain = plain_conv_fn(torch, D, D.dg_fwd if kernel_fwd
                          else D.dg_fwd_plain)
    stages = []
    for stage in range(7):
        if stage:
            x = net.pools[stage - 1](x)
        keys, _ = C.linearize(x.indices, x.spatial_shape, x.batch_size)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=x.spatial_shape,
                    batch_size=x.batch_size)
        pos = D.dg_pos_plain(keys, **geom)
        pos_rev = D.dg_pos_plain(keys, reverse=True, **geom) if train else None
        for conv in net.convs[2 * stage:2 * stage + 2]:
            wkv = D.weight_krsc_to_kv(conv.weight)
            if train:
                out = plain.apply(x.features, wkv, pos, pos_rev)
            else:
                out = D.dg_fwd_plain(x.features, wkv, pos)
            out = torch.where(x.valid_mask[:, None], out,
                              torch.zeros_like(out))
            x = SparseConvTensor(out, x.indices, x.spatial_shape,
                                 x.batch_size, keys_sorted=True)
        stages.append(x)
    return stages


def plain_encoder_stages(torch, net, x):
    """The ``bn=False`` CenterPoint encoder's ``forward_stages`` with the
    plain versions of the kernels in place of the kernels, on whatever
    device ``x`` is on (output discovery is plain tensor code in both)."""
    import torch.nn.functional as F
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops.rulebook import build_conv_outputs

    def conv(layer, x, pos, valid):
        out = D.dg_fwd_plain(x.features, D.weight_krsc_to_kv(layer.weight),
                             pos) + layer.bias
        return torch.where(valid[:, None], out, torch.zeros_like(out))

    def subm_pos(x):
        keys, _ = C.linearize(x.indices, x.spatial_shape, x.batch_size)
        return D.dg_pos_plain(keys, ksize=KSIZE, dilation=DIL,
                              spatial_shape=x.spatial_shape,
                              batch_size=x.batch_size)

    def strided(layer, x):
        geom = dict(ksize=layer.kernel_size, stride=layer.stride,
                    padding=layer.padding, dilation=layer.dilation)
        out_indices, out_keys, num_out, _ = build_conv_outputs(
            x.indices, spatial_shape=x.spatial_shape,
            batch_size=x.batch_size, out_bound=layer.out_bound, **geom)
        out_shape = C.get_conv_output_size(
            x.spatial_shape, layer.kernel_size, layer.stride, layer.padding,
            layer.dilation)
        in_keys, _ = C.linearize(x.indices, x.spatial_shape, x.batch_size)
        pos = D.dg_pos_affine_plain(
            in_keys, out_keys, in_shape=x.spatial_shape, out_shape=out_shape,
            batch_size=x.batch_size, **geom)
        return SparseConvTensor(conv(layer, x, pos, out_indices[:, 0] >= 0),
                                out_indices, out_shape, x.batch_size,
                                num_voxels=num_out, keys_sorted=True)

    pos = subm_pos(x)
    x = x.replace_feature(F.relu(conv(net.conv_input, x, pos,
                                      x.valid_mask)))
    stages = []
    for si, blocks in enumerate(net.stages):
        if si:
            x = strided(net.downs[si - 1], x)
            pos = subm_pos(x)
        for block in blocks:
            h = F.relu(conv(block.conv1, x, pos, x.valid_mask))
            h = conv(block.conv2, x.replace_feature(h), pos, x.valid_mask)
            x = x.replace_feature_masked(F.relu(h + x.features))
        stages.append(x)
    x = strided(net.conv_out, x)
    stages.append(x.replace_feature(F.relu(x.features)))
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
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.modules import SparseMaxPool3d, SubMConv3d
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
    names = ("dg_pos", "dg_pos_rev", "dg_fwd", "dg_dgrad", "dg_wgrad")
    strided_names = ("dg_pos_affine", "dg_fwd_strided")
    # max |kernel - plain| over the checks, and the same over max|plain|
    err = dict.fromkeys(names + strided_names, 0.0)
    rel = dict.fromkeys(names + strided_names, 0.0)

    def note(kern, diff, r):
        err[kern] = max(err[kern], diff)
        rel[kern] = max(rel[kern], r)
    # [kernel ms, plain ms] summed over one bf16 forward (dg_pos, dg_fwd)
    # or one bf16 training step's backward (the rest)
    tot = {k: [0.0, 0.0] for k in names}
    per_layer = {}  # (layer, kernel) -> (bf16 kernel ms, plain ms)

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
            got = D.dg_fwd(x, w, pos)
            ref = D.dg_fwd_plain(x, w, pos)
            diff, r = rel_err(torch, got, ref)
            check(np.isfinite(r) and r <= TOL[name],
                  f"dg_fwd {name} C={c} K={k} N={x.shape[0]}: "
                  f"{r:.3e} > {TOL[name]}")
            check(not got[~g.valid_mask].any(),
                  f"dg_fwd wrote non-zero invalid rows (C={c} K={k})")
            note("dg_fwd", diff, r)
            yield x, w, r

    def bwd_case(g, rev, x, w, layer):
        """dgrad and wgrad kernels against plain for the layer's ``x`` and
        weights and a random ``dout`` on the active rows; checks the
        tolerances, zero invalid rows of din, bit-equal repeated wgrad,
        and times both (bf16 times go into the step totals)."""
        c, k = w.shape[1], w.shape[2]
        dout = (torch.randn((x.shape[0], k), device=dev, generator=gen)
                * g.valid_mask[:, None]).to(x.dtype)
        name = str(x.dtype)[6:]
        din = D.dg_dgrad(dout, w, rev)
        d_diff, d_rel = rel_err(torch, din, D.dg_dgrad_plain(dout, w, rev))
        check(np.isfinite(d_rel) and d_rel <= TOL[name],
              f"dg_dgrad {name} C={c} K={k}: {d_rel:.3e} > {TOL[name]}")
        check(not din[~g.valid_mask].any(),
              f"dg_dgrad wrote non-zero invalid rows (C={c} K={k})")
        dw = D.dg_wgrad(x, dout, rev)
        w_diff, w_rel = rel_err(torch, dw, D.dg_wgrad_plain(x, dout, rev))
        check(np.isfinite(w_rel) and w_rel <= WGRAD_TOL[name],
              f"dg_wgrad {name} C={c} K={k}: {w_rel:.3e} > "
              f"{WGRAD_TOL[name]}")
        check(torch.equal(dw, D.dg_wgrad(x, dout, rev)),
              f"dg_wgrad {name} C={c} K={k}: two runs differ")
        note("dg_dgrad", d_diff, d_rel)
        note("dg_wgrad", w_diff, w_rel)
        times = {
            "dg_dgrad": (cuda_ms(torch, lambda: D.dg_dgrad(dout, w, rev), 10),
                         cuda_ms(torch, lambda: D.dg_dgrad_plain(dout, w, rev),
                                 2)),
            "dg_wgrad": (cuda_ms(torch, lambda: D.dg_wgrad(x, dout, rev), 10),
                         cuda_ms(torch, lambda: D.dg_wgrad_plain(x, dout, rev),
                                 2)),
        }
        if x.dtype == torch.bfloat16:
            for kern, (km, pm) in times.items():
                per_layer[(layer, kern)] = (km, pm)
                if kern == "dg_dgrad" and layer == 0:
                    continue  # the input features need no gradient
                tot[kern][0] += km
                tot[kern][1] += pm
        return d_rel, w_rel, times

    tables = []
    print("stage  N_buf  active  kernel            dtype      C    K   "
          "max|d|/max|ref|  kernel_ms  plain_ms")
    for s, g in enumerate(geo):
        n, act = g.indices.shape[0], int(g.num_voxels)
        keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=g.spatial_shape,
                    batch_size=1)
        pk = D.build_dg_pos(keys, **geom)
        rev = D.build_dg_pos(keys, reverse=True, **geom)
        tables.append(pk)
        for kern, got, plain in (
                ("dg_pos", pk, D.dg_pos_plain(keys, **geom)),
                ("dg_pos_rev", rev,
                 D.dg_pos_plain(keys, reverse=True, **geom))):
            d = (got.long() - plain.long()).abs().max().item() if n else 0
            note(kern, float(d), float(d))
            check(d == 0, f"{kern} differs from plain at stage {s}")
            r = kern == "dg_pos_rev"
            km = cuda_ms(torch, lambda: D.build_dg_pos(keys, reverse=r,
                                                       **geom), 20)
            pm = cuda_ms(torch, lambda: D.dg_pos_plain(keys, reverse=r,
                                                       **geom), 3)
            tot[kern][0] += km
            tot[kern][1] += pm
            print(f"{s:5d} {n:6d} {act:7d}  {kern:17s} int32      -    - "
                  f"  {float(d):15.3e}  {km:9.4f}  {pm:8.4f}")
        check(torch.equal(rev, pk.flip(0)),
              f"stage {s}: the reversed table is not the forward one "
              "flipped on its offset axis")
        for layer in (2 * s, 2 * s + 1):
            c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
            for dt, (x, w, r) in zip(DTYPES, fwd_cases(g, pk, c, k)):
                km = cuda_ms(torch, lambda: D.dg_fwd(x, w, pk), 10)
                pm = cuda_ms(torch, lambda: D.dg_fwd_plain(x, w, pk), 3)
                dtn = str(dt)[6:]
                if dt == torch.bfloat16:
                    per_layer[(layer, "dg_fwd")] = (km, pm)
                    tot["dg_fwd"][0] += km
                    tot["dg_fwd"][1] += pm
                print(f"{s:5d} {n:6d} {act:7d}  dg_fwd   conv{layer:<3d}   "
                      f"{dtn:9s} {c:4d} {k:4d}  {r:15.3e}  "
                      f"{km:9.4f}  {pm:8.4f}")
                d_rel, w_rel, times = bwd_case(g, rev, x, w, layer)
                for kern, rel_b in (("dg_dgrad", d_rel), ("dg_wgrad", w_rel)):
                    km, pm = times[kern]
                    print(f"{s:5d} {n:6d} {act:7d}  {kern} conv{layer:<3d}   "
                          f"{dtn:9s} {c:4d} {k:4d}  {rel_b:15.3e}  "
                          f"{km:9.4f}  {pm:8.4f}")
    # every other width at the stage-0 shape too (checked, not timed)
    for layer in range(2, 14):
        c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
        rels = [r for _, _, r in fwd_cases(geo[0], tables[0], c, k)]
        print(f"    0 stage-0 shape  dg_fwd conv{layer} widths C={c} K={k}: "
              f"max|d|/max|ref| f32 {rels[0]:.3e}, bf16 {rels[1]:.3e}")
    print(f"per bf16 forward: dg_pos {tot['dg_pos'][0]:.4f} ms "
          f"(plain {tot['dg_pos'][1]:.4f}), dg_fwd {tot['dg_fwd'][0]:.4f} ms "
          f"(plain {tot['dg_fwd'][1]:.4f})")
    print(f"per bf16 training step, backward: dg_pos_rev "
          f"{tot['dg_pos_rev'][0]:.4f} ms (plain {tot['dg_pos_rev'][1]:.4f}),"
          f" dg_dgrad {tot['dg_dgrad'][0]:.4f} ms (plain "
          f"{tot['dg_dgrad'][1]:.4f}), dg_wgrad {tot['dg_wgrad'][0]:.4f} ms "
          f"(plain {tot['dg_wgrad'][1]:.4f})")

    # the CenterPoint encoder's layer shapes on its synthetic scan: the
    # calibrated bf16 net (served in phase 6) gives every layer's input
    from spconv_tpu_torch.benchmark import centerpoint as CPB
    from spconv_tpu_torch.calibrate import export_out_bounds

    t0 = time.perf_counter()
    cp_in = {s: CPB.synthetic_centerpoint_input(s, device=dev)[0]
             for s in REQUEST_SEEDS}
    print(f"CenterPoint synthetic scans: {time.perf_counter() - t0:.2f} s "
          f"on the host, {[int(cp_in[s].num_voxels) for s in REQUEST_SEEDS]}"
          f" voxels in {cp_in[0].indices.shape[0]} rows, grid "
          f"{cp_in[0].spatial_shape}")
    t0 = time.perf_counter()
    cp_net = CPB.build_calibrated_encoder(cp_in[0], dtype=torch.bfloat16)
    cp_bounds = export_out_bounds(cp_net)
    print(f"CenterPoint bounds (f32 calibration on seed 0, x1.15, to 512): "
          f"{[b for b in cp_bounds if b is not None]} in "
          f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        cp_rec = cp_net(cp_in[0].replace_feature(
            cp_in[0].features.bfloat16())).indice_dict
    cp_tot = {k: [0.0, 0.0] for k in ("cp_dg_pos", "cp_dg_fwd")
              + strided_names}
    cp_layer_ms = []  # (layer, C, K, times per request, bf16 ms, plain ms)

    def cp_gemm(kern, fn, plain, valid_in, valid_out, pos, c, k, layer,
                mult):
        """A gather-GEMM kernel against plain on random features of the
        active input rows and random [kv, c, k] weights, f32 and bf16;
        checks the tolerance and zero inactive output rows, times both."""
        kv = pos.shape[0]
        xf = (torch.randn((valid_in.shape[0], c), device=dev, generator=gen)
              * valid_in[:, None])
        wf = torch.randn((kv, c, k), device=dev, generator=gen) \
            / float(np.sqrt(kv * c))
        for dt in DTYPES:
            dtn = str(dt)[6:]
            x, w = xf.to(dt).contiguous(), wf.to(dt).contiguous()
            got = fn(x, w, pos)
            diff, r = rel_err(torch, got, plain(x, w, pos))
            check(np.isfinite(r) and r <= TOL[dtn],
                  f"{kern} {layer} {dtn}: {r:.3e} > {TOL[dtn]}")
            check(not got[~valid_out].any(),
                  f"{kern} {layer}: non-zero inactive output rows")
            note(kern, diff, r)
            km = cuda_ms(torch, lambda: fn(x, w, pos), 10)
            pm = cuda_ms(torch, lambda: plain(x, w, pos), 3)
            print(f"  cp {layer:10s} {kern:14s} {dtn:9s} {c:4d} {k:4d} "
                  f"N_in {x.shape[0]:6d} N_out {pos.shape[1]:6d}  "
                  f"{r:12.3e}  {km:9.4f}  {pm:8.4f}")
            if dt == torch.bfloat16:
                cp_layer_ms.append((layer, c, k, mult, km, pm))
                tot_key = "cp_dg_fwd" if kern == "dg_fwd" else kern
                cp_tot[tot_key][0] += mult * km
                cp_tot[tot_key][1] += mult * pm

    def cp_table(kern, build, plain, layer):
        """A match-table kernel against plain (exact), both timed."""
        got, want = build(), plain()
        d = (got.long() - want.long()).abs().max().item() if got.numel() \
            else 0
        note("dg_pos" if kern == "cp_dg_pos" else kern, float(d), float(d))
        check(d == 0, f"{kern} {layer} differs from plain")
        km, pm = cuda_ms(torch, build, 20), cuda_ms(torch, plain, 3)
        cp_tot[kern][0] += km
        cp_tot[kern][1] += pm
        print(f"  cp {layer:10s} {kern:14s} int32     kv {got.shape[0]:3d} "
              f"N_out {got.shape[1]:6d}  exact  {km:9.4f}  {pm:8.4f}")
        return got

    print("CenterPoint layers: layer kernel dtype C K N_in N_out "
          "max|d|/max|ref| kernel_ms plain_ms")
    widths = (16, 32, 64, 128)
    for si, c in enumerate(widths):
        if si:
            rec = cp_rec[f"__dgreg__down{si}"]
            inds, shape = rec.out_indices, rec.out_shape
        else:
            inds, shape = cp_in[0].indices, cp_in[0].spatial_shape
        valid = inds[:, 0] >= 0
        keys, _ = C.linearize(inds, shape, 1)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=shape,
                    batch_size=1)
        pos = cp_table("cp_dg_pos", lambda: D.build_dg_pos(keys, **geom),
                       lambda: D.dg_pos_plain(keys, **geom), f"subm{si}")
        if not si:
            cp_gemm("dg_fwd", D.dg_fwd, D.dg_fwd_plain, valid, valid, pos,
                    5, c, "conv_input", 1)
        cp_gemm("dg_fwd", D.dg_fwd, D.dg_fwd_plain, valid, valid, pos, c, c,
                f"subm{si}", 4)
    for key, (c, k) in zip(CP_STRIDED, ((16, 32), (32, 64), (64, 128),
                                       (128, 128))):
        rec = cp_rec[f"__dgreg__{key}"]
        geom = dict(ksize=rec.ksize, stride=rec.stride, padding=rec.padding,
                    dilation=rec.dilation, in_shape=rec.in_shape,
                    out_shape=rec.out_shape, batch_size=1)
        pos = cp_table(
            "dg_pos_affine",
            lambda: D.build_dg_pos_affine(rec.in_keys, rec.out_keys, **geom),
            lambda: D.dg_pos_affine_plain(rec.in_keys, rec.out_keys, **geom),
            key)
        cp_gemm("dg_fwd_strided", D.dg_fwd_strided, D.dg_fwd_plain,
                cp_rec[f"__dgreg_in__{key}"][:, 0] >= 0,
                rec.out_indices[:, 0] >= 0, pos, c, k, key, 1)
    print("per bf16 CenterPoint request: " + ", ".join(
        f"{k} {v[0]:.4f} ms (plain {v[1]:.4f})" for k, v in cp_tot.items()))

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
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            stages = net.forward_stages(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: D.launch_counts[k] - before[k] for k in names}
            check(got == dict(dg_pos=7, dg_pos_rev=0, dg_fwd=14, dg_dgrad=0,
                              dg_wgrad=0),
                  f"request {seed}: launches {got}, expected 7 dg_pos and "
                  "14 dg_fwd only")
            check(all(stages[-1].indice_dict[f"c{i}"].pos_rev is None
                      for i in range(7)),
                  f"request {seed}: a reversed table was built in inference")
            served.append((seed, x, stages, ms))
        serve_launches = dict(D.launch_counts)

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
            _, bf_rel = rel_err(torch, out.features, ref[-1].features)
            x32 = B.make_bench_input(*scans[seed], device=dev)
            _, rel32 = rel_err(torch, net32(x32).features,
                               plain_forward_stages(torch, net32,
                                                    x32)[-1].features)
            check(rel32 <= NET_F32_TOL, f"request {seed}: f32 net "
                  f"{rel32:.3e} > {NET_F32_TOL} of max|ref|")
            matched = B.matched_offsets_per_voxel(stages[0], "c0")
            print(f"request seed={seed} input=synthetic ms={ms:.3f} "
                  f"active_per_stage={active} "
                  f"stage0_matched_offsets={matched:.3f} "
                  f"f32_net_rel_err={rel32:.3e} "
                  f"bf16_net_rel_vs_plain={bf_rel:.3e}")

    # ---- 5. train ----------------------------------------------------
    step_launches = dict(dg_pos=7, dg_pos_rev=7, dg_fwd=14, dg_dgrad=13,
                         dg_wgrad=14)
    net = B.BenchNet(SHAPE, dtype=torch.bfloat16, pool_bounds=bounds,
                     device=dev, seed=0)
    xs = {s: B.make_bench_input(*scans[s], dtype=torch.bfloat16, device=dev)
          for s in REQUEST_SEEDS}
    B.train_step(net, xs[0], 0.0)  # warm-up, no update
    torch.cuda.synchronize()
    # a step that moves the largest weight by 1 % of the largest weight
    lr = 1e-2 * max(p.abs().max().item() for p in net.parameters()) / max(
        p.grad.abs().max().item() for p in net.parameters())
    print(f"train: bf16 BenchNet, SGD lr={lr:.4e}")
    D.reset_launch_counts()
    for seed in REQUEST_SEEDS:
        w_before = [p.detach().clone() for p in net.parameters()]
        torch.cuda.synchronize()
        before = dict(D.launch_counts)
        t0 = time.perf_counter()
        loss = B.train_step(net, xs[seed], lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: D.launch_counts[k] - before[k] for k in names}
        check(got == step_launches, f"train step {seed}: launches {got}, "
              f"expected {step_launches}")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0, f"train step {seed}: loss "
              f"{loss}")
        for (name, p), w0 in zip(net.named_parameters(), w_before):
            check(p.grad is not None and p.grad.dtype == torch.bfloat16,
                  f"train step {seed}: {name} has no bf16 grad")
            check(bool(torch.isfinite(p.grad).all()),
                  f"train step {seed}: {name} grad not finite")
            check(bool(p.grad.any()), f"train step {seed}: {name} grad is 0")
            check(not torch.equal(p.detach(), w0),
                  f"train step {seed}: {name} was not updated")
        print(f"train step seed={seed} input=synthetic ms={ms:.3f} "
              f"loss={loss:.6e} launches={got}")
    train_launches = dict(D.launch_counts)

    # the f32 net: grads through the kernels vs through the plain versions
    nets = [B.BenchNet(SHAPE, dtype=torch.float32, pool_bounds=bounds,
                       device=dev, seed=0) for _ in range(3)]
    x32 = B.make_bench_input(*scans[0], device=dev)
    losses = [B.train_step(nets[0], x32, 0.0).item()]
    for net_p, kernel_fwd in zip(nets[1:], (True, False)):
        loss_p = (plain_forward_stages(torch, net_p, x32, train=True,
                                       kernel_fwd=kernel_fwd)[-1]
                  .features.float() ** 2).sum()
        loss_p.backward()
        losses.append(loss_p.item())
    check(all(abs(losses[0] - lp) <= NET_F32_TOL * abs(lp)
              for lp in losses[1:]), f"f32 train losses {losses}")
    worst = []
    for net_p in nets[1:]:
        rels = [(rel_err(torch, pk_.grad, pp.grad)[1], name)
                for (name, pk_), (_, pp) in zip(nets[0].named_parameters(),
                                                net_p.named_parameters())]
        check(all(np.isfinite(r) for r, _ in rels), "f32 grads not finite")
        worst.append(max(rels))
    check(worst[0][0] <= GRAD_F32_TOL,
          f"f32 grad {worst[0][1]}: kernels vs plain backward "
          f"{worst[0][0]:.3e} > {GRAD_F32_TOL}")
    print(f"train f32 seed=0: loss kernels {losses[0]:.9e}, plain backward "
          f"{losses[1]:.9e}, plain forward and backward {losses[2]:.9e}; "
          f"worst weight grad max|d|/max|ref| vs plain backward "
          f"{worst[0][0]:.3e} ({worst[0][1]}, tolerance {GRAD_F32_TOL} per "
          f"tensor), vs plain forward and backward {worst[1][0]:.3e} "
          f"({worst[1][1]}, not gated)")

    # algo="sk" against algo="dg" (and the plain versions) on the stage-2
    # pair, bf16: the same tables and kernels, so bit-equal
    g = geo[SK_STAGE]
    c_in, c_mid = B.CHANNELS[2 * SK_STAGE], B.CHANNELS[2 * SK_STAGE + 1]
    feats = (torch.randn((g.indices.shape[0], c_in), device=dev,
                         generator=gen) * g.valid_mask[:, None]).bfloat16()

    def pair_run(algo):
        wgen = torch.Generator().manual_seed(5)
        convs = [SubMConv3d(ci, co, 3, bias=False, indice_key="p", algo=algo,
                            dtype=torch.bfloat16, device=dev, generator=wgen)
                 for ci, co in ((c_in, c_mid), (c_mid, c_mid))]
        x = SparseConvTensor(feats.clone().requires_grad_(), g.indices,
                             g.spatial_shape, 1, keys_sorted=True)
        D.reset_launch_counts()
        y = convs[1](convs[0](x))
        fwd_launches = D.launch_counts["dg_fwd"]
        (y.features.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        counts = dict(D.launch_counts)
        return ([y.features.detach(), x.features.grad]
                + [cv.weight.grad for cv in convs], counts, fwd_launches)

    sk, sk_counts, sk_fwd_launches = pair_run("sk")
    dg, dg_counts, _ = pair_run("dg")
    check(sk_counts == dg_counts == dict(dg_pos=1, dg_pos_rev=1,
                                         dg_pos_affine=0, dg_fwd=2,
                                         dg_fwd_strided=0, dg_dgrad=2,
                                         dg_wgrad=2),
          f"sk pair launches {sk_counts}, dg pair {dg_counts}")
    check(all(torch.equal(a, b) for a, b in zip(sk, dg)),
          "algo='sk' and algo='dg' differ on the stage-2 pair")
    # the same pair through the plain versions
    wgen = torch.Generator().manual_seed(5)
    ws = [SubMConv3d(ci, co, 3, bias=False, dtype=torch.bfloat16,
                     device=dev, generator=wgen).weight
          for ci, co in ((c_in, c_mid), (c_mid, c_mid))]
    keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
    geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=g.spatial_shape,
                batch_size=1)
    pos = D.dg_pos_plain(keys, **geom)
    pos_rev = D.dg_pos_plain(keys, reverse=True, **geom)
    plain = plain_conv_fn(torch, D, D.dg_fwd_plain)
    xp = feats.clone().requires_grad_()
    h = plain.apply(xp, D.weight_krsc_to_kv(ws[0]), pos, pos_rev)
    h = torch.where(g.valid_mask[:, None], h, torch.zeros_like(h))
    yp = plain.apply(h, D.weight_krsc_to_kv(ws[1]), pos, pos_rev)
    yp = torch.where(g.valid_mask[:, None], yp, torch.zeros_like(yp))
    (yp.float() ** 2).sum().backward()
    sk_err, sk_rel = {}, {}
    for kern, pairs in (("sk_fwd", [(sk[0], yp)]),
                        ("sk_bwd", list(zip(sk[1:], [xp.grad] +
                                            [w.grad for w in ws])))):
        rels = [rel_err(torch, a, b) for a, b in pairs]
        sk_err[kern] = max(d for d, _ in rels)
        sk_rel[kern] = max(r for _, r in rels)
        check(sk_rel[kern] <= TOL["bfloat16"],
              f"{kern} vs plain: {sk_rel[kern]:.3e} > {TOL['bfloat16']}")
    print(f"sk pair (stage {SK_STAGE}, {c_in}->{c_mid}->{c_mid}, bf16): "
          f"bit-equal to dg; launches {sk_counts}; max|d|/max|ref| vs "
          f"plain fwd {sk_rel['sk_fwd']:.3e} bwd {sk_rel['sk_bwd']:.3e}")
    # its kernel times are phase 3's at the stage-2 shape, layers 4 and 5
    sk_layers = (2 * SK_STAGE, 2 * SK_STAGE + 1)
    sk_ms = {
        "sk_fwd": [sum(per_layer[(ly, "dg_fwd")][i] for ly in sk_layers)
                   for i in (0, 1)],
        "sk_bwd": [sum(per_layer[(ly, kern)][i] for ly in sk_layers
                       for kern in ("dg_dgrad", "dg_wgrad"))
                   for i in (0, 1)],
    }

    # ---- 6. serve the CenterPoint encoder -----------------------------
    from spconv_tpu_torch import SparseConv3d
    from spconv_tpu_torch.calibrate import apply_out_bounds
    from spconv_tpu_torch.models import centerpoint_encoder

    cp16 = {s: x.replace_feature(x.features.bfloat16())
            for s, x in cp_in.items()}
    down = cp_net.downs[0]
    sk_down = SparseConv3d(16, 32, 3, stride=2, padding=1,
                           indice_key="down1", algo="sk",
                           out_bound=down.out_bound, dtype=torch.bfloat16,
                           device=dev)
    sk_down.load_state_dict(down.state_dict())
    with torch.inference_mode():
        cp_net.bev(cp16[0])  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        cp_ms = []
        for seed in REQUEST_SEEDS:
            t0 = time.perf_counter()
            bev = cp_net.bev(cp16[seed])
            torch.cuda.synchronize()
            cp_ms.append((time.perf_counter() - t0) * 1e3)
            check(tuple(bev.shape) == (1, 512, 128, 128)
                  and bev.dtype == torch.bfloat16,
                  f"CenterPoint request {seed}: bev {tuple(bev.shape)} "
                  f"{bev.dtype}")
            check(bool(torch.isfinite(bev).all()) and bool(bev.any()),
                  f"CenterPoint request {seed}: bev not finite or all 0")
        cp_launches = dict(D.launch_counts)
        want = {k: len(REQUEST_SEEDS) * v for k, v in CP_LAUNCHES.items()}
        check(cp_launches == want, f"CenterPoint launches {cp_launches}, "
              f"expected {want}")

        net32 = apply_out_bounds(centerpoint_encoder(
            in_channels=5, bn=False, device=dev).eval(), cp_bounds)
        for seed, ms in zip(REQUEST_SEEDS, cp_ms):
            stages = cp_net.forward_stages(cp16[seed])
            ref = plain_encoder_stages(torch, cp_net, cp16[seed])
            for si, (g, r) in enumerate(zip(stages, ref)):
                check(torch.equal(g.indices, r.indices),
                      f"CenterPoint request {seed}: stage {si} coordinates "
                      "differ from the plain run")
            _, bf_rel = rel_err(torch, stages[-1].features,
                                ref[-1].features)
            _, rel32 = rel_err(torch, net32(cp_in[seed]).features,
                               plain_encoder_stages(
                                   torch, net32, cp_in[seed])[-1].features)
            check(rel32 <= NET_F32_TOL, f"CenterPoint request {seed}: f32 "
                  f"encoder {rel32:.3e} > {NET_F32_TOL} of max|ref|")
            recs = stages[-1].indice_dict
            layers = []
            for key in CP_STRIDED:
                rec = recs[f"__dgreg__{key}"]
                n_in = int((recs[f"__dgreg_in__{key}"][:, 0] >= 0).sum())
                n_out, total = int(rec.num_out), int(rec.num_out_total)
                matched = float((rec.pos >= 0).sum()) / max(1, n_out)
                layers.append(f"{key} {n_in}->{n_out} (total {total}, "
                              f"bound {rec.out_keys.shape[0]}, matched "
                              f"offsets {matched:.3f})")
            print(f"cp request seed={seed} input=synthetic ms={ms:.3f} "
                  f"active_per_stage={[int(t.num_voxels) for t in stages]} "
                  f"f32_rel_err={rel32:.3e} bf16_rel_vs_plain={bf_rel:.3e}; "
                  + "; ".join(layers))

        # algo="sk" on the first downsample: the same table and kernel as
        # "dg", so bit-equal
        stage0 = cp_net.forward_stages(cp16[0])[0]
        D.reset_launch_counts()
        y_sk = sk_down(stage0)
        torch.cuda.synchronize()
        sk_strided_launches = D.launch_counts["dg_fwd_strided"]
        check(dict(D.launch_counts) == dict(
            CP_LAUNCHES, dg_pos=0, dg_fwd=0, dg_pos_affine=1,
            dg_fwd_strided=1), f"sk downsample launches {D.launch_counts}")
        check(torch.equal(y_sk.features, down(stage0).features)
              and torch.equal(y_sk.indices, down(stage0).indices),
              "algo='sk' and algo='dg' differ on the first downsample")
    print(f"CenterPoint serve: bf16 bev {tuple(bev.shape)}, ms per request "
          f"{[round(m, 3) for m in cp_ms]}, launches {cp_launches}; "
          f"algo='sk' downsample bit-equal to 'dg'")

    # ---- 7. report ---------------------------------------------------
    def entry(name, source, replaces, launches, key, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=err[key], max_rel_err=rel[key],
                    ms=tot[key][0],
                    plain_ms=tot[key][1], **extra)

    down1_ms = next(r for r in cp_layer_ms if r[0] == "down1")
    pallas = "spconv_tpu/ops/pallas/"
    csrc = "spconv_tpu_torch/csrc/"
    kernels = [
        entry("dg_pos", csrc + "dg_pos.cu", pallas + "dg_conv.py:710",
              train_launches["dg_pos"], "dg_pos",
              serve_launches=serve_launches["dg_pos"]),
        entry("dg_pos_reverse", csrc + "dg_pos.cu",
              pallas + "dg_conv.py:710 (reverse=True, built at :1707)",
              train_launches["dg_pos_rev"], "dg_pos_rev"),
        entry("dg_fwd", csrc + "dg_fwd.cu", pallas + "dg_conv.py:339",
              train_launches["dg_fwd"], "dg_fwd",
              serve_launches=serve_launches["dg_fwd"]),
        entry("dg_dgrad", csrc + "dg_fwd.cu",
              pallas + "dg_conv.py:1307 (din)",
              train_launches["dg_dgrad"], "dg_dgrad"),
        entry("dg_wgrad", csrc + "dg_wgrad.cu",
              pallas + "dg_conv.py:1307 (dW)",
              train_launches["dg_wgrad"], "dg_wgrad"),
        dict(name="sk_fwd", route="cuda", source=csrc + "dg_fwd.cu",
             replaces=pallas + "sorted_conv.py:446",
             launches=sk_fwd_launches, max_abs_err=sk_err["sk_fwd"],
             max_rel_err=sk_rel["sk_fwd"],
             ms=sk_ms["sk_fwd"][0], plain_ms=sk_ms["sk_fwd"][1]),
        dict(name="sk_bwd", route="cuda",
             source=csrc + "dg_fwd.cu + " + csrc + "dg_wgrad.cu",
             replaces=pallas + "sorted_conv.py:815",
             launches=sk_counts["dg_dgrad"] + sk_counts["dg_wgrad"],
             max_abs_err=sk_err["sk_bwd"], max_rel_err=sk_rel["sk_bwd"],
             ms=sk_ms["sk_bwd"][0],
             plain_ms=sk_ms["sk_bwd"][1]),
        dict(name="dg_pos_affine", route="cuda", source=csrc + "dg_pos.cu",
             replaces=pallas + "dg_conv.py:302 (_vec_affine_probes of "
             "_dg_fwd_kernel :339, launched at :1020 by _dg_reg_conv)",
             launches=cp_launches["dg_pos_affine"],
             max_abs_err=err["dg_pos_affine"],
             max_rel_err=rel["dg_pos_affine"],
             ms=cp_tot["dg_pos_affine"][0],
             plain_ms=cp_tot["dg_pos_affine"][1]),
        dict(name="dg_fwd_strided", route="cuda", source=csrc + "dg_fwd.cu",
             replaces=pallas + "dg_conv.py:339 (affine probes, launched at "
             ":1020 by _dg_reg_conv :1837)",
             launches=cp_launches["dg_fwd_strided"],
             max_abs_err=err["dg_fwd_strided"],
             max_rel_err=rel["dg_fwd_strided"],
             ms=cp_tot["dg_fwd_strided"][0],
             plain_ms=cp_tot["dg_fwd_strided"][1]),
        dict(name="sk_fwd_strided", route="cuda", source=csrc + "dg_fwd.cu",
             replaces=pallas + "sorted_conv.py:446 (sk_regular_conv "
             ":1356)", launches=sk_strided_launches,
             max_abs_err=err["dg_fwd_strided"],
             max_rel_err=rel["dg_fwd_strided"],
             ms=down1_ms[4], plain_ms=down1_ms[5]),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched on its "
              "path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
