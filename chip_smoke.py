#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (every check raises, so a failure exits non-zero before the last
line is printed):
1. the card: CUDA must be available; prints nvidia-smi's name and power
   limit;
2. builds the CUDA kernels from ``spconv_tpu_torch/csrc`` with nvcc, and
   beside them the bf16 wgrad's and B7's counting builds
   (``tools/wgrad_ablation.py``, ``tools/b7_ablation.py``), B1's, and the
   probes with the parent's rank kernel (``tools/join_gather_tiles.py``'s
   ``PARENT_RANK``), and with g++ phase 18's C++ op library and loader,
   and prints
   each kernel's ptxas registers, spills and static shared memory (B2's,
   wgrad's and B7's variants with their dynamic shared memory; a wgrad or
   B7 variant that spills, or a report without all 24 wgrad and 32 B7
   variants, fails);
3. holds each kernel against its plain PyTorch version at every stage shape
   of the benchmark net on a synthetic scan, in f32 and bf16, with CUDA-event
   times of both: the match table forward and reversed, the gather-GEMM
   forward, dgrad and wgrad; times B2 at one width of each bf16 variant
   (K = 16, 32, 64, 128, 256 and the scalar gather at C = 3) at the stage-0
   shape, and checks in a profiler window that a bf16 dgrad is one device
   op, the B2 launch, with no weight-transpose copy beside it; checks and
   times the bf16 wgrad at one width of each tile variant at the stage-0
   shape, counts the MMA rows each issues there with the counting build
   (at most 1.1 per matched pair, and exactly the whole 16-row slices of
   the listed rows), and prints the f32 partial bytes of a BenchNet step's
   wgrads as the split rule sizes them;
4. serves the full-width bf16 benchmark net (14 SubMConv3d, 6 max pools) on
   three synthetic scans after one warm-up, through the port's kernels, and
   checks launch counts, output sanity, per-stage coordinates against a
   plain-version run on the card, and an f32 run against plain;
   It also holds the strided conv's kernels (the affine match table and
   the gather-GEMM on it) and the subm kernels against their plain versions
   at every layer shape of the CenterPoint encoder on its synthetic scan;
5. trains: one SGD step of the bf16 net per synthetic scan after a warm-up
   step, with launch counts, finite non-zero grads and step times; a
   profiler window of one step with its 14 forward and 13 dgrad B2 device
   launches and no copy beside a dgrad; the f32
   net's grads through the kernels against the same step through the plain
   versions of the backward; and an ``algo="sk"`` conv pair against
   ``algo="dg"``;
6. serves the CenterPoint encoder (``centerpoint_encoder(in_channels=5,
   bn=False)``, bf16, buffers calibrated on seed 0) to its BEV map on three
   synthetic 113,000-voxel scans after one warm-up, and checks launch
   counts, per-stage coordinates against a plain-version run on the card,
   an f32 run against plain, a finite non-zero BEV map, and an
   ``algo="sk"`` downsample against ``algo="dg"``;
7. the segmentation U-Net (``SparseUNet(in_channels=5, channels=(16, 32,
   64), num_classes=16)``, bf16, downsample buffers calibrated in f32 on
   seed 0) on the same three CenterPoint scans: the divide table against
   its plain version at both U-Net downsamples and all four CenterPoint
   strided layers, the inverse gather-GEMM and the strided and inverse
   dgrad and wgrad at every U-Net layer shape; then serves three scans and
   trains three steps with launch counts, the output's sites against the
   input's, an f32 run against a plain-version run, the f32 grads against
   the plain backward, device busy share and peak memory; and an
   ``algo="sk"`` downsample + inverse pair against ``algo="dg"``;
8. the int8 (PTQ) CenterPoint encoder: the f32 encoder with phase 6's
   buffers, its scales observed on seed 0 on the card, quantized
   (``quantize_encoder``); B7 (``dg_fwd_q``) bit-equal to its plain version
   at every layer shape (subm with and without the residual, strided) and
   at an inverse layer; one width of each of B7's 16 variants at the
   stage-0 shape, bit-equal, timed, with the MMA rows it issues counted on
   the card by the counting build and equal to ``b7_mma_rows``; three int8
   requests to their BEV maps with launch counts, every layer's
   coordinates and int8 features against a plain run on the card, and the
   BEV against the f32 encoder's; host ms, device busy share and peak
   memory beside the bf16 request's; a request's profiler window with no
   copy of a layer's weight; an int8 downsample + inverse pair against
   plain;
9. the sorted-key pool (B6, ``csrc/sk_pool.cu``): the kernel bit-equal to
   its plain version (max; mean within 1e-6 of max|ref|) at the six
   BenchNet pool shapes, f32 and bf16, with CUDA-event ms of the kernel,
   the plain version and the seg route (``pool2_seg``) and its bound; NaN
   and +-inf inputs; the backward on the card against the CPU's.  Then the
   bf16 BenchNet with its six pools on ``SparseMaxPool3d(2, 2,
   algo="sk")``: three served requests (7 ``dg_pos``, 14 ``dg_fwd``, 6
   ``sk_pool`` launches each) bit-equal at every stage to phase 4's
   seg-pool net, host ms and device busy beside the seg-pool net's; three
   training steps with launch counts and finite grads; the f32 grads
   against the plain conv backward; and a ``SparseAvgPool3d(algo="sk")``
   net against the seg mean route, stage by stage;
10. the table-free subm conv (S1-S4: the search mode of B2, B3 and B7,
   ``csrc/dg_search.cuh``): S1, S2 and S3 against their plain versions and
   bit-equal to B1 followed by the table-mode kernel at every BenchNet
   layer shape, f32 and bf16, and at kernel 5^3, with CUDA-event ms beside
   the table path's; S4 the same at ``bench.py``'s ``run_int8`` layers
   (C = K = 64, 128), with and without the residual, and that section's
   four ms (bf16 and int8, search mode and cached table).  Then BenchNet
   with every ``indice_key`` None: three served requests (14
   ``dg_fwd_search`` launches each, no table) bit-equal at every stage to
   phase 4's keyed net, host ms, device busy and peak memory in turns with
   it; three training steps (14 / 13 / 14 search launches each) with
   finite grads, step ms, busy and peak memory beside the keyed step's,
   the f32 grads against the plain backward; and an int8 no-key conv
   bit-equal to the same layer on a key;
11. the transposed conv (B1 divide + B2 on swapped spaces) through the
   decoder chain of ``docs/USAGE.md`` (SubMConv3d(32, 64) ->
   SparseConv3d(64, 128, s2) -> SparseInverseConv3d(128, 64) ->
   SparseConvTranspose3d(64, 32, 2, s2)) on the CenterPoint scans with
   seeded 32-channel features, bf16, buffers calibrated on seed 0: the
   transposed conv's divide and affine tables, B2, dgrad and wgrad against
   their plain versions at the chain's shapes, timed; three requests and
   three training steps with launch counts, host ms, device busy and peak
   memory; the f32 chain against a plain run and its grads against the
   plain backward; a k3 s2 p1 op1 transposed conv against plain;
12. the probe kernels (B9, ``csrc/probes.cu``): every
   ``spconv_tpu_torch.tools`` probe's ``main()`` with each case OK, then
   each kernel against its plain version at its probe's shape, timed
   beside the plain version, the PyTorch call that computes the same
   function and its bound; the GEMMs with their plans (tile, blocks, K
   split) and, where this PyTorch has it, ``torch.mm`` with an f32 out;
   the rank with its plan (``rank_plan``: a warp a row), on every plan of
   its sweep (warps a block, the keys counted or searched) and on the
   parent's kernel (one block a row, built in phase 2), in turns;
13. the MNIST classifier (``SparseClassifier(2, 1, 10)``, batch 8 on 28 x
   28) trained 5 SGD steps at ``examples/mnist_sparse.py``'s lr with launch
   counts, and its first step in f32 (logits, loss, grads) against the plain
   backward and against the plain forward and backward with plain tables;
   the MNIST QAT flow (``spconv_tpu_torch.examples.mnist_qat.main``: float
   pretraining, PTQ, QAT, both converted to int8) with a float step, an
   observe pass and a QAT step counted, a QAT step in f32 against the same
   two plain runs and each QAT conv's f32 output against the plain forward
   on the same input, and the three accuracies; both int8 nets served 3
   requests on B7 at ndim 2 (launch counts, every int8 layer bit-equal to
   the plain run, the QAT-int8 output against the QAT net's forward, host
   ms, device busy, peak memory); and the CenterPoint encoder with
   ``bn=True`` (bf16, phase 6's buffers, BN on batch statistics) trained 3
   steps with launch counts (each BN kernel once a BatchNorm1d), each
   BN input of a step through BN's four kernels against the plain formula
   (statistics, ``y``, ``dx``, ``dweight``, ``dbias``, a repeat bit-equal)
   and each kernel timed beside its plain version and its bound, a
   profiler window, coordinates against a plain run, busy, peak memory and
   the f32 grads against the plain backward, BatchNorm's included;
14. the native rulebook path (``ops.rulebook`` + ``ops.gather_gemm``: the
   DG kernels on the rulebooks' pair tables, counted as ``*_native``):
   BenchNet on ``algo="native"`` (bf16, phase 4's pool buffers) with every
   stage's subm rulebook equal to phase 3's B1 tables and timed beside
   them, three requests (14 ``dg_fwd_native`` each, no table kernel)
   bit-equal to phase 4's keyed net, three training steps (13 dgrad and 14
   wgrad more) with a zero-lr step's grads bit-equal to the DG net's, the
   f32 grads against the plain backward, host ms, device busy and peak
   memory beside the DG net's; phase 4's scans with rows shuffled through
   the ``"auto"`` net (stage 0 native) against phase 4 after aligning rows
   by coordinate; a keyed ``SparseMaxPool3d`` + ``SparseInverseConv3d``
   and a subm + strided pair on a ``[160, 2048, 2048]`` x 4 grid (int64
   keys) against a plain run; an int8 ``SparseConvTranspose3d(64, 32, 2,
   s2)`` bit-equal to plain; a native forward under
   ``torch.cuda.set_sync_debug_mode("error")``;
15. raw point clouds: ``synthetic_centerpoint_points(0..2)`` voxelized on
   the card with the JAX loader's ``PointToVoxel`` (coordinates equal to
   the stand-in scans' sites, all five outputs bit-equal to the CPU, CUDA-
   event ms, a profiler window, peak memory); three points -> BEV
   requests through phase 6's bf16 encoder (launch counts, the BEV against
   a ``plain_kernels`` run at the bf16 kernel gate, host ms, device busy,
   idle share, peak memory, the voxelizer's share); a layer's output
   mapped back to the points against a numpy gather; ``sparse_add``,
   ``RemoveDuplicate`` (then a subm conv on B1 + B2), a ``HashTable`` and
   ``rotate_nms`` of 500 boxes against the same calls on the CPU; the
   ``voxel_gen``, ``fuse_bn_act`` and ``int8_ptq_encoder`` examples on the
   card against the CPU; the encoder saved and loaded through an npz
   checkpoint and served bit-equal;
16. the tuner, per-layer timing and data parallelism (the tuner's cache
   is a fresh directory set before the port is imported, and phases 1-15
   must leave it empty): BenchNet (bf16, seed 0) with tuning forced, one
   request and one training step tuning every conv signature for
   inference and training (each signature's native / sk / dg ms and
   winner), three requests from the cache bit-equal to phase 4, a zero-lr
   step's grads bit-equal to the DG net's, a second tuner reading every
   winner back; B2's five bf16 tiles on the native stage-0 table (each
   within the bf16 gate, timed, the winner cached, read back and launched
   by a native conv's forward, seen in a profiler window); one BenchNet
   request with ``benchmark=True`` (20 records at phase 4's stage sizes,
   each time > 0, their sum beside the request's host ms and busy),
   ``KernelTimer`` spans around the seven stages within the host ms
   around them, a profiler window with each layer's ``record_function``
   range and phase 4's launches, phase 6's CenterPoint host ms again;
   ``centerpoint_encoder(5, bn=True)`` with SyncBN trained data-parallel
   on 2 ranks of the one card (gloo, ``parallel.run_ranks``; 3 bf16 steps
   with ms, busy and peak memory; an f32 step within 1e-4 of max|ref| of
   one process's step on the batch of both scans, the ranks' grads
   bit-equal; ``conv_out`` column-parallel within the f32 and bf16
   gates), and the ``dist_train`` example's 2 steps (finite, falling
   losses; the ``DistributedDataParallel`` path equal); a failed or hung
   rank fails the run and none is left behind; and a ``bn=True`` step
   with BatchNorm on its kernels against the plain formula, in turns;
17. deployment: the bf16 CenterPoint encoder of phase 6 (113,000 voxels
   on ``[80, 1024, 1024]``, its calibrated buffers) and the int8 encoder
   of phase 8, each exported through ``torch.export``
   (``spconv_tpu_torch.export``: every kernel a ``torch.library`` op),
   saved to bytes and reloaded in this process and in a fresh interpreter
   that imports only the port: three requests bit-equal to eager with
   eager's launches kernel by kernel (the fresh interpreter's on seed 0),
   the blob's bytes, host ms of eager against the exported module in
   turns, and the host µs of one op call against the direct launch (and
   of an op made by ``Library`` against one made by ``custom_op``);
18. the C++ loader: the two encoders of phase 17 and
   ``examples.export_model``'s native net, each compiled ahead of time into
   an AOTInductor package (``spconv_tpu_torch.export.package``) and served
   by ``examples/libtorch_loader`` in a process with no Python, through the
   kernels' ops defined from C++ (``csrc/torch_ops*.cpp``, built in phase 2
   beside the kernels): 23 requests each, every one checked against eager
   (indices, int8 and f32 bit-equal, bf16 within its gate) with eager's
   launches; package bytes, compile s, load s and host ms a request beside
   phase 17's;
19. prints a JSON line of the kernels, each with its bound (the least time
   the card could take for the same work, from the H100's published peaks),
   then the result line.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# in another order (plain_kernels).  With the plain forward as well, a max
# pool may break a near-tie the other way and route a gradient to another
# child, so on a net with max pools that comparison is printed, not gated;
# a fake quant's tie is counted and gated (QAT_TIE_SHARE).
GRAD_F32_TOL = 1e-4
SK_STAGE = 2  # the 96 -> 128 -> 128 pair of the net
CP_STRIDED = ("down1", "down2", "down3", "out")  # indice_keys, in order
# per CenterPoint request: 4 subm and 4 affine tables, 17 subm and 4
# strided gather-GEMMs (models/second.py); every other count stays 0
CP_LAUNCHES = dict(dg_pos=4, dg_pos_affine=4, dg_fwd=17, dg_fwd_strided=4)
UNET_CHANNELS = (16, 32, 64)  # the JAX SparseUNet's defaults
UNET_CLASSES = 16  # nuScenes-lidarseg
# per served U-Net request (models/unet.py): 3 subm tables (the decoder
# reuses them), 2 affine and 2 divide tables (the inverse convs build
# those), 5 subm, 2 strided and 2 inverse gather-GEMMs; the head is a 1x1
# matmul
UNET_SERVE = dict(dg_pos=3, dg_pos_affine=2, dg_pos_divide=2, dg_fwd=5,
                  dg_fwd_strided=2, dg_fwd_inverse=2)
# per training step: those (the strided convs build the divide tables
# now) and the backward; the first conv's input needs no gradient
UNET_STEP = dict(UNET_SERVE, dg_pos_rev=3, dg_dgrad=4, dg_wgrad=5,
                 dg_dgrad_strided=2, dg_wgrad_strided=2, dg_dgrad_inverse=2,
                 dg_wgrad_inverse=2)
# per int8 CenterPoint request: the same tables, 17 subm and 4 strided B7
# launches, no B2
CP_INT8_LAUNCHES = dict(dg_pos=4, dg_pos_affine=4, dg_fwd_q=17,
                        dg_fwd_q_strided=4)
# the dequantized int8 BEV against the f32 encoder's, as the JAX package's
# test_quantize_encoder_end_to_end bounds it: max error over max|ref|, L2
INT8_MAX_ERR = 0.25
INT8_L2_ERR = 0.1
# the H100 SXM's published dense peaks (NVIDIA data sheet), for each
# kernel's bound: bf16 and int8 tensor cores, f32 FMA outside them, HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
# B6's mean against its plain version (and its backward on the card
# against the CPU's), of max|ref|: both sum in f32 in child order and
# divide once, so they should agree exactly
SK_MEAN_TOL = 1e-6
# per no-key BenchNet request: 14 S1 and no table; a step adds 13 S2 (the
# first conv's input needs no gradient) and 14 S3
SEARCH_SERVE = dict(dg_fwd_search=14)
SEARCH_STEP = dict(SEARCH_SERVE, dg_dgrad_search=13, dg_wgrad_search=14)
SEARCH_Q_WIDTHS = (64, 128)  # bench.py's run_int8 layer: C = K
# (C, K) of one width of each B2 bf16 variant, timed at the stage-0 shape:
# K = 16, 32, 64, 128 and 256 wide tiles, and the scalar gather (C = 3)
B2_WIDTHS = ((64, 16), (64, 32), (64, 64), (128, 128), (256, 256), (3, 64))
# (C, K) of one width of each bf16 wgrad variant, timed at the stage-0
# shape: the 16-channel tile (C = 3, scalar x), 32 x 64, 64 x 64, 64 x
# 128, 128 x 64, 128 x 128, and 128 x 128 in 2 x 2 tiles (C = K = 256)
WGRAD_WIDTHS = ((3, 64), (32, 32), (64, 64), (64, 128), (128, 64),
                (128, 128), (256, 256))
# the bf16 wgrad's MMA rows per matched pair at BenchNet's stage 0, at most
WGRAD_MMA_ROWS = 1.1
# (C, K) of one width of each of B7's 16 variants, timed at the CenterPoint
# stage-0 shape: per tile (K = 16, 32, 64, 128 wide), byte gathers packed
# and not, then 16-byte gathers packed and not (ops/dg_conv.py::b7_variant)
B7_WIDTHS = ((5, 16), (72, 16), (16, 16), (80, 16),
             (24, 20), (100, 32), (32, 32), (96, 32),
             (40, 48), (72, 48), (64, 64), (128, 64),
             (12, 100), (36, 96), (32, 128), (128, 128))


def expected(D, **nonzero):
    """``launch_counts`` as a run that launched only ``nonzero`` leaves
    it."""
    return {**dict.fromkeys(D.launch_counts, 0), **nonzero}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` launches on the current stream,
    after one warm-up (CUDA events).  A device sleep of ~20 ms is queued
    first, so the host enqueues the launches while the card sleeps and the
    host time of a wrapper (~0.05-0.1 ms, more than a small kernel takes)
    does not show as gaps between them; plain versions whose host time
    exceeds the sleep still count it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
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


def bound(nbytes, ops=0, dtype="bfloat16"):
    """``(ms, by)``: the least time the card could take for work that moves
    ``nbytes`` and does ``ops`` operations of ``dtype``, the larger of the
    two, and which of "bytes" and "operations" it is."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def table_bound(rows, table_rows, kv):
    """A match table ``[kv, rows]`` int32: the keys of its rows and the
    keys it searches read once, the table written once; integer compares
    only, so bound by bytes."""
    return bound(4 * (rows + table_rows + kv * rows))


def index_bytes(pos, keys):
    """The bytes of the rows' matches a kernel reads once: the table
    ``pos``, or in search mode (``keys`` given) the sorted keys it searches
    in place of the table."""
    return 4 * (pos.numel() if keys is None else keys.numel())


def gemm_bound(src, w, pos, width, keys=None):
    """A gather-GEMM (forward or dgrad): ``src`` ``[N_src, C]`` and ``w``
    ``[kv, C, width]`` or its transpose read once, ``pos`` ``[kv, N_dst]``
    (or the ``keys``, :func:`index_bytes`) read once, ``[N_dst, width]``
    written once; 2 * C * width operations per matched (row, offset) pair
    of this input."""
    pairs = int((pos >= 0).sum())
    esz = src.element_size()
    nbytes = ((src.numel() + w.numel() + pos.shape[1] * width) * esz
              + index_bytes(pos, keys))
    return bound(nbytes, 2 * pairs * src.shape[1] * width,
                 str(src.dtype)[6:])


def wgrad_bound(x, dout, pos, keys=None):
    """wgrad: ``x`` ``[N_src, C]``, ``dout`` ``[N_dst, K]`` and ``pos``
    ``[kv, N_src]`` (or the ``keys``) read once, ``dW`` ``[kv, C, K]``
    written once; 2 * C * K operations per matched pair."""
    pairs = int((pos >= 0).sum())
    c, k = x.shape[1], dout.shape[1]
    nbytes = ((x.numel() + dout.numel() + pos.shape[0] * c * k)
              * x.element_size() + index_bytes(pos, keys))
    return bound(nbytes, 2 * pairs * c * k, str(x.dtype)[6:])


class Tally:
    """Kernel ms, plain ms and bound ms of one kernel summed over a set of
    calls; ``bound_by`` says whether bytes or operations bound most of the
    summed bound."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self._by = {"bytes": 0.0, "operations": 0.0}

    def add(self, km, pm, bnd, mult=1):
        self.ms += mult * km
        self.plain_ms += mult * pm
        self.bound_ms += mult * bnd[0]
        self._by[bnd[1]] += mult * bnd[0]

    @property
    def bound_by(self):
        return max(self._by, key=self._by.get)

    def __str__(self):
        return (f"{self.ms:.4f} ms (plain {self.plain_ms:.4f}, bound "
                f"{self.bound_ms:.4f} by {self.bound_by})")


def device_ops(prof):
    """The device ops (kernels, copies, fills) of a ``torch.profiler``
    window.  A ``record_function`` range (every conv and pool opens one
    under a profiler) is a host event, which the profiler mirrors on the
    device's timeline as a user annotation: not a device op, so not
    counted here."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def device_busy(torch, fn, reps):
    """``(window ms, device-busy ms, device ops)`` over ``reps`` calls of
    ``fn`` after one warm-up, in a ``torch.profiler`` window: the host
    clock around the calls and a final sync, the summed duration of the
    device's kernels, copies and fills (one stream, so they do not
    overlap), and their number.  Busy is None where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = device_ops(prof)
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    return wall, (busy or None), len(ops)


def device_ops_by_time(torch, fn, reps):
    """``[(name, device us, count)]`` of the device ops of ``reps`` calls
    of ``fn`` after one warm-up, in a ``torch.profiler`` window, the most
    time first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in device_ops(prof):
        us, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    return sorted(((n[:60], us, k) for n, (us, k) in by_name.items()),
                  key=lambda r: -r[1])


def peak_mib(torch, fn):
    """``(peak MiB allocated by one call of fn above what was allocated
    before it, that MiB before it)``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return ((torch.cuda.max_memory_allocated() - base) / 2**20,
            base / 2**20)


# profiler windows a count of device ops takes before it fails: the
# profiler can drop a device op's record now and then (a train step's
# window once showed 12 of its 14 forward B2 launches), where the
# wrappers' launch counts are exact
WINDOW_TRIES = 3


def counted_ops(torch, fn, counts, expect, window_ok, what):
    """Names of the device ops (kernels, copies, fills) of one call of
    ``fn`` after a warm-up, in order, from a ``torch.profiler`` window.
    Fails unless the call's launches, read from ``counts`` (a wrapper
    module's ``launch_counts``) across the same call, are ``expect``
    (``{name: n}``).  ``window_ok(ops)`` returns None where the window
    agrees with them, else what disagrees: such a window (a dropped
    record) is retaken, and says so, up to ``WINDOW_TRIES`` windows in
    all; the check fails only if every window disagrees."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for turn in range(1, WINDOW_TRIES + 1):
        before = {k: counts[k] for k in expect}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = {k: counts[k] - before[k] for k in expect}
        check(launched == expect,
              f"{what}: launches {launched}, expected {expect}")
        ops = sorted(device_ops(prof), key=lambda e: e.time_range.start)
        names = [e.name for e in ops]
        bad = window_ok(names)
        if bad is None:
            return names
        seen.append(bad)
        print(f"{what}: profiler window {turn} of {WINDOW_TRIES} shows "
              f"{bad}, the launch counts {launched}: "
              + ("retaking it" if turn < WINDOW_TRIES else "none left"),
              flush=True)
    fail(f"{what}: every profiler window disagrees with the launch counts "
         f"{expect}: {seen}")


def weight_copies(torch, fn, qmods):
    """``(weight copies, device ops, B7 launches)`` of one call of ``fn``
    after a warm-up, in a ``torch.profiler`` window: the
    ``aten::contiguous`` calls on a tensor of the shape of one of
    ``qmods``' ``[kv, K, C]`` weights (B7's wrapper makes its copy so), the
    device ops and those of B7's kernel."""
    from torch.profiler import ProfilerActivity, profile

    shapes = {tuple(m.weight_kv.transpose(1, 2).shape) for m in qmods}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e.name for e in device_ops(prof)]
    copies = sum(1 for e in events if e.name == "aten::contiguous"
                 and e.input_shapes and tuple(e.input_shapes[0]) in shapes)
    return copies, len(dev), sum("dg_fwd_q_kernel" in n for n in dev)


def b2_mode(name):
    """``"fwd"`` or ``"dgrad"`` for a device op of B2's bf16 kernel (its
    ``TRANS`` flag: W[k] read as its transpose), else None."""
    if "dg_fwd_bf16_kernel" not in name:
        return None
    m = re.search(r"Tile<[^>]*>, (true|false)", name)
    return "dgrad" if m[1] == "true" else "fwd"


def ptxas_report(log):
    """``[(kernel, [ptxas lines])]``: each kernel entry of the build's
    ``-Xptxas -v`` report with its registers / shared memory line and its
    stack / spill line, names demangled by ``c++filt`` where the machine
    has it."""
    entries = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append((m.group(1), []))
        elif entries and ("registers" in line or "spill" in line):
            entries[-1][1].append(re.sub(r"^ptxas info\s*:\s*", "",
                                         line.strip()))
    names = [n for n, _ in entries]
    try:
        dem = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if dem.returncode == 0 and len(dem.stdout.splitlines()) == len(names):
            names = dem.stdout.splitlines()
    except OSError:
        pass
    return [(n, lines) for n, (_, lines) in zip(names, entries)]


def wgrad_tile(name):
    """``(BM, BN, WARPS_M, WARPS_N, BJ)`` of a bf16 wgrad kernel's name from
    ptxas, demangled (``dg_wgrad_bf16_kernel<wg::Tile<16, 64, 1, 4, 64>,
    ...``) or not (``...20dg_wgrad_bf16_kernelINS0_4TileILi16ELi64E...``),
    else None."""
    m = re.search(r"dg_wgrad_bf16_kernel(?:<[^<]*Tile<|INS0_4TileI)"
                  r"(?:Li)?(\d+)(?:, |ELi)(\d+)(?:, |ELi)(\d+)(?:, |ELi)"
                  r"(\d+)(?:, |ELi)(\d+)(?:>|E)", name)
    return tuple(int(g) for g in m.groups()) if m else None


def b7_tile(name):
    """``((BM, BN, WARPS_M, WARPS_N, BK), vec, packed)`` of a B7 kernel's
    name from ptxas, demangled (``b7::dg_fwd_q_kernel<b7::Tile<128, 16, 8,
    1, 128>, true, false, ...``) or not (``...15dg_fwd_q_kernelINS_4TileILi
    128ELi16E...EEELb1ELb0E...``), else None."""
    m = re.search(r"dg_fwd_q_kernel<[^<]*Tile<(\d+), (\d+), (\d+), (\d+), "
                  r"(\d+)>, (true|false), (true|false)", name)
    if m:
        return (tuple(int(g) for g in m.groups()[:5]), m[6] == "true",
                m[7] == "true")
    m = re.search(r"dg_fwd_q_kernelI(?:N[^I]*)?4TileI"
                  r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EEE"
                  r"Lb([01])ELb([01])E", name)
    if m:
        return (tuple(int(g) for g in m.groups()[:5]), m[6] == "1",
                m[7] == "1")
    return None


def bn_plain_train(x, indices, weight, bias, eps, group=None):
    """BatchNorm1d's training forward by the plain formula (the port's
    torch ops before its kernels: ``ops.batch_norm.bn_stats_plain`` and
    ``bn_norm_plain``), differentiated by autograd op by op, on whatever
    device: the yardstick of ``csrc/bn.cu``.  Takes no process group."""
    from spconv_tpu_torch.ops import batch_norm as BNK

    check(group is None, "the plain BatchNorm takes no process group")
    stats, mask = BNK.bn_stats_plain(x, indices)
    return BNK.bn_norm_plain(x, mask, stats, weight, bias, eps)[0]


def bn_plain_backward(x, indices, weight, bias, eps, group=None):
    """BatchNorm1d's training forward on its kernels
    (``ops.batch_norm.batch_norm_train``) with the plain formula's
    backward (:func:`bn_plain_train` differentiated by autograd at the same
    input): BN's part of :func:`plain_kernels` with ``b2_forward``.  A
    whole net's f32 gradients are gated only where both runs share the
    forward: they move by up to 3 % of max|ref| with the forward's
    rounding (the CenterPoint encoder's ``stages.2.1.conv1.weight`` with
    the plain BN forward on the card).  No process group."""
    import torch

    from spconv_tpu_torch.ops import batch_norm as BNK

    check(group is None, "the plain BatchNorm takes no process group")

    class PlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, bias):
            ctx.save_for_backward(x, weight, bias)
            return BNK.batch_norm_train(x, indices, weight, bias, eps)

        @staticmethod
        def backward(ctx, dy):
            ins = [None if t is None else t.detach().requires_grad_()
                   for t in ctx.saved_tensors]
            with torch.enable_grad():
                y = bn_plain_train(ins[0], indices, ins[1], ins[2], eps)
            grads = iter(torch.autograd.grad(
                y, [t for t in ins if t is not None], dy))
            return tuple(None if t is None else next(grads) for t in ins)

    return PlainBackward.apply(x, weight, bias)


def bn_plain_stats(x, indices, group=None):
    """``BatchNorm1d.updated``'s f32 ``(mean, biased var, count)`` by the
    plain formula (no process group)."""
    import torch

    from spconv_tpu_torch.ops import batch_norm as BNK

    check(group is None, "the plain BatchNorm takes no process group")
    with torch.no_grad():
        stats, _ = BNK.bn_stats_plain(x, indices)
        return BNK.moments(stats, x.shape[1], torch.float32)


@contextlib.contextmanager
def plain_kernels(D, b2_forward=False):
    """While the block runs, every DG conv kernel that ``ops.dg_conv``
    launches is swapped for its plain version, on whatever device: B1's
    tables (every ``dg_pos`` op call, ``_pos_op``, by ``_pos_plain``:
    ``dg_pos_plain``, ``dg_pos_affine_plain``, ``dg_pos_divide_plain``),
    the backward (``dg_dgrad_plain``, ``dg_wgrad_plain``) and, unless
    ``b2_forward``, B2's forward (``dg_fwd_plain``); and BatchNorm1d's
    training and ``updated`` (``modules.batch_norm_train`` and
    ``batch_stats``, the four kernels of ``csrc/bn.cu``) by the plain
    formula (:func:`bn_plain_train`, :func:`bn_plain_stats`), with
    ``b2_forward`` its backward alone (:func:`bn_plain_backward`).  A net
    run inside takes its own code, so what it computes holds the kernels
    against their plain versions (with ``b2_forward``, the backward
    alone).  The plain versions count no launch."""
    from spconv_tpu_torch.modules import modules as MM

    def table(rows, table, tg, batch_size, counter):
        return D._pos_plain(rows, table, tg, batch_size)

    swap = dict(
        _pos_op=table,
        dg_dgrad=lambda dout, w, pos, path="subm": D.dg_dgrad_plain(
            dout, w, pos),
        dg_wgrad=lambda x, dout, pos, path="subm": D.dg_wgrad_plain(
            x, dout, pos))
    if not b2_forward:
        swap["dg_fwd"] = (lambda x, w, pos, path="subm", tile=None:
                          D.dg_fwd_plain(x, w, pos))
    swaps = ((D, swap), (MM, dict(
        batch_norm_train=bn_plain_backward if b2_forward else bn_plain_train,
        batch_stats=bn_plain_stats)))
    saved = [(mod, {name: getattr(mod, name) for name in sw})
             for mod, sw in swaps]
    for mod, sw in swaps:
        for name, fn in sw.items():
            setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, sw in saved:
            for name, fn in sw.items():
                setattr(mod, name, fn)


def step_vs_plain(torch, D, nets, step, what, b2_forward=True,
                  gate_outputs=True, gate_grads=True):
    """Runs ``step(nets[0])`` through the kernels and ``step(nets[1])``
    under :func:`plain_kernels` (with ``b2_forward``: the backward alone),
    two nets of the same weights.  ``step`` takes one training step and
    returns ``(outputs, named parameters)``: a tuple of tensors, the loss
    first, and the parameters whose grads the step left.  Gates each output
    at NET_F32_TOL of its max|ref| (with ``gate_outputs``) and each grad at
    GRAD_F32_TOL of its max|ref| (with ``gate_grads``).  Returns ``(loss,
    plain loss, worst output error, (worst grad error, its parameter))``."""
    import numpy as np

    out_k, params_k = step(nets[0])
    with plain_kernels(D, b2_forward):
        out_p, params_p = step(nets[1])
    out_rel = max(rel_err(torch, a, b)[1] for a, b in zip(out_k, out_p))
    check(out_rel <= NET_F32_TOL or not gate_outputs, f"{what} f32 outputs: "
          f"kernels vs plain {out_rel:.3e} > {NET_F32_TOL} of max|ref|")
    rels = []
    for (name, pk), (_, pp) in zip(params_k, params_p):
        check(pk.grad is not None and pp.grad is not None,
              f"{what}: {name} has no grad")
        rels.append((rel_err(torch, pk.grad, pp.grad)[1], name))
    worst = max(rels)
    check(np.isfinite(worst[0])
          and (worst[0] <= GRAD_F32_TOL or not gate_grads),
          f"{what} f32 grad {worst[1]}: kernels vs plain {worst[0]:.3e} > "
          f"{GRAD_F32_TOL}")
    return out_k[0].item(), out_p[0].item(), out_rel, worst


def zero_lr_step(B, net, x):
    """``B.train_step`` at lr 0 as :func:`step_vs_plain`'s ``step``."""
    return (B.train_step(net, x, 0.0),), list(net.named_parameters())


def busy_text(wall, busy, reps, what, ops=None):
    """A profiler window's reading (:func:`device_busy`) per call."""
    return (f"profiler window of {reps}: {wall / reps:.3f} ms {what}, "
            "device busy " + (
                f"{busy / reps:.3f} ms ({100 * busy / wall:.1f} %, idle "
                f"{100 - 100 * busy / wall:.1f} %)" if busy
                else "not measured")
            + ("" if ops is None else f", {ops / reps:.0f} device ops"))


def turns_text(windows):
    """Profiler windows taken in turns, ``[(name, (wall, busy, ops))]``."""
    return "; ".join(f"{name} host {w:.3f} ms busy "
                     f"{'none' if b is None else f'{b:.3f}'} ms {k} ops"
                     for name, (w, b, k) in windows)


def plain_forward_stages(torch, net, x):
    """The benchmark net's forward with the plain versions of the kernels
    in place of the kernels, on whatever device ``x`` is on."""
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D

    stages = []
    for stage in range(7):
        if stage:
            x = net.pools[stage - 1](x)
        keys, _ = C.linearize(x.indices, x.spatial_shape, x.batch_size)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=x.spatial_shape,
                    batch_size=x.batch_size)
        pos = D.dg_pos_plain(keys, **geom)
        for conv in net.convs[2 * stage:2 * stage + 2]:
            out = D.dg_fwd_plain(x.features,
                                 D.weight_krsc_to_kv(conv.weight), pos)
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


def plain_unet(torch, net, x):
    """``SparseUNet``'s forward with the plain versions of the kernels in
    place of the kernels (every table by ``dg_pos_plain``,
    ``dg_pos_affine_plain`` or ``dg_pos_divide_plain``, every product by
    ``dg_fwd_plain``), on whatever device ``x`` is on.  Returns the output
    features."""
    import torch.nn.functional as F
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops.rulebook import build_conv_outputs

    def conv(layer, feats, pos, valid):
        out = D.dg_fwd_plain(feats, D.weight_krsc_to_kv(layer.weight), pos)
        out = F.relu(out + layer.bias)
        return torch.where(valid[:, None], out, torch.zeros_like(out))

    skips, stage_pos, downs = [], [], []
    for i, subm in enumerate(net.enc_subm):
        keys, _ = C.linearize(x.indices, x.spatial_shape, 1)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=x.spatial_shape,
                    batch_size=1)
        stage_pos.append(D.dg_pos_plain(keys, **geom))
        x = x.replace_feature(conv(subm, x.features, stage_pos[i],
                                   x.valid_mask))
        skips.append(x)
        if i == len(net.enc_down):
            break
        layer = net.enc_down[i]
        geom = dict(ksize=layer.kernel_size, stride=layer.stride,
                    padding=layer.padding, dilation=layer.dilation)
        out_inds, out_keys, _, _ = build_conv_outputs(
            x.indices, spatial_shape=x.spatial_shape, batch_size=1,
            out_bound=layer.out_bound, **geom)
        geom.update(in_shape=x.spatial_shape, batch_size=1,
                    out_shape=C.get_conv_output_size(
                        x.spatial_shape, layer.kernel_size, layer.stride,
                        layer.padding, layer.dilation))
        downs.append(D.dg_pos_divide_plain(keys, out_keys, **geom))
        x = SparseConvTensor(
            conv(layer, x.features,
                 D.dg_pos_affine_plain(keys, out_keys, **geom),
                 out_inds[:, 0] >= 0),
            out_inds, geom["out_shape"], 1, keys_sorted=True)
    for j, (up, subm) in enumerate(zip(net.dec_up, net.dec_subm)):
        i = len(net.enc_down) - 1 - j
        skip = skips[i]
        h = conv(up, x.features, downs[i], skip.valid_mask)
        h = torch.cat([h, skip.features], 1)
        x = skip.replace_feature(conv(subm, h, stage_pos[i],
                                      skip.valid_mask))
    head = net.head
    out = x.features @ head.weight.reshape(head.out_channels, -1).t()
    out = out + head.bias
    return torch.where(x.valid_mask[:, None], out, torch.zeros_like(out))


def unet_phase(torch, dev, gen, scans, cp_rec, note):
    """Phase 7: the U-Net's kernels against their plain versions at its
    layer shapes (and the divide table at CenterPoint's strided layers,
    ``cp_rec``), then serving and training on ``scans`` (f32, on the card)
    with their checks.  Returns ``(tallies, per_layer, serve_launches,
    train_launches, sk_launches)``: kernel, plain and bound ms summed over
    one bf16 request (the forward's kernels) or step (the backward's), and
    per (layer, kernel)."""
    import copy

    import numpy as np
    import torch.nn.functional as F
    from spconv_tpu_torch import (SparseConv3d, SparseConvTensor,
                                  SparseInverseConv3d, SparseUNet)
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.calibrate import (calibrate_out_bounds,
                                            export_out_bounds)
    from spconv_tpu_torch.ops import dg_conv as D

    bf16 = torch.bfloat16
    dtypes = (torch.float32, bf16)
    levels = len(UNET_CHANNELS) - 1
    t0 = time.perf_counter()
    net32 = calibrate_out_bounds(
        SparseUNet(5, UNET_CHANNELS, UNET_CLASSES, device=dev,
                   seed=0).eval(), None, [scans[0]], margin=1.15, mult=512)
    net16 = copy.deepcopy(net32).to(bf16)
    x16 = {s: x.replace_feature(x.features.to(bf16))
           for s, x in scans.items()}
    print(f"U-Net: SparseUNet(5, {UNET_CHANNELS}, {UNET_CLASSES}), "
          f"downsample bounds (f32 calibration on seed 0, x1.15, to 512) "
          f"{[b for b in export_out_bounds(net32) if b is not None]} in "
          f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        recs = net16(x16[0]).indice_dict
    downs = [recs[f"__dgreg__down{i}"] for i in range(levels)]
    tally = {k: Tally() for k in (
        "dg_fwd", "dg_pos_divide", "dg_fwd_strided", "dg_fwd_inverse",
        "dg_dgrad_strided", "dg_wgrad_strided", "dg_dgrad_inverse",
        "dg_wgrad_inverse")}
    per_layer = {}

    # the divide table, exact, at the U-Net's and CenterPoint's strided
    # layers (the U-Net's were built by its inverse convs just now)
    print("divide tables: layer kv N_in N_out matches kernel_ms plain_ms "
          "bound_ms")
    for layer, rec in ([(f"unet down{i}", r) for i, r in enumerate(downs)]
                       + [(f"cp {k}", cp_rec[f"__dgreg__{k}"])
                          for k in CP_STRIDED]):
        geom = dict(ksize=rec.ksize, stride=rec.stride, padding=rec.padding,
                    dilation=rec.dilation, in_shape=rec.in_shape,
                    out_shape=rec.out_shape, batch_size=1)

        def build():
            return D.build_dg_pos_divide(rec.in_keys, rec.out_keys, **geom)

        def plain():
            return D.dg_pos_divide_plain(rec.in_keys, rec.out_keys, **geom)

        got = build()
        check(torch.equal(got, plain()),
              f"dg_pos_divide {layer} differs from plain")
        # each offset's map is one-to-one: the affine table's matches
        matches = int((got >= 0).sum())
        check(matches == int((rec.pos >= 0).sum()),
              f"dg_pos_divide {layer}: not the affine table's inverse")
        note("dg_pos_divide", 0.0, 0.0)
        km, pm = cuda_ms(torch, build, 20), cuda_ms(torch, plain, 3)
        bnd = table_bound(got.shape[1], rec.out_keys.shape[0], got.shape[0])
        if layer.startswith("unet"):
            tally["dg_pos_divide"].add(km, pm, bnd)
            per_layer[(layer, "dg_pos_divide")] = (km, pm, bnd)
        print(f"  {layer:11s} {got.shape[0]:3d} {got.shape[1]:6d} "
              f"{rec.out_keys.shape[0]:6d} {matches:8d}  {km:9.4f}  "
              f"{pm:8.4f}  {bnd[0]:.4f}")
    print(f"  divide tables at the edge inputs: "
          f"{edge_tables(torch, dev, 'divide')} bit-equal to plain")

    def gemm_cases(layer, runs, dt):
        """Each ``kern: (kernel, plain, valid rows or None, tol, bound)``
        of ``runs`` against its plain version, then timed; rows outside
        ``valid`` must be 0, and a wgrad (``valid`` None) must repeat
        bit-equal."""
        dtn = str(dt)[6:]
        for kern, (fn, plain, valid, tol, bnd) in runs.items():
            got = fn()
            diff, r = rel_err(torch, got, plain())
            check(np.isfinite(r) and r <= tol[dtn],
                  f"{kern} {layer} {dtn}: {r:.3e} > {tol[dtn]}")
            if valid is None:
                check(torch.equal(got, fn()), f"{kern} {layer}: two runs "
                      "differ")
            else:
                check(not got[~valid].any(),
                      f"{kern} {layer}: non-zero rows without a site")
            note(kern, diff, r)
            km, pm = cuda_ms(torch, fn, 10), cuda_ms(torch, plain, 2)
            if dt == bf16:
                per_layer[(layer, kern)] = (km, pm, bnd)
                tally["dg_fwd" if kern == "dg_fwd_subm" else kern].add(
                    km, pm, bnd)
            print(f"  {layer:11s} {kern:17s} {dtn:9s} {r:12.3e}  "
                  f"{km:9.4f}  {pm:8.4f}  {bnd[0]:.4f}")

    def randn(rows, width, valid):
        return (torch.randn((rows, width), device=dev, generator=gen)
                * valid[:, None])

    print("U-Net layers: layer kernel dtype max|d|/max|ref| kernel_ms "
          "plain_ms bound_ms")
    # subm forward at each stage (stage 0: the input's sites)
    stage_valid = [x16[0].valid_mask] + [
        r.out_indices[:, 0] >= 0 for r in downs]
    subm = [(f"enc_subm.{i}", i, ([5] + list(UNET_CHANNELS))[i], c)
            for i, c in enumerate(UNET_CHANNELS)]
    subm += [(f"dec_subm.{j}", levels - 1 - j,
              2 * UNET_CHANNELS[levels - 1 - j], UNET_CHANNELS[levels - 1 - j])
             for j in range(levels)]
    for layer, st_, c, k in subm:
        pos, valid = recs[f"subm{st_}"].pos, stage_valid[st_]
        xf, wf = randn(valid.shape[0], c, valid), torch.randn(
            (27, c, k), device=dev, generator=gen) / float(np.sqrt(27 * c))
        for dt in dtypes:
            x, w = xf.to(dt), wf.to(dt)
            gemm_cases(layer, {"dg_fwd_subm": (
                lambda: D.dg_fwd(x, w, pos), lambda: D.dg_fwd_plain(x, w, pos),
                valid, TOL, gemm_bound(x, w, pos, k))}, dt)
    # strided and inverse: forward, dgrad, wgrad
    for layer, path, i, c, k in (
            [(f"enc_down.{i}", "strided", i, UNET_CHANNELS[i],
              UNET_CHANNELS[i + 1]) for i in range(levels)]
            + [(f"dec_up.{j}", "inverse", levels - 1 - j,
                UNET_CHANNELS[levels - j], UNET_CHANNELS[levels - 1 - j])
               for j in range(levels)]):
        rec = downs[i]
        valid_in = recs[f"__dgreg_in__down{i}"][:, 0] >= 0
        valid_out = rec.out_indices[:, 0] >= 0
        pos, pos_bwd, v_src, v_dst = (
            (rec.pos, rec.pos_div, valid_in, valid_out) if path == "strided"
            else (rec.pos_div, rec.pos, valid_out, valid_in))
        kv = pos.shape[0]
        xf, df = randn(v_src.shape[0], c, v_src), randn(v_dst.shape[0], k,
                                                        v_dst)
        wf = torch.randn((kv, c, k), device=dev, generator=gen) / float(
            np.sqrt(kv * c))
        for dt in dtypes:
            x, w, dout = xf.to(dt), wf.to(dt), df.to(dt)
            gemm_cases(layer, {
                f"dg_fwd_{path}": (
                    lambda: D.dg_fwd(x, w, pos, path),
                    lambda: D.dg_fwd_plain(x, w, pos), v_dst, TOL,
                    gemm_bound(x, w, pos, k)),
                f"dg_dgrad_{path}": (
                    lambda: D.dg_dgrad(dout, w, pos_bwd, path),
                    lambda: D.dg_dgrad_plain(dout, w, pos_bwd), v_src, TOL,
                    gemm_bound(dout, w, pos_bwd, c)),
                f"dg_wgrad_{path}": (
                    lambda: D.dg_wgrad(x, dout, pos_bwd, path),
                    lambda: D.dg_wgrad_plain(x, dout, pos_bwd), None,
                    WGRAD_TOL, wgrad_bound(x, dout, pos_bwd)),
            }, dt)
    print("per bf16 U-Net request or step: " + ", ".join(
        f"{k} {v}" for k, v in tally.items()))

    # ---- serve: three scans after a warm-up, counted and checked
    with torch.inference_mode():
        net16(x16[0])
        torch.cuda.synchronize()
        D.reset_launch_counts()
        serve_ms = []
        for seed in REQUEST_SEEDS:
            x = x16[seed]
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            out = net16(x)
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: D.launch_counts[k] - v for k, v in before.items()}
            check(got == expected(D, **UNET_SERVE),
                  f"U-Net request {seed}: launches {got}")
            check(torch.equal(out.indices, x.indices),
                  f"U-Net request {seed}: output sites differ from the "
                  "input's")
            check(tuple(out.features.shape) == (x.indices.shape[0],
                                                UNET_CLASSES)
                  and out.features.dtype == bf16,
                  f"U-Net request {seed}: output {out.features.shape}")
            check(bool(torch.isfinite(out.features).all())
                  and bool(out.features.any()),
                  f"U-Net request {seed}: output not finite or all 0")
        serve_launches = dict(D.launch_counts)
        for seed, ms in zip(REQUEST_SEEDS, serve_ms):
            _, rel32 = rel_err(torch, net32(scans[seed]).features,
                               plain_unet(torch, net32, scans[seed]))
            check(rel32 <= NET_F32_TOL, f"U-Net request {seed}: f32 "
                  f"{rel32:.3e} > {NET_F32_TOL} of max|ref|")
            out = net16(x16[seed])
            _, bf_rel = rel_err(torch, out.features,
                                plain_unet(torch, net16, x16[seed]))
            active = [int(x16[seed].num_voxels)] + [
                int(out.indice_dict[f"__dgreg__down{i}"].num_out)
                for i in range(levels)]
            print(f"unet request seed={seed} input=synthetic ms={ms:.3f} "
                  f"active_per_level={active} f32_rel_err={rel32:.3e} "
                  f"bf16_rel_vs_plain={bf_rel:.3e}")
        wall, busy, _ = device_busy(torch, lambda: net16(x16[0]), 3)
        peak = peak_mib(torch, lambda: net16(x16[0]))
    print(f"U-Net serve: bf16, ms per request "
          f"{[round(m, 3) for m in serve_ms]}, launches {serve_launches}; "
          + busy_text(wall, busy, 3, "a request")
          + f"; peak allocated {peak[0]:.1f} MiB above the {peak[1]:.1f} "
          "MiB held before the request")

    # ---- train: one bf16 step per scan after a warm-up step
    net = copy.deepcopy(net32).to(bf16)
    B.train_step(net, x16[0], 0.0)
    torch.cuda.synchronize()
    # a step that moves the largest weight by 1 % of the largest weight
    lr = 1e-2 * max(p.abs().max().item() for p in net.parameters()) / max(
        p.grad.abs().max().item() for p in net.parameters())
    D.reset_launch_counts()
    for seed in REQUEST_SEEDS:
        w_before = [p.detach().clone() for p in net.parameters()]
        before = dict(D.launch_counts)
        t0 = time.perf_counter()
        loss = B.train_step(net, x16[seed], lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: D.launch_counts[k] - v for k, v in before.items()}
        check(got == expected(D, **UNET_STEP),
              f"U-Net train step {seed}: launches {got}")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0, f"U-Net train step {seed}: "
              f"loss {loss}")
        for (name, p), w0 in zip(net.named_parameters(), w_before):
            check(p.grad is not None and p.grad.dtype == bf16
                  and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.any()),
                  f"U-Net train step {seed}: {name} grad missing, not "
                  "finite or 0")
            # the SGD update, exactly (some entries move by less than
            # their bf16 rounding step, so "changed" is no test)
            check(torch.equal(p.detach(), w0.add(p.grad, alpha=-lr)),
                  f"U-Net train step {seed}: {name} was not updated")
        print(f"unet train step seed={seed} input=synthetic ms={ms:.3f} "
              f"loss={loss:.6e} lr={lr:.4e}")
    train_launches = dict(D.launch_counts)
    wall, busy, _ = device_busy(
        torch, lambda: B.train_step(net, x16[0], 0.0), 3)
    peak = peak_mib(torch, lambda: B.train_step(net, x16[0], 0.0))
    print(f"U-Net train: bf16, launches over 3 steps {train_launches}; "
          + busy_text(wall, busy, 3, "a step")
          + f"; peak allocated {peak[0]:.1f} MiB above the {peak[1]:.1f} "
          "MiB held before the step")

    # the f32 grads through the kernels against the plain backward on the
    # kernels' forward
    loss_k, loss_p, _, worst = step_vs_plain(
        torch, D, [copy.deepcopy(net32) for _ in range(2)],
        lambda n: zero_lr_step(B, n, scans[0]), "U-Net")
    print(f"unet train f32 seed=0: loss kernels {loss_k:.9e}, plain "
          f"backward {loss_p:.9e}; worst grad max|d|/max|ref| {worst[0]:.3e}"
          f" ({worst[1]}, tolerance {GRAD_F32_TOL} per tensor)")

    # algo="sk": a downsample + inverse pair, bit-equal to "dg" (the same
    # tables and kernels), forward and grads
    with torch.no_grad():
        stage0 = net16.enc_subm[0](x16[0])
    feats = F.relu(stage0.features)

    def pair_run(algo):
        kw = dict(indice_key="down0", algo=algo, dtype=bf16, device=dev)
        down = SparseConv3d(UNET_CHANNELS[0], UNET_CHANNELS[1], 3, stride=2,
                            padding=1, out_bound=net16.enc_down[0].out_bound,
                            **kw)
        down.load_state_dict(net16.enc_down[0].state_dict())
        up = SparseInverseConv3d(UNET_CHANNELS[1], UNET_CHANNELS[0], 3, **kw)
        up.load_state_dict(net16.dec_up[-1].state_dict())
        x = SparseConvTensor(feats.clone().requires_grad_(), stage0.indices,
                             stage0.spatial_shape, 1, keys_sorted=True)
        D.reset_launch_counts()
        h = down(x)
        y = up(h.replace_feature(F.relu(h.features)))
        (y.features.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        return ([y.features.detach(), x.features.grad, down.weight.grad,
                 up.weight.grad], dict(D.launch_counts))

    sk, sk_launches = pair_run("sk")
    dg, dg_launches = pair_run("dg")
    want = expected(D, dg_pos_affine=1, dg_pos_divide=1, dg_fwd_strided=1,
                    dg_fwd_inverse=1, dg_dgrad_strided=1,
                    dg_wgrad_strided=1, dg_dgrad_inverse=1,
                    dg_wgrad_inverse=1)
    check(sk_launches == dg_launches == want,
          f"sk pair launches {sk_launches}, dg pair {dg_launches}")
    check(all(torch.equal(a, b) for a, b in zip(sk, dg)),
          "algo='sk' and algo='dg' differ on the down0 + inverse pair")
    print(f"sk pair (enc_down.0 + dec_up.{levels - 1}, bf16): bit-equal to "
          f"dg, forward and grads; launches {sk_launches}")
    return tally, per_layer, serve_launches, train_launches, sk_launches


def q_bound(x, w, pos, k_out, add, keys=None):
    """B7: ``x`` ``[N_src, C]`` int8, ``w`` ``[kv, C, K]`` int8, ``pos``
    ``[kv, N_dst]`` int32 (or the ``keys``), the f32 scale and bias and the
    int8 residual read once, ``[N_dst, K]`` int8 written once; 2 * C * K
    int8 operations per matched pair of this input."""
    pairs = int((pos >= 0).sum())
    n_dst = pos.shape[1]
    nbytes = (x.numel() + w.numel() + index_bytes(pos, keys) + 8 * k_out
              + n_dst * k_out * (2 if add else 1))
    return bound(nbytes, 2 * pairs * x.shape[1] * k_out, "int8")


def q_layers(qnet, x):
    """The int8 encoder's forward through its own modules, returning the
    int8 output of every top-level layer (conv or residual block)."""
    from spconv_tpu_torch.quantization import quantize_tensor

    cur = x.replace_feature(quantize_tensor(x.features, qnet.input_scale))
    outs = []
    for layer in qnet.layers:
        cur = layer(cur)
        outs.append(cur)
    return outs


def plain_q_layers(torch, qnet, x):
    """:func:`q_layers` with the plain versions of the kernels in place of
    the kernels (every table by ``dg_pos_plain`` or ``dg_pos_affine_plain``,
    every product by ``dg_fwd_q_plain``), on whatever device ``x`` is on,
    with the layers' own int8 weights and folded scales."""
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops.rulebook import build_conv_outputs
    from spconv_tpu_torch.quantization import (QuantizedSparseBasicBlock,
                                               quantize_tensor)

    tables = {}

    def conv(layer, t, add=None, add_scale=1.0):
        cfg = layer.base
        kw = dict(act=layer.act_type, add=None if add is None
                  else add.features, add_scale=add_scale / layer.output_scale)
        keys, _ = C.linearize(t.indices, t.spatial_shape, t.batch_size)
        if cfg.subm:
            if cfg.indice_key not in tables:
                tables[cfg.indice_key] = D.dg_pos_plain(
                    keys, ksize=cfg.kernel_size, dilation=cfg.dilation,
                    spatial_shape=t.spatial_shape, batch_size=t.batch_size)
            q = D.dg_fwd_q_plain(t.features, layer.weight_kv,
                                 tables[cfg.indice_key], layer.scale_q,
                                 layer.bias_q, **kw)
            inds, shape = t.indices, t.spatial_shape
        else:
            geom = dict(ksize=cfg.kernel_size, stride=cfg.stride,
                        padding=cfg.padding, dilation=cfg.dilation)
            inds, out_keys, _, _ = build_conv_outputs(
                t.indices, spatial_shape=t.spatial_shape,
                batch_size=t.batch_size,
                out_bound=cfg._resolve_out_bound(t.indices.shape[0]), **geom)
            shape = tuple(C.get_conv_output_size(
                t.spatial_shape, cfg.kernel_size, cfg.stride, cfg.padding,
                cfg.dilation))
            pos = D.dg_pos_affine_plain(
                keys, out_keys, in_shape=t.spatial_shape, out_shape=shape,
                batch_size=t.batch_size, **geom)
            q = D.dg_fwd_q_plain(t.features, layer.weight_kv, pos,
                                 layer.scale_q, layer.bias_q, **kw)
        valid = inds[:, 0] >= 0
        return SparseConvTensor(torch.where(valid[:, None], q,
                                            torch.zeros_like(q)),
                                inds, shape, t.batch_size, keys_sorted=True)

    cur = x.replace_feature(quantize_tensor(x.features, qnet.input_scale))
    outs = []
    for layer in qnet.layers:
        if isinstance(layer, QuantizedSparseBasicBlock):
            cur = conv(layer.q2, conv(layer.q1, cur), add=cur,
                       add_scale=layer.q2.add_scale)
        else:
            cur = conv(layer, cur)
        outs.append(cur)
    return outs


def int8_phase(torch, dev, gen, cp_in, cp16, cp_net, net32, cp_rec, note,
               b7_count_lib):
    """Phase 8: the int8 (PTQ) CenterPoint encoder.  Observes the scales of
    the f32 encoder ``net32`` (phase 6's buffers) on seed 0 on the card,
    quantizes it, holds B7 bit-equal to its plain version at every layer
    shape (``cp_rec``: phase 3's tables) and at an inverse layer, serves the
    three scans in int8 with their checks, times the int8 requests beside
    the bf16 net ``cp_net``, and runs an int8 downsample + inverse pair.
    Returns ``(tallies, serve_launches, pair_launches, variants, qnet)``:
    B7's kernel, plain and bound ms summed over one int8 request (subm,
    strided) or the inverse layer; one width of each B7 variant with its
    MMA rows counted on the card by ``b7_count_lib``
    (``tools/b7_ablation.py``'s counting build); and the int8 encoder."""
    import numpy as np
    from spconv_tpu_torch import SparseConv3d, SparseInverseConv3d
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.tools import b7_ablation as BA
    from spconv_tpu_torch.quantization import (
        MinMaxObserver, PerChannelMinMaxObserver, QuantizedSparseConv,
        dequantize, observe_encoder_scales, quantize_encoder)

    t0 = time.perf_counter()
    scales = observe_encoder_scales(net32, [cp_in[0]])
    qnet = quantize_encoder(net32, scales=scales)
    print(f"int8: scales observed on seed 0 (f32 on the card) and "
          f"quantized in {time.perf_counter() - t0:.2f} s: "
          f"{json.dumps(scales)}")

    # ---- B7 against its plain version at every layer shape
    tally = {k: Tally() for k in ("dg_fwd_q", "dg_fwd_q_strided",
                                  "dg_fwd_q_inverse")}

    def randq(shape, valid=None):
        q = torch.randint(-127, 128, shape, device=dev, generator=gen,
                          dtype=torch.int32).to(torch.int8)
        return q if valid is None else q * valid[:, None]

    def q_operands(pos, valid_src, c, k, add):
        """Random int8 features on the valid source rows and weights
        (``[kv, C, K]`` views of ``[kv, K, C]`` tensors, as the int8 modules
        hold them), a scale that puts the outputs in and past +-127, a
        bias, the residual (or None)."""
        kv = pos.shape[0]
        x = randq((valid_src.shape[0], c), valid_src)
        w = randq((kv, c, k)).transpose(1, 2).contiguous().transpose(1, 2)
        matched = max(1.0, float((pos >= 0).sum()) / float(
            (pos >= 0).any(0).sum().clamp(min=1)))
        u = torch.rand((2, k), device=dev, generator=gen)
        scale = (0.5 + u[0]) * 60 / (5300 * float(np.sqrt(matched * c)))
        bias = (u[1] - 0.5) * 40
        res = randq((pos.shape[1], k)) if add else None
        return x, w, scale, bias, res

    def q_case(layer, path, pos, valid_src, c, k, add, mult):
        x, w, scale, bias, res = q_operands(pos, valid_src, c, k, add)
        kw = dict(act="relu", add=res, add_scale=0.37)

        def fn():
            return D.dg_fwd_q(x, w, pos, scale, bias, path=path, **kw)

        def plain():
            return D.dg_fwd_q_plain(x, w, pos, scale, bias, **kw)

        name = "dg_fwd_q" if path == "subm" else f"dg_fwd_q_{path}"
        got, ref = fn(), plain()
        diff = (got.int() - ref.int()).abs().max().item()
        check(diff == 0 and torch.equal(got, fn()),
              f"{name} {layer}: differs from plain by {diff} or between "
              "runs")
        note(name, float(diff), 0.0)
        km, pm = cuda_ms(torch, fn, 10), cuda_ms(torch, plain, 2)
        bnd = q_bound(x, w, pos, k, add)
        tally[name].add(km, pm, bnd, mult)
        sat = float((ref.abs() == 127).float().mean())
        print(f"  {layer:14s} {name:16s} {c:4d} {k:4d} N_src "
              f"{x.shape[0]:6d} N_dst {pos.shape[1]:6d} x{mult}  exact  "
              f"(+-127: {100 * sat:.1f} %)  {km:9.4f}  {pm:8.4f}  "
              f"{bnd[0]:.4f}")

    print("int8 layers: layer kernel C K rows times-per-request kernel_ms "
          "plain_ms bound_ms")
    widths = (16, 32, 64, 128)
    for si, c in enumerate(widths):
        pos = cp_rec[f"subm{si}"].pos
        valid = (cp_rec[f"__dgreg__down{si}"].out_indices[:, 0] >= 0 if si
                 else cp_in[0].valid_mask)
        if not si:
            q_case("conv_input", "subm", pos, valid, 5, c, False, 1)
        q_case(f"subm{si} conv1", "subm", pos, valid, c, c, False, 2)
        q_case(f"subm{si} conv2+add", "subm", pos, valid, c, c, True, 2)
    for key, (c, k) in zip(CP_STRIDED, ((16, 32), (32, 64), (64, 128),
                                       (128, 128))):
        rec = cp_rec[f"__dgreg__{key}"]
        q_case(key, "strided", rec.pos,
               cp_rec[f"__dgreg_in__{key}"][:, 0] >= 0, c, k, False, 1)
    # the inverse of down1 (k3 s2 p1 off the 113,664-row input, bound
    # 112,128: also the U-Net's enc_down.0 in phase 7) at dec_up.1's widths
    rec = cp_rec["__dgreg__down1"]
    div = D.build_dg_pos_divide(
        rec.in_keys, rec.out_keys, ksize=rec.ksize, stride=rec.stride,
        padding=rec.padding, dilation=rec.dilation, in_shape=rec.in_shape,
        out_shape=rec.out_shape, batch_size=1)
    q_case("inverse down1", "inverse", div, rec.out_indices[:, 0] >= 0,
           32, 16, False, 1)
    print("per int8 CenterPoint request: " + ", ".join(
        f"{k} {v}" for k, v in tally.items()))

    # one width of each B7 variant at the stage-0 shape, bit-equal to plain
    # (bias, relu), timed, and the MMA rows it issues counted on the card
    # by the counting build, which must equal the host model's count
    pos0, valid0 = cp_rec["subm0"].pos, cp_in[0].valid_mask
    b7_variants = {}
    print("B7 variants at the CenterPoint stage-0 shape: C K tile grid vec "
          "packed kernel_ms bound_ms, MMA rows issued (counted on the "
          "card; gated equal to the host model) / needed by the matched "
          "pairs (a host count from the table)")
    for c, k in B7_WIDTHS:
        x, w, scale, bias, _ = q_operands(pos0, valid0, c, k, False)
        v = D.b7_variant(x.shape[0], c, k, aligned=x.data_ptr() % 16 == 0)
        got = D.dg_fwd_q(x, w, pos0, scale, bias, act="relu")
        check(torch.equal(got, D.dg_fwd_q_plain(x, w, pos0, scale, bias,
                                                act="relu")),
              f"B7 variant C={c} K={k}: differs from plain")
        km = cuda_ms(torch, lambda: D.dg_fwd_q(
            x, w, pos0, scale, bias, act="relu"), 10)
        bnd = q_bound(x, w, pos0, k, False)
        issued = BA.issued_mma_rows(b7_count_lib, x, w, pos0, scale, bias)
        model, needed = D.b7_mma_rows(pos0, c, k)
        check(issued == model, f"B7 C={c} K={k}: the card issued {issued} "
              f"MMA rows, the host model counts {model}")
        b7_variants[f"C{c}_K{k}"] = dict(
            tile=[v.bm, v.bn], grid=list(v.grid), vec=v.vec,
            packed=v.packed, ms=km, bound_ms=bnd[0],
            mma_rows_issued=issued)
        print(f"  {c:4d} {k:4d} {v.bm}x{v.bn} {v.grid} {v.vec} {v.packed}  "
              f"{km:9.4f}  {bnd[0]:.4f}  {issued} / {needed} = "
              f"{issued / needed:.4f}")

    # ---- serve three scans in int8, counted and checked
    with torch.inference_mode():
        qnet.bev(cp_in[0])  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        served = []
        for seed in REQUEST_SEEDS:
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            bev = qnet.bev(cp_in[seed])
            torch.cuda.synchronize()
            served.append(((time.perf_counter() - t0) * 1e3, bev))
            got = {k: D.launch_counts[k] - v for k, v in before.items()}
            check(got == expected(D, **CP_INT8_LAUNCHES),
                  f"int8 request {seed}: launches {got}")
        serve_launches = dict(D.launch_counts)

        for seed, (ms, bev) in zip(REQUEST_SEEDS, served):
            check(tuple(bev.shape) == (1, 512, 128, 128)
                  and bev.dtype == torch.float32,
                  f"int8 request {seed}: bev {tuple(bev.shape)} {bev.dtype}")
            outs = q_layers(qnet, cp_in[seed])
            ref = plain_q_layers(torch, qnet, cp_in[seed])
            for i, (g, r) in enumerate(zip(outs, ref)):
                check(torch.equal(g.indices, r.indices),
                      f"int8 request {seed}: layer {i} coordinates differ "
                      "from the plain run")
                check(g.features.dtype == torch.int8
                      and torch.equal(g.features, r.features),
                      f"int8 request {seed}: layer {i} int8 features differ "
                      "from the plain run")
            last = outs[-1]
            check(torch.equal(bev, last.replace_feature(dequantize(
                last.features, qnet.out_scale)).dense().reshape(bev.shape)),
                  f"int8 request {seed}: served BEV differs from its layers")
            ref32 = net32.bev(cp_in[seed])
            scale = ref32.abs().max().item()
            err = (bev - ref32).abs().max().item() / max(scale, 1e-30)
            l2 = ((bev - ref32).norm() / ref32.norm().clamp(min=1e-30)).item()
            check(np.isfinite(err) and err <= INT8_MAX_ERR
                  and l2 <= INT8_L2_ERR,
                  f"int8 request {seed}: BEV vs f32 max err {err:.4f} "
                  f"(<= {INT8_MAX_ERR}), L2 {l2:.4f} (<= {INT8_L2_ERR})")
            sat = float((last.features.abs() == 127).float().mean())
            print(f"int8 request seed={seed} input=synthetic ms={ms:.3f} "
                  f"active_per_layer={[int(t.num_voxels) for t in outs]} "
                  f"bev_vs_f32 max_err/max|ref|={err:.4f} L2={l2:.4f} "
                  f"(+-127 at the output: {100 * sat:.2f} %); int8 equal to "
                  "the plain run at every layer")

        # host ms of the bf16 and the int8 request, in turns; device busy
        # and peak memory of each in profiler windows
        runs = {"bf16": lambda s: cp_net.bev(cp16[s]),
                "int8": lambda s: qnet.bev(cp_in[s])}
        host = {k: [] for k in runs}
        for order in (("bf16", "int8"), ("int8", "bf16")):
            for seed in REQUEST_SEEDS:
                for name in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[name](seed)
                    torch.cuda.synchronize()
                    host[name].append((time.perf_counter() - t0) * 1e3)
        windows = {}
        for name in ("bf16", "int8", "int8", "bf16"):
            windows.setdefault(name, []).append(
                device_busy(torch, lambda: runs[name](0), 3))
        peaks = {k: peak_mib(torch, lambda: fn(0)) for k, fn in runs.items()}

        # the served request reads each layer's [kv, K, C] weight as it
        # is: its profiler window holds no copy of a tensor of a layer
        # weight's shape, where the same request with the weights held
        # [kv, C, K] copies each one (the ops' records on the host, which
        # the profiler keeps in full; it can lose a device op's record now
        # and then)
        qmods = [m for m in qnet.modules()
                 if isinstance(m, QuantizedSparseConv)]
        served = weight_copies(torch, lambda: runs["int8"](0), qmods)
        held = [m.weight_kc for m in qmods]
        for m in qmods:
            m.weight_kc = m.weight_kv.contiguous().transpose(1, 2)
        try:
            copied = weight_copies(torch, lambda: runs["int8"](0), qmods)
        finally:
            for m, wkc in zip(qmods, held):
                m.weight_kc = wkc
        check(len(qmods) == 21 and served[0] == 0
              and copied[0] == len(qmods),
              f"int8 request: {served[0]} weight copies ({len(qmods)} int8 "
              f"layers); with the weights held [kv, C, K] {copied[0]}, "
              "one a layer expected")
    print(f"int8 request: no weight copy, {served[1]} device ops, "
          f"{served[2]} of them B7 (with the weights held [kv, C, K]: "
          f"{copied[0]} copies, {copied[1]} device ops)")
    for name in runs:
        busy = [b / w for w, b, _ in windows[name] if b]
        print(f"CenterPoint {name} request: host ms "
              f"{[round(m, 3) for m in host[name]]} (median "
              f"{float(np.median(host[name])):.3f}); profiler windows of 3: "
              + "; ".join(
                  f"{w / 3:.3f} ms a request, {n / 3:.0f} device ops, "
                  "device busy "
                  + (f"{b / 3:.3f} ms ({100 * b / w:.1f} %, idle "
                     f"{100 - 100 * b / w:.1f} %)" if b else "not measured")
                  for w, b, n in windows[name])
              + f"; peak allocated {peaks[name][0]:.1f} MiB above the "
              f"{peaks[name][1]:.1f} MiB held before the request"
              + (f"; busy share {min(busy):.3f}-{max(busy):.3f}" if busy
                 else ""))

    # ---- an int8 downsample + inverse pair at the U-Net's enc_down.0 /
    # dec_up.1 geometry, on the int8 stage-0 output of seed 0
    wgen = torch.Generator().manual_seed(3)
    kw = dict(indice_key="down0", device=dev, generator=wgen)
    down = SparseConv3d(16, 32, 3, stride=2, padding=1,
                        out_bound=cp_net.downs[0].out_bound, **kw)
    up = SparseInverseConv3d(32, 16, 3, **kw)
    with torch.inference_mode():
        x8 = q_layers(qnet, cp_in[0])[2]
        s0 = scales["blocks"][0][-1][1]
        obs = [MinMaxObserver(), MinMaxObserver()]
        h = down(x8.replace_feature(dequantize(x8.features, s0)))
        h = h.replace_feature(torch.relu(h.features))
        obs[0].observe(h)
        obs[1].observe(torch.relu(up(h).features))

        def qconv(conv, s_in, s_out):
            wobs = PerChannelMinMaxObserver()
            wobs.observe(conv.weight)
            return QuantizedSparseConv(conv, wobs.scale, s_in, s_out,
                                       act_type="relu")

        qd, qu = qconv(down, s0, obs[0].scale), qconv(up, obs[0].scale,
                                                      obs[1].scale)
        torch.cuda.synchronize()
        D.reset_launch_counts()
        y = qd(x8)
        z = qu(y)
        torch.cuda.synchronize()
        pair_launches = dict(D.launch_counts)
        check(pair_launches == expected(
            D, dg_pos_affine=1, dg_pos_divide=1, dg_fwd_q_strided=1,
            dg_fwd_q_inverse=1), f"int8 pair launches {pair_launches}")
        rec = y.indice_dict["__dgreg__down0"]
        geom = dict(ksize=rec.ksize, stride=rec.stride, padding=rec.padding,
                    dilation=rec.dilation, in_shape=rec.in_shape,
                    out_shape=rec.out_shape, batch_size=1)
        aff = D.dg_pos_affine_plain(rec.in_keys, rec.out_keys, **geom)
        div = D.dg_pos_divide_plain(rec.in_keys, rec.out_keys, **geom)
        y_ref = D.dg_fwd_q_plain(x8.features, qd.weight_kv, aff, qd.scale_q,
                                 qd.bias_q, act="relu")
        y_ref = y_ref * (rec.out_indices[:, :1] >= 0)
        z_ref = D.dg_fwd_q_plain(y.features, qu.weight_kv, div, qu.scale_q,
                                 qu.bias_q, act="relu")
        z_ref = z_ref * x8.valid_mask[:, None]
        check(torch.equal(rec.pos, aff) and torch.equal(rec.pos_div, div),
              "int8 pair: tables differ from plain")
        check(torch.equal(y.features, y_ref) and torch.equal(z.features,
                                                             z_ref),
              "int8 pair: int8 features differ from plain")
        check(torch.equal(z.indices, x8.indices)
              and bool(z.features.any()),
              "int8 pair: the inverse's sites are not the input's, or 0")
    print(f"int8 pair (down0 16->32 + inverse 32->16 on seed 0's int8 stage "
          f"0): bit-equal to plain; launches {pair_launches}")
    return tally, serve_launches, pair_launches, b7_variants, qnet


def pool_bound(n_act, n_buf, m, c, esz):
    """B6: the features of the ``n_act`` active input rows read once (the
    only rows a child can match), the ``[m, c]`` output written once and
    both key arrays read once; a compare or an add per element, so bound
    by bytes."""
    return bound((n_act + m) * c * esz + 4 * (n_buf + m))


def edge_tables(torch, dev, kind):
    """B1 bit-equal to its plain version at every edge input of
    ``spconv_tpu_torch/tools/table_cases.py``, through the public entry
    and through the windowed path (``b1_window_plan``; the entry takes the
    direct path for small tables): ``kind`` "subm" (each case's subm
    kernels, forward and reversed), "affine" or "divide" (its regular
    convs), or "transposed" (both tables of a transposed conv with each
    regular conv's geometry, on the swapped spaces, counted as
    ``path="transposed"``).  Returns the number of tables checked."""
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops.rulebook import (build_conv_outputs,
                                               build_deconv_outputs)
    from spconv_tpu_torch.tools.table_cases import TABLE_CASES, table_case

    import numpy as np
    from spconv_tpu_torch._build import load_library

    def windowed(rows, table, tg, batch):
        """The table through B1's windowed path whatever its size (the
        public entry takes the direct path for small tables)."""
        pos = torch.empty((int(np.prod(tg.ksize)), rows.shape[0]),
                          dtype=torch.int32, device=dev)
        plan = D.b1_window_plan(rows.shape[0], tg.ksize, tg.stride,
                                tg.divide, sms=D.sm_count(rows.device.index))
        check(D.launch_b1(load_library(), rows, table, tg,
                          C.grid_sentinel(tg.row_dims, batch), plan,
                          pos) == 0, "B1's windowed launch failed")
        return pos

    checked = 0
    for name in TABLE_CASES:
        inds_np, shape, batch, subm, regular = table_case(name)
        inds = torch.from_numpy(inds_np).to(dev)
        keys, _ = C.linearize(inds, shape, batch)
        if kind == "subm":
            for ksize, dil in subm:
                for rev in (False, True):
                    geom = dict(ksize=ksize, dilation=dil,
                                spatial_shape=shape, batch_size=batch,
                                reverse=rev)
                    want = D.dg_pos_plain(keys, **geom)
                    check(torch.equal(D.build_dg_pos(keys, **geom), want)
                          and torch.equal(windowed(
                              keys, keys, D.TableGeom.subm(ksize, dil, shape,
                                                           rev), batch),
                              want),
                          f"B1 subm {name} {ksize} reverse={rev} differs "
                          "from plain at its edge input")
                    checked += 2
            continue
        for ksize, stride, padding, dil in regular:
            conv = dict(ksize=ksize, stride=stride, padding=padding,
                        dilation=dil)
            if kind == "transposed":
                zero = (0,) * len(shape)
                _, t_keys, _, _ = build_deconv_outputs(
                    inds, spatial_shape=shape, batch_size=batch,
                    out_padding=zero, **conv)
                geom = dict(conv, in_shape=tuple(C.get_deconv_output_size(
                    shape, ksize, stride, padding, dil, zero)),
                            out_shape=shape, batch_size=batch)
                spaces, path, modes = ((t_keys, keys), "transposed",
                                       ("affine", "divide"))
            else:
                _, out_keys, _, _ = build_conv_outputs(
                    inds, spatial_shape=shape, batch_size=batch,
                    out_bound=inds.shape[0], **conv)
                geom = dict(conv, in_shape=shape, out_shape=tuple(
                    C.get_conv_output_size(shape, ksize, stride, padding,
                                           dil)), batch_size=batch)
                spaces, path, modes = (keys, out_keys), "strided", (kind,)
            for mode in modes:
                build, plain = ((D.build_dg_pos_affine,
                                 D.dg_pos_affine_plain) if mode == "affine"
                                else (D.build_dg_pos_divide,
                                      D.dg_pos_divide_plain))
                want = plain(*spaces, **geom)
                tg = D.TableGeom.regular(mode == "divide", **{
                    k: v for k, v in geom.items() if k != "batch_size"})
                rows, table = spaces if mode == "divide" else spaces[::-1]
                check(torch.equal(build(*spaces, path=path, **geom), want)
                      and torch.equal(windowed(rows, table, tg, batch),
                                      want),
                      f"B1 {mode} ({path}) {name} {conv} differs from "
                      "plain at its edge input")
                checked += 2
    return checked


def edge_pools(torch, dev):
    """B6 against its plain version at every pool edge input of
    ``tools/table_cases.py``, f32 and bf16, max and mean, with a NaN, a
    +inf and a -inf feature: max bit-equal (NaN where plain has it), mean
    within ``SK_MEAN_TOL`` of max|ref|; and on a view of the features 2
    bytes off 16-byte alignment (the scalar path).  Returns the number of
    pools checked."""
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import sorted_pool as SKP
    from spconv_tpu_torch.ops.rulebook import build_pool2_outputs
    from spconv_tpu_torch.tools.table_cases import POOL_CASES, pool_case

    checked = 0
    for name in POOL_CASES:
        feats, inds_np, shape, batch = pool_case(name)
        inds = torch.from_numpy(inds_np).to(dev)
        in_keys, _ = C.linearize(inds, shape, batch)
        _, out_keys, _, _ = build_pool2_outputs(
            inds, spatial_shape=shape, batch_size=batch,
            out_bound=inds.shape[0])
        kw = dict(in_shape=shape, out_shape=tuple(s // 2 for s in shape),
                  batch_size=batch)
        xf = torch.from_numpy(feats).to(dev)
        rows = torch.nonzero(inds[:, 0] >= 0).squeeze(1)
        xf[rows[3], 0] = float("nan")
        xf[rows[10], -1] = float("inf")
        xf[rows[20], 0] = float("-inf")
        for dt in (torch.float32, torch.bfloat16):
            x = xf.to(dt)
            view = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:]
            view = view.view_as(x).copy_(x)
            for mode in ("max", "mean"):
                for feat in (x, view):
                    got = SKP.sk_pool2(feat, in_keys, out_keys, mode=mode,
                                       **kw)
                    ref = SKP.sk_pool2_plain(feat, in_keys, out_keys,
                                             mode=mode, **kw)
                    same_nan = torch.equal(got.isnan(), ref.isnan())
                    if mode == "max":
                        ok = same_nan and torch.equal(got.nan_to_num(),
                                                      ref.nan_to_num())
                    else:
                        fin = torch.isfinite(ref)
                        _, r = rel_err(torch, got[fin], ref[fin])
                        ok = same_nan and r <= SK_MEAN_TOL and torch.equal(
                            got[~fin].nan_to_num(), ref[~fin].nan_to_num())
                    check(ok, f"B6 {mode} {dt} {name} differs from plain at "
                          "its edge input")
                    checked += 1
    return checked


def table_fallbacks(torch, dev, geo, count_lib):
    """B1's windows that did not fit in its pool whole (their searches end
    in global memory, sampled or not), counted on the card by the counting
    build (``tools/table_count.py``), for each BenchNet stage's forward and
    reversed table and the dense "slab" and "full_pool" inputs of
    ``tools/table_cases.py``: each count equal to the host's
    (``table_count.b1_fallbacks``), the two inputs' above 0, the
    "full_pool" input's with windows that the host finds left without a
    sample (the first window fills the pool), and every counting-build
    table bit-equal to plain.  Returns ``{label: count}``."""
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.tools import table_count as TCN
    from spconv_tpu_torch.tools.table_cases import table_case

    cases = [(f"stage {s}", C.linearize(g.indices, g.spatial_shape, 1)[0],
              tuple(g.spatial_shape), 1, KSIZE, DIL)
             for s, g in enumerate(geo)]
    for name in ("slab", "full_pool"):
        inds, shape, batch, subm, _ = table_case(name)
        cases.append((name, C.linearize(torch.from_numpy(inds).to(dev),
                                        shape, batch)[0], shape, batch)
                     + subm[0])
    counts = {}
    unsampled = 0
    for label, keys, dims, batch, ksize, dil in cases:
        sent = C.grid_sentinel(dims, batch)
        for rev in (False, True):
            tg = D.TableGeom.subm(ksize, dil, dims, rev)
            plan = D.b1_plan(keys.shape[0], ksize,
                             sms=D.sm_count(keys.device.index))
            card, pos = TCN.fallen_back(count_lib, keys, keys, tg, sent,
                                        plan)
            host, none = TCN.b1_fallbacks(
                TCN.b1_windows(keys, keys, tg, sent, plan), plan,
                keys.shape[0])
            check(torch.equal(pos, D.dg_pos_plain(
                keys, ksize=ksize, dilation=dil, spatial_shape=dims,
                batch_size=batch, reverse=rev)),
                f"B1 counting build {label} reverse={rev} differs from "
                "plain")
            check(card == host, f"B1 {label} reverse={rev}: {card} windows "
                  f"fell back on the card, {host} on the host")
            counts[f"{label}{' reversed' if rev else ''}"] = card
            if label == "full_pool":
                unsampled += none
    check(all(counts[k] > 0 for k in ("slab", "slab reversed", "full_pool",
                                      "full_pool reversed")),
          f"the edge inputs' windows all fit whole: {counts}")
    check(unsampled > 0, "no window of the full_pool input is left without "
          "a sample")
    return counts


def sk_pool_phase(torch, dev, gen, scans, geo, bounds, served):
    """Phase 9: the sorted-key pool (B6).  The kernel against its plain
    version at the six BenchNet pool shapes (``geo``: each pool's input,
    ``bounds``: its output buffer), max and mean, f32 and bf16, timed with
    the seg route (``pool2_seg``) beside it; NaN and +-inf on the card; the
    backward on the card against the CPU's.  Then the bf16 BenchNet with
    its six pools on ``algo="sk"``: served on the three scans (bit-equal to
    phase 4's seg-pool outputs in ``served``), trained three steps, the f32
    grads against the plain backward; and an ``algo="sk"``
    ``SparseAvgPool3d`` net against the seg mean route.  Returns ``(tally
    by mode, seg-route ms by mode, (max|d|, max|d|/max|ref|) by mode,
    serve launches, train launches, avg-net launches)``."""
    import numpy as np
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.modules import SparseAvgPool3d, SparseMaxPool3d
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops import sorted_pool as SKP
    from spconv_tpu_torch.ops.pool import pool2_seg
    from spconv_tpu_torch.ops.rulebook import build_pool2_outputs

    modes = ("max", "mean")
    tally = {m: Tally() for m in modes}
    seg_ms = dict.fromkeys(modes, 0.0)
    errs = {m: (0.0, 0.0) for m in modes}
    print("sk_pool: pool rows_in active C rows_out(bound) dtype mode "
          "max|d|/max|ref| kernel_ms plain_ms seg_route_ms bound_ms")
    for s in range(6):
        g = geo[s]
        c = B.CHANNELS[2 * s + 2]
        n, n_act = g.indices.shape[0], int(g.num_voxels)
        _, out_keys, n_out, _ = build_pool2_outputs(
            g.indices, spatial_shape=g.spatial_shape, batch_size=1,
            out_bound=bounds[s])
        in_keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        kw = dict(in_shape=g.spatial_shape, out_shape=geo[s + 1].spatial_shape,
                  batch_size=1)
        xf = torch.randn((n, c), device=dev, generator=gen) \
            * g.valid_mask[:, None]
        for dt in (torch.float32, torch.bfloat16):
            x = xf.to(dt).contiguous()
            dtn = str(dt)[6:]
            for mode in modes:
                got = SKP.sk_pool2(x, in_keys, out_keys, mode=mode, **kw)
                ref = SKP.sk_pool2_plain(x, in_keys, out_keys, mode=mode,
                                         **kw)
                seg = pool2_seg(x, g.indices, spatial_shape=g.spatial_shape,
                                batch_size=1, out_bound=bounds[s],
                                mode=mode)[0]
                diff, r = rel_err(torch, got, ref)
                if mode == "max":
                    check(torch.equal(got, ref), f"sk_pool max pool {s} "
                          f"{dtn}: differs from plain ({diff:.3e})")
                    check(torch.equal(got, seg), f"sk_pool max pool {s} "
                          f"{dtn}: differs from the seg route")
                else:
                    check(r <= SK_MEAN_TOL, f"sk_pool mean pool {s} {dtn}: "
                          f"{r:.3e} > {SK_MEAN_TOL} of max|ref|")
                    _, r_seg = rel_err(torch, got, seg)
                    check(r_seg <= TOL[dtn], f"sk_pool mean pool {s} {dtn}: "
                          f"{r_seg:.3e} from the seg route")
                errs[mode] = (max(errs[mode][0], diff),
                              max(errs[mode][1], r))
                km = cuda_ms(torch, lambda: SKP.sk_pool2(
                    x, in_keys, out_keys, mode=mode, **kw), 20)
                pm = cuda_ms(torch, lambda: SKP.sk_pool2_plain(
                    x, in_keys, out_keys, mode=mode, **kw), 3)
                sm = cuda_ms(torch, lambda: pool2_seg(
                    x, g.indices, spatial_shape=g.spatial_shape,
                    batch_size=1, out_bound=bounds[s], mode=mode), 5)
                bnd = pool_bound(n_act, n, bounds[s], c, x.element_size())
                if dt == torch.bfloat16:
                    tally[mode].add(km, pm, bnd)
                    seg_ms[mode] += sm
                print(f"  pool{s} {n:6d} {n_act:6d} {c:4d} {int(n_out):6d}"
                      f"({bounds[s]}) {dtn:9s} {mode:4s} {r:12.3e}  "
                      f"{km:9.4f}  {pm:8.4f}  {sm:8.4f}  {bnd[0]:.4f}")
        if s == 0:
            # non-finite features, and the backward on the card vs the CPU
            bad = xf.clone()
            rows = torch.nonzero(g.valid_mask).squeeze(1)
            bad[rows[5], 1] = float("nan")
            bad[rows[50], 2] = float("inf")
            bad[rows[80], 3] = float("-inf")
            dout = torch.randn((bounds[s], c), device=dev, generator=gen)
            for dt in (torch.float32, torch.bfloat16):
                for mode in modes:
                    xb = bad.to(dt).contiguous()
                    got = SKP.sk_pool2(xb, in_keys, out_keys, mode=mode, **kw)
                    ref = SKP.sk_pool2_plain(xb, in_keys, out_keys,
                                             mode=mode, **kw)
                    same = torch.equal(got.isnan(), ref.isnan()) and \
                        torch.equal(torch.nan_to_num(got),
                                    torch.nan_to_num(ref))
                    check(same and (mode == "mean"
                                    or bool(torch.isfinite(got).all())),
                          f"sk_pool {mode} {dt} with NaN/inf differs from "
                          "plain")
                    # a grid of 0.5, so that children tie
                    xg = (xf * 2).round().div(2).to(dt)
                    args = (in_keys, out_keys, (kw["in_shape"],
                                                kw["out_shape"], 1, mode))
                    cuda_x = xg.clone().requires_grad_()
                    out = SKP.SKPool2Fn.apply(cuda_x, *args)
                    out.backward(dout.to(dt))
                    cpu_x = xg.cpu().requires_grad_()
                    out_c = SKP.SKPool2Fn.apply(
                        cpu_x, in_keys.cpu(), out_keys.cpu(), args[2])
                    out_c.backward(dout.to(dt).cpu())
                    _, r = rel_err(torch, cuda_x.grad.cpu(), cpu_x.grad)
                    check(r <= SK_MEAN_TOL, f"sk_pool {mode} {dt} backward "
                          f"on the card vs the CPU: {r:.3e}")
            print("  pool0: NaN/+-inf inputs equal to plain (max finite); "
                  "the backward on the card equal to the CPU's")
    print(f"per bf16 forward (6 pools): max {tally['max']}, seg route "
          f"{seg_ms['max']:.4f} ms; mean {tally['mean']}, seg route "
          f"{seg_ms['mean']:.4f} ms")
    print(f"  B6 at the edge inputs: {edge_pools(torch, dev)} pools equal to "
          "plain")

    def sk_net(dtype, cls=SparseMaxPool3d, algo="sk", train=False):
        net = B.BenchNet(SHAPE, dtype=dtype, pool_bounds=bounds, device=dev,
                         seed=0)
        for i in range(6):
            net.pools[i] = cls(2, 2, algo=algo, out_bound=bounds[i])
        return net if train else net.eval()

    # serve: 3 requests, each bit-equal to phase 4's seg-pool net
    net = sk_net(torch.bfloat16)
    seg_net = B.BenchNet(SHAPE, dtype=torch.bfloat16, pool_bounds=bounds,
                         device=dev, seed=0).eval()
    per_request = expected(D, dg_pos=7, dg_fwd=14, sk_pool=6)
    with torch.inference_mode():
        net(served[0][1])  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        for seed, x, stages, seg_ms_req in served:
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            got = net.forward_stages(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            delta = {k: D.launch_counts[k] - before[k] for k in before}
            check(delta == per_request, f"sk-pool request {seed}: launches "
                  f"{delta}, expected {per_request}")
            for i, (a, b) in enumerate(zip(got, stages)):
                check(torch.equal(a.indices, b.indices)
                      and torch.equal(a.features, b.features),
                      f"sk-pool request {seed}: stage {i} differs from the "
                      "seg-pool net's")
            print(f"sk-pool request seed={seed} ms={ms:.3f} (seg-pool "
                  f"phase 4: {seg_ms_req:.3f}); output bit-equal to the "
                  "seg-pool net's at every stage")
        serve_launches = dict(D.launch_counts)
        x0 = served[0][1]
        busy = [(name, device_busy(torch, lambda: m(x0), 3))
                for name, m in (("seg", seg_net), ("sk", net), ("sk", net),
                                ("seg", seg_net))]
    print("sk-pool vs seg-pool BenchNet, 3 bf16 requests of seed 0 a "
          "window, in turns: " + turns_text(busy))

    # train: 3 bf16 steps
    step = dict(dg_pos=7, dg_pos_rev=7, dg_fwd=14, dg_dgrad=13, dg_wgrad=14,
                sk_pool=6)
    net = sk_net(torch.bfloat16, train=True)
    # phase 4's inputs are inference tensors, which autograd cannot save
    xs = [B.make_bench_input(*scans[s], dtype=torch.bfloat16, device=dev)
          for s in REQUEST_SEEDS]
    B.train_step(net, xs[0], 0.0)  # warm-up, no update
    torch.cuda.synchronize()
    lr = 1e-2 * max(p.abs().max().item() for p in net.parameters()) / max(
        p.grad.abs().max().item() for p in net.parameters())
    D.reset_launch_counts()
    for seed, x in zip(REQUEST_SEEDS, xs):
        before = dict(D.launch_counts)
        t0 = time.perf_counter()
        loss = B.train_step(net, x, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: D.launch_counts[k] - before[k] for k in before}
        check(delta == expected(D, **step), f"sk-pool train step {seed}: "
              f"launches {delta}")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0, f"sk-pool step {seed}: loss "
              f"{loss}")
        for name, p in net.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.any()),
                  f"sk-pool step {seed}: {name} grad missing, 0 or not "
                  "finite")
        print(f"sk-pool train step seed={seed} ms={ms:.3f} loss={loss:.6e}")
    train_launches = dict(D.launch_counts)

    # the f32 net: grads through the kernels vs the plain conv backward,
    # both with the sk pools' forward on B6 and their torch-ops backward
    x32 = B.make_bench_input(*scans[0], device=dev)
    *losses, _, worst = step_vs_plain(
        torch, D, [sk_net(torch.float32, train=True) for _ in range(2)],
        lambda n: zero_lr_step(B, n, x32), "sk-pool")
    print(f"sk-pool train f32 seed=0: loss kernels {losses[0]:.9e}, plain "
          f"conv backward {losses[1]:.9e}; worst weight grad "
          f"max|d|/max|ref| {worst[0]:.3e} ({worst[1]}, tolerance "
          f"{GRAD_F32_TOL})")

    # SparseAvgPool3d on algo="sk" against the seg mean route
    avg_sk = sk_net(torch.bfloat16, SparseAvgPool3d)
    avg_seg = sk_net(torch.bfloat16, SparseAvgPool3d, algo="seg")
    with torch.inference_mode():
        D.reset_launch_counts()
        a_st = avg_sk.forward_stages(x0)
        torch.cuda.synchronize()
        avg_launches = dict(D.launch_counts)
        check(avg_launches == per_request,
              f"avg sk-pool launches {avg_launches}")
        b_st = avg_seg.forward_stages(x0)
        rels = []
        for i, (a, b) in enumerate(zip(a_st, b_st)):
            check(torch.equal(a.indices, b.indices),
                  f"avg nets: stage {i} coordinates differ")
            rels.append(rel_err(torch, a.features, b.features)[1])
            check(rels[-1] <= TOL["bfloat16"], f"avg nets: stage {i} "
                  f"{rels[-1]:.3e} > {TOL['bfloat16']}")
    print(f"avg-pool BenchNet (bf16, seed 0), algo='sk' vs the seg mean "
          f"route: max|d|/max|ref| per stage {[f'{r:.2e}' for r in rels]}; "
          f"launches {avg_launches}")
    return (tally, seg_ms, errs, serve_launches, train_launches,
            avg_launches)


def search_phase(torch, dev, gen, scans, geo, bounds, served, note):
    """Phase 10: the table-free subm conv, S1-S4 (the search mode of B2, B3
    and B7).  S1, S2 and S3 against their plain versions and bit-equal to
    B1 followed by the table-mode kernel at every BenchNet layer shape
    (``geo``: each stage's input), f32 and bf16, timed beside that table
    path, and once at kernel 5^3 (four search groups); S4 the same at
    ``bench.py``'s ``run_int8`` layers, with and without the residual, and
    that section's four times.  Then BenchNet with no ``indice_key``:
    served on phase 4's inputs (``served``, bit-equal to its keyed net at
    every stage), host ms, device busy and peak memory in turns with the
    keyed net; trained three steps, the f32 grads against the plain
    backward; and an int8 no-key conv against the same layer on a key.
    Returns ``(tallies, table-path ms, serve launches, train launches, int8
    launches, run_int8 ms)``."""
    import numpy as np
    from spconv_tpu_torch import SparseConvTensor, SubMConv3d
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.quantization import (PerChannelMinMaxObserver,
                                               QuantizedSparseConv)

    names = ("dg_fwd_search", "dg_dgrad_search", "dg_wgrad_search",
             "dg_fwd_q_search")
    tally = {k: Tally() for k in names}
    table_ms = dict.fromkeys(names, 0.0)
    bf16 = torch.bfloat16

    def checked(kern, fn, plain, table, tol, what):
        """``fn()`` against ``plain()`` (within ``tol`` of max|ref|, or
        exactly when ``tol`` is 0) and bit-equal to ``table()`` (B1 +
        the table-mode kernel) and to a second run."""
        got = fn()
        diff, r = rel_err(torch, got, plain())
        check(np.isfinite(r) and r <= tol, f"{kern} {what}: {r:.3e} > "
              f"{tol} of max|ref| from plain")
        check(torch.equal(got, table()), f"{kern} {what}: differs from B1 "
              "+ the table kernel")
        check(torch.equal(got, fn()), f"{kern} {what}: two runs differ")
        note(kern, diff, r)
        return r

    def layer_case(g, geom, c, k, what, timed):
        """S1-S3 at one layer of input ``g``: random features and dout on
        its active rows, random weights; checks both dtypes and returns
        the bf16 ``{kernel: (ms, plain ms, bound, table-path ms)}`` when
        ``timed``."""
        keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        tab = geom._asdict()
        kv = int(np.prod(geom.ksize))
        pos = D.build_dg_pos(keys, **tab)
        rev = D.build_dg_pos(keys, reverse=True, **tab)
        n = keys.shape[0]
        valid = g.valid_mask[:, None]
        xf = torch.randn((n, c), device=dev, generator=gen) * valid
        wf = torch.randn((kv, c, k), device=dev, generator=gen) \
            / float(np.sqrt(kv * c))
        df = torch.randn((n, k), device=dev, generator=gen) * valid
        times = {}
        for dt in (torch.float32, bf16):
            dtn = str(dt)[6:]
            x, w, dout = (t.to(dt).contiguous() for t in (xf, wf, df))
            cases = {
                "dg_fwd_search": (
                    lambda: D.dg_fwd_search(x, w, keys, geom),
                    lambda: D.dg_fwd_search_plain(x, w, keys, geom),
                    lambda: D.dg_fwd(x, w, D.build_dg_pos(keys, **tab)),
                    TOL[dtn], gemm_bound(x, w, pos, k, keys=keys)),
                "dg_dgrad_search": (
                    lambda: D.dg_dgrad_search(dout, w, keys, geom),
                    lambda: D.dg_dgrad_search_plain(dout, w, keys, geom),
                    lambda: D.dg_dgrad(dout, w, D.build_dg_pos(
                        keys, reverse=True, **tab)),
                    TOL[dtn], gemm_bound(dout, w, rev, c, keys=keys)),
                "dg_wgrad_search": (
                    lambda: D.dg_wgrad_search(x, dout, keys, geom),
                    lambda: D.dg_wgrad_search_plain(x, dout, keys, geom),
                    lambda: D.dg_wgrad(x, dout, D.build_dg_pos(
                        keys, reverse=True, **tab)),
                    WGRAD_TOL[dtn], wgrad_bound(x, dout, rev, keys=keys)),
            }
            for kern, (fn, plain, table, tol, bnd) in cases.items():
                r = checked(kern, fn, plain, table, tol, f"{what} {dtn}")
                if not (timed and dt == bf16):
                    print(f"  {what:22s} {kern:16s} {dtn:9s} {c:4d} {k:4d} "
                          f"{r:12.3e}  bit-equal to B1 + table")
                    continue
                t = (cuda_ms(torch, fn, 10), cuda_ms(torch, plain, 2), bnd,
                     cuda_ms(torch, table, 10))
                times[kern] = t
                print(f"  {what:22s} {kern:16s} {dtn:9s} {c:4d} {k:4d} "
                      f"{r:12.3e}  bit-equal to B1 + table  {t[0]:9.4f}  "
                      f"{t[3]:9.4f}  {t[1]:8.4f}  {t[2][0]:.4f}")
        return times

    print("search mode: layer kernel dtype C K max|d|/max|ref| (vs plain) "
          "kernel_ms table_path_ms plain_ms bound_ms")
    for s, g in enumerate(geo):
        geom = D.SearchGeom.of(KSIZE, DIL, g.spatial_shape, 1)
        for layer in (2 * s, 2 * s + 1):
            c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
            times = layer_case(g, geom, c, k,
                               f"stage {s} conv{layer} N {g.indices.shape[0]}",
                               True)
            for kern, (km, pm, bnd, tm) in times.items():
                if kern == "dg_dgrad_search" and layer == 0:
                    continue  # the input features need no gradient
                tally[kern].add(km, pm, bnd)
                table_ms[kern] += tm
    layer_case(geo[2], D.SearchGeom.of((5, 5, 5), DIL, geo[2].spatial_shape,
                                       1), 96, 96, "stage 2 kernel 5^3", False)
    print("per bf16 forward / step's backward, search mode: " + ", ".join(
        f"{k} {tally[k]}, B1 + table {table_ms[k]:.4f} ms"
        for k in names[:3]))

    # ---- S4, and bench.py's run_int8 section: one subm layer at C = K on
    # the 125k-voxel scan, bf16 and int8 (ReLU, int8 out), in search mode
    # and on a cached table
    g0 = geo[0]
    keys0, _ = C.linearize(g0.indices, g0.spatial_shape, 1)
    geom0 = D.SearchGeom.of(KSIZE, DIL, g0.spatial_shape, 1)
    pos0 = D.build_dg_pos(keys0, **geom0._asdict())
    n0 = keys0.shape[0]
    run_int8 = {}

    def randq(shape, lim):
        return torch.randint(-lim, lim, shape, device=dev, generator=gen,
                             dtype=torch.int32).to(torch.int8)

    print("int8 search mode (S4) and run_int8: C=K, search / table ms, "
          "bf16 and int8")
    for c in SEARCH_Q_WIDTHS:
        # the weight as the int8 modules hold it: a [kv, C, K] view of the
        # [kv, K, C] tensor B7 reads
        x8 = randq((n0, c), 100)
        w8 = randq((27, c, c), 80).transpose(1, 2).contiguous().transpose(
            1, 2)
        scale = torch.rand(c, device=dev, generator=gen) * 0.009 + 0.001
        res = randq((n0, c), 90)
        for add in (None, res):
            kw = dict(act="relu", add=add, add_scale=0.37)
            checked("dg_fwd_q_search",
                    lambda: D.dg_fwd_q_search(x8, w8, keys0, scale, None,
                                              geom0, **kw),
                    lambda: D.dg_fwd_q_search_plain(x8, w8, keys0, scale,
                                                    None, geom0, **kw),
                    lambda: D.dg_fwd_q(x8, w8, D.build_dg_pos(
                        keys0, **geom0._asdict()), scale, None, **kw),
                    0.0, f"C=K={c} {'residual' if add is not None else ''}")
        xb = (torch.randn((n0, c), device=dev, generator=gen) * 0.3).to(bf16)
        wb = (torch.randn((27, c, c), device=dev, generator=gen)
              * 0.05).to(bf16)

        def q_search():
            return D.dg_fwd_q_search(x8, w8, keys0, scale, None, geom0,
                                     act="relu")

        ms = {"bf16_search": cuda_ms(
                  torch, lambda: D.dg_fwd_search(xb, wb, keys0, geom0), 10),
              "bf16_table": cuda_ms(torch, lambda: D.dg_fwd(xb, wb, pos0),
                                    10),
              "int8_search": cuda_ms(torch, q_search, 10),
              "int8_table": cuda_ms(torch, lambda: D.dg_fwd_q(
                  x8, w8, pos0, scale, None, act="relu"), 10)}
        run_int8[f"C=K={c}"] = ms
        if c == SEARCH_Q_WIDTHS[0]:  # the int8 module route's layer below
            tally["dg_fwd_q_search"].add(
                ms["int8_search"], cuda_ms(torch, lambda: (
                    D.dg_fwd_q_search_plain(x8, w8, keys0, scale, None,
                                            geom0, act="relu")), 2),
                q_bound(x8, w8, pos0, c, False, keys=keys0))
            table_ms["dg_fwd_q_search"] += cuda_ms(torch, lambda: D.dg_fwd_q(
                x8, w8, D.build_dg_pos(keys0, **geom0._asdict()), scale,
                None, act="relu"), 10)
        print(f"  C=K={c}: S4 bit-equal to plain and to B1 + dg_fwd_q, with "
              f"and without the residual; run_int8 ms " + ", ".join(
                  f"{k} {v:.4f}" for k, v in ms.items()))

    # ---- serve BenchNet with no indice_key: three requests on phase 4's
    # inputs, each bit-equal to the keyed net's at every stage
    def no_key(net):
        for conv in net.convs:
            conv.indice_key = None
        return net

    def bench_net(dtype, keyed, train=False):
        net = B.BenchNet(SHAPE, dtype=dtype, pool_bounds=bounds, device=dev,
                         seed=0)
        net = net if keyed else no_key(net)
        return net if train else net.eval()

    keyed, free = bench_net(bf16, True), bench_net(bf16, False)
    with torch.inference_mode():
        free(served[0][1])  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        for seed, x, stages, keyed_ms in served:
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            got = free.forward_stages(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            delta = {k: D.launch_counts[k] - before[k] for k in before}
            check(delta == expected(D, **SEARCH_SERVE), f"no-key request "
                  f"{seed}: launches {delta}")
            check(not got[-1].indice_dict, f"no-key request {seed}: cached "
                  f"{sorted(got[-1].indice_dict)}")
            for i, (a, b) in enumerate(zip(got, stages)):
                check(torch.equal(a.indices, b.indices)
                      and torch.equal(a.features, b.features),
                      f"no-key request {seed}: stage {i} differs from the "
                      "keyed net's")
            print(f"no-key request seed={seed} ms={ms:.3f} (keyed, phase 4: "
                  f"{keyed_ms:.3f}); bit-equal to the keyed net at every "
                  "stage")
        serve_launches = dict(D.launch_counts)
        x0 = served[0][1]
        busy = [(name, device_busy(torch, lambda: m(x0), 3))
                for name, m in (("keyed", keyed), ("no-key", free),
                                ("no-key", free), ("keyed", keyed))]
        peaks = [(name, peak_mib(torch, lambda: m(x0)))
                 for name, m in (("keyed", keyed), ("no-key", free))]
    print("no-key vs keyed BenchNet, 3 bf16 requests of seed 0 a window, in "
          "turns: " + turns_text(busy)
          + "; peak allocated in a request: " + ", ".join(
              f"{name} {p:.1f} MiB above {b:.1f}" for name, (p, b) in peaks))

    # ---- train three bf16 steps
    net = bench_net(bf16, False, train=True)
    # phase 4's inputs are inference tensors, which autograd cannot save
    xs = [B.make_bench_input(*scans[s], dtype=bf16, device=dev)
          for s in REQUEST_SEEDS]
    B.train_step(net, xs[0], 0.0)  # warm-up, no update
    torch.cuda.synchronize()
    lr = 1e-2 * max(p.abs().max().item() for p in net.parameters()) / max(
        p.grad.abs().max().item() for p in net.parameters())
    D.reset_launch_counts()
    for seed, x in zip(REQUEST_SEEDS, xs):
        before = dict(D.launch_counts)
        t0 = time.perf_counter()
        loss = B.train_step(net, x, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: D.launch_counts[k] - before[k] for k in before}
        check(delta == expected(D, **SEARCH_STEP), f"no-key train step "
              f"{seed}: launches {delta}")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0, f"no-key step {seed}: loss "
              f"{loss}")
        for name, p in net.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.any()), f"no-key step {seed}: {name} grad "
                  "missing, 0 or not finite")
        print(f"no-key train step seed={seed} ms={ms:.3f} loss={loss:.6e}")
    train_launches = dict(D.launch_counts)
    keyed_t = bench_net(bf16, True, train=True)
    steps = (("keyed", keyed_t), ("no-key", net))
    step_ms = {name: [] for name, _ in steps}
    for _ in range(3):
        for name, m in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            B.train_step(m, xs[0], 0.0)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3)
    step_busy = [(name, device_busy(torch, lambda: B.train_step(
        m, xs[0], 0.0), 3)) for name, m in steps + steps[::-1]]
    step_peaks = [(name, peak_mib(torch, lambda: B.train_step(m, xs[0], 0.0)))
                  for name, m in steps]
    print("no-key vs keyed BenchNet step (bf16, seed 0, lr 0), in turns: "
          "host ms " + "; ".join(f"{k} {[round(v, 3) for v in ms]}"
                                 for k, ms in step_ms.items())
          + "; windows of 3: " + turns_text(step_busy)
          + "; peak allocated in a step: " + ", ".join(
              f"{name} {p:.1f} MiB above {b:.1f}"
              for name, (p, b) in step_peaks))

    # the f32 no-key net's grads (S1-S3) against the plain backward on the
    # kernel forward (B1 + B2, bit-equal to S1), as phase 5
    x32 = B.make_bench_input(*scans[0], device=dev)
    *losses, _, worst = step_vs_plain(
        torch, D, [bench_net(torch.float32, keyed, train=True)
                   for keyed in (False, True)],
        lambda n: zero_lr_step(B, n, x32), "no-key")
    print(f"no-key train f32 seed=0: loss kernels {losses[0]:.9e}, plain "
          f"backward {losses[1]:.9e}; worst weight grad max|d|/max|ref| "
          f"{worst[0]:.3e} ({worst[1]}, tolerance {GRAD_F32_TOL})")

    # ---- the int8 module route: a no-key int8 subm conv at C = K = 64 on
    # the stage-0 shape, bit-equal to the same layer on a key
    conv = SubMConv3d(64, 64, 3, device=dev,
                      generator=torch.Generator().manual_seed(11))
    obs = PerChannelMinMaxObserver()
    obs.observe(conv.weight)
    q_free = QuantizedSparseConv(conv, obs.scale, 0.02, 0.05,
                                 act_type="relu")
    conv.indice_key = "q"
    q_keyed = QuantizedSparseConv(conv, obs.scale, 0.02, 0.05,
                                  act_type="relu")
    x8 = SparseConvTensor(randq((n0, 64), 100) * g0.valid_mask[:, None],
                          g0.indices, g0.spatial_shape, 1, keys_sorted=True)
    with torch.inference_mode():
        torch.cuda.synchronize()
        D.reset_launch_counts()
        y_free = q_free(x8)
        torch.cuda.synchronize()
        q_launches = dict(D.launch_counts)
        check(q_launches == expected(D, dg_fwd_q_search=1),
              f"int8 no-key conv launches {q_launches}")
        y_keyed = q_keyed(x8)
        check(torch.equal(y_free.features, y_keyed.features)
              and bool(y_free.features.any()) and not y_free.indice_dict,
              "int8 no-key conv differs from the keyed one, is 0 or cached "
              "a table")
    print(f"int8 no-key SubMConv3d(64, 64) on stage 0: bit-equal to the "
          f"keyed layer; launches "
          f"{ {k: v for k, v in q_launches.items() if v} }")
    return (tally, table_ms, serve_launches, train_launches, q_launches,
            run_int8)


def plain_chain(torch, net, x):
    """The USAGE.md chain's forward (``chain_net``) with the plain versions
    of the kernels in place of the kernels (every table by its plain
    version, every product by ``dg_fwd_plain``), on whatever device ``x`` is
    on.  Returns ``(output features, output indices)``."""
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops.rulebook import (build_conv_outputs,
                                               build_deconv_outputs)

    def conv(layer, feats, pos, valid):
        out = D.dg_fwd_plain(feats, D.weight_krsc_to_kv(layer.weight),
                             pos) + layer.bias
        return torch.where(valid[:, None], out, torch.zeros_like(out))

    subm, down, inv, up = net
    shape = tuple(x.spatial_shape)
    keys, _ = C.linearize(x.indices, shape, 1)
    geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=shape, batch_size=1)
    h = conv(subm, x.features, D.dg_pos_plain(keys, **geom), x.valid_mask)
    geom = dict(ksize=down.kernel_size, stride=down.stride,
                padding=down.padding, dilation=down.dilation)
    d_inds, d_keys, _, _ = build_conv_outputs(
        x.indices, spatial_shape=shape, batch_size=1,
        out_bound=down.out_bound, **geom)
    geom.update(in_shape=shape, batch_size=1, out_shape=tuple(
        C.get_conv_output_size(shape, down.kernel_size, down.stride,
                               down.padding, down.dilation)))
    h = conv(down, h, D.dg_pos_affine_plain(keys, d_keys, **geom),
             d_inds[:, 0] >= 0)
    h = conv(inv, h, D.dg_pos_divide_plain(keys, d_keys, **geom),
             x.valid_mask)
    t_inds, t_keys, t_geom = deconv_sites(x, up)
    out = conv(up, h, D.dg_pos_divide_plain(t_keys, keys, **t_geom),
               t_inds[:, 0] >= 0)
    return out, t_inds


def deconv_sites(x, layer):
    """A transposed conv's output sites on ``x`` (``build_deconv_outputs``
    with ``layer``'s bound) and its geometry on the swapped spaces, as
    ``dg_regular_conv`` takes it: ``(out indices, out keys, geom)``."""
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops.rulebook import build_deconv_outputs

    shape = tuple(x.spatial_shape)
    conv = dict(ksize=layer.kernel_size, stride=layer.stride,
                padding=layer.padding, dilation=layer.dilation)
    t_inds, t_keys, _, _ = build_deconv_outputs(
        x.indices, spatial_shape=shape, batch_size=1,
        out_padding=layer.output_padding,
        out_bound=layer._resolve_out_bound(x.indices.shape[0]), **conv)
    out_shape = tuple(C.get_deconv_output_size(
        shape, layer.kernel_size, layer.stride, layer.padding,
        layer.dilation, layer.output_padding))
    return t_inds, t_keys, dict(conv, in_shape=out_shape, out_shape=shape,
                                batch_size=1)


def chain_net(torch, dev, dtype=None):
    """The decoder chain of ``docs/USAGE.md:34-38`` at its documented
    widths, weights from a seed."""
    from spconv_tpu_torch import (SparseConv3d, SparseConvTranspose3d,
                                  SparseInverseConv3d, SparseSequential,
                                  SubMConv3d)

    gen = torch.Generator().manual_seed(8)
    kw = dict(device=dev, generator=gen)
    net = SparseSequential(
        SubMConv3d(32, 64, 3, indice_key="c0", **kw),
        SparseConv3d(64, 128, 3, stride=2, padding=1, indice_key="down1",
                     **kw),
        SparseInverseConv3d(128, 64, 3, indice_key="down1", **kw),
        SparseConvTranspose3d(64, 32, 2, stride=2, **kw))
    return net if dtype is None else net.to(dtype)


def transposed_phase(torch, dev, cp_in, note):
    """Phase 11: the transposed conv (B1 divide + B2 on swapped spaces)
    through the USAGE.md decoder chain on the CenterPoint scans ``cp_in``
    with seeded 32-channel features: every transposed-conv kernel against
    its plain version at the chain's shapes, timed; three bf16 requests and
    three training steps with launch counts, the f32 chain against a plain
    run and its grads against the plain backward, device busy and peak
    memory; and a k3 s2 p1 op1 transposed conv against plain.  Returns
    ``(tallies, serve launches, train launches, k3 launches)``."""
    import copy

    import numpy as np
    from spconv_tpu_torch import SparseConvTranspose3d
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.calibrate import (calibrate_out_bounds,
                                            export_out_bounds)
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D

    bf16 = torch.bfloat16
    names = ("dg_pos_divide_transposed", "dg_fwd_transposed",
             "dg_pos_affine_transposed", "dg_dgrad_transposed",
             "dg_wgrad_transposed")
    tally = {k: Tally() for k in names}

    def chain_input(seed, dtype=torch.float32):
        x = cp_in[seed]
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        f = torch.randn((x.indices.shape[0], 32), device=dev, generator=g)
        return x.replace_feature((f * x.valid_mask[:, None]).to(dtype))

    x32 = {s: chain_input(s) for s in REQUEST_SEEDS}
    x16 = {s: chain_input(s, bf16) for s in REQUEST_SEEDS}
    t0 = time.perf_counter()
    raw = chain_net(torch, dev).eval()
    default = raw[3]._resolve_out_bound(x32[0].indices.shape[0])
    net32 = calibrate_out_bounds(raw, None, [x32[0]], margin=1.15, mult=128)
    net16 = copy.deepcopy(net32).to(bf16)
    up = net32[3]
    print(f"chain: docs/USAGE.md SubMConv3d(32, 64) -> SparseConv3d(64, 128, "
          f"s2) -> SparseInverseConv3d(128, 64) -> SparseConvTranspose3d(64, "
          f"32, 2, s2); bounds (f32 calibration on seed 0, x1.15, to 128) "
          f"{[b for b in export_out_bounds(net32) if b is not None]} "
          f"(the transposed conv's default: {default}) in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- each transposed-conv kernel against its plain version at the
    # chain's shapes: the transposed conv's input is the inverse conv's
    # output, on the scan's sites
    x = x32[0]
    t_inds, t_keys, geom = deconv_sites(x, up)
    in_keys, _ = C.linearize(x.indices, x.spatial_shape, 1)
    n_exp, n_in = t_keys.shape[0], in_keys.shape[0]
    act_exp, act_in = int((t_inds[:, 0] >= 0).sum()), int(x.num_voxels)
    print(f"transposed conv: {act_in} sites ({n_in} rows) on "
          f"{tuple(x.spatial_shape)} -> {act_exp} sites ({n_exp} rows) on "
          f"{geom['in_shape']}, k2 s2, {act_exp / act_in:.3f} a site")
    print("transposed kernels: kernel dtype max|d|/max|ref| kernel_ms "
          "plain_ms bound_ms")
    tables = {}
    for kern, build, plain, rows, table_rows in (
            ("dg_pos_divide_transposed", D.build_dg_pos_divide,
             D.dg_pos_divide_plain, n_exp, n_in),
            ("dg_pos_affine_transposed", D.build_dg_pos_affine,
             D.dg_pos_affine_plain, n_in, n_exp)):
        def fn(build=build):
            return build(t_keys, in_keys, path="transposed", **geom)

        def ref(plain=plain):
            return plain(t_keys, in_keys, **geom)

        got = fn()
        check(torch.equal(got, ref()), f"{kern} differs from plain")
        note(kern, 0.0, 0.0)
        km, pm = cuda_ms(torch, fn, 20), cuda_ms(torch, ref, 3)
        bnd = table_bound(rows, table_rows, got.shape[0])
        tally[kern].add(km, pm, bnd)
        tables[kern] = got
        print(f"  {kern:26s} int32 exact  {km:9.4f}  {pm:8.4f}  "
              f"{bnd[0]:.4f} (matches {int((got >= 0).sum())} of "
              f"{got.numel()})")
    n_edge = edge_tables(torch, dev, "transposed")
    print(f"  B1 transposed tables at the edge inputs: {n_edge} bit-equal "
          "to plain")
    div, aff = (tables["dg_pos_divide_transposed"],
                tables["dg_pos_affine_transposed"])
    check(int((div >= 0).sum()) == int((aff >= 0).sum()) == act_exp,
          "transposed tables: not one match per output site at k2 s2")
    valid_in, valid_out = x.valid_mask, t_inds[:, 0] >= 0
    c, k = up.in_channels, up.out_channels
    g = torch.Generator(device=dev).manual_seed(21)
    xf = torch.randn((n_in, c), device=dev, generator=g) * valid_in[:, None]
    df = torch.randn((n_exp, k), device=dev, generator=g) * valid_out[:, None]
    wf = torch.randn((8, c, k), device=dev, generator=g) / float(
        np.sqrt(8 * c))
    for dt in (torch.float32, bf16):
        dtn = str(dt)[6:]
        xi, dout, w = xf.to(dt), df.to(dt), wf.to(dt)
        for kern, fn, plain, valid, tol, bnd in (
                ("dg_fwd_transposed",
                 lambda: D.dg_fwd(xi, w, div, "transposed"),
                 lambda: D.dg_fwd_plain(xi, w, div), valid_out, TOL,
                 gemm_bound(xi, w, div, k)),
                ("dg_dgrad_transposed",
                 lambda: D.dg_dgrad(dout, w, aff, "transposed"),
                 lambda: D.dg_dgrad_plain(dout, w, aff), valid_in, TOL,
                 gemm_bound(dout, w, aff, c)),
                ("dg_wgrad_transposed",
                 lambda: D.dg_wgrad(xi, dout, aff, "transposed"),
                 lambda: D.dg_wgrad_plain(xi, dout, aff), None, WGRAD_TOL,
                 wgrad_bound(xi, dout, aff))):
            got = fn()
            diff, r = rel_err(torch, got, plain())
            check(np.isfinite(r) and r <= tol[dtn],
                  f"{kern} {dtn}: {r:.3e} > {tol[dtn]}")
            if valid is None:
                check(torch.equal(got, fn()), f"{kern}: two runs differ")
            else:
                check(not got[~valid].any(),
                      f"{kern}: non-zero rows without a site")
            note(kern, diff, r)
            km, pm = cuda_ms(torch, fn, 10), cuda_ms(torch, plain, 2)
            if dt == bf16:
                tally[kern].add(km, pm, bnd)
            print(f"  {kern:26s} {dtn:9s} {r:10.3e}  {km:9.4f}  {pm:8.4f}  "
                  f"{bnd[0]:.4f}")
    print("per bf16 chain step, transposed conv: " + ", ".join(
        f"{kk} {v}" for kk, v in tally.items()))

    # ---- serve: three requests after a warm-up
    serve_one = dict(dg_pos=1, dg_pos_affine=1, dg_pos_divide=1, dg_fwd=1,
                     dg_fwd_strided=1, dg_fwd_inverse=1,
                     dg_pos_divide_transposed=1, dg_fwd_transposed=1)
    with torch.inference_mode():
        net16(x16[0])
        torch.cuda.synchronize()
        D.reset_launch_counts()
        serve_ms = []
        for seed in REQUEST_SEEDS:
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            out = net16(x16[seed])
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t0) * 1e3)
            got = {kk: D.launch_counts[kk] - v for kk, v in before.items()}
            check(got == expected(D, **serve_one),
                  f"chain request {seed}: launches {got}")
            check(tuple(out.spatial_shape) == geom["in_shape"]
                  and out.features.dtype == bf16
                  and tuple(out.features.shape) == (n_exp, k),
                  f"chain request {seed}: output {out.features.shape} on "
                  f"{out.spatial_shape}")
            check(bool(torch.isfinite(out.features).all())
                  and bool(out.features.any()),
                  f"chain request {seed}: output not finite or all 0")
        serve_launches = dict(D.launch_counts)
        for seed, ms in zip(REQUEST_SEEDS, serve_ms):
            y32 = net32(x32[seed])
            ref, ref_inds = plain_chain(torch, net32, x32[seed])
            check(torch.equal(y32.indices, ref_inds),
                  f"chain request {seed}: output sites differ from plain")
            _, rel32 = rel_err(torch, y32.features, ref)
            check(rel32 <= NET_F32_TOL, f"chain request {seed}: f32 "
                  f"{rel32:.3e} > {NET_F32_TOL} of max|ref|")
            y16 = net16(x16[seed])
            _, bf_rel = rel_err(torch, y16.features,
                                plain_chain(torch, net16, x16[seed])[0])
            print(f"chain request seed={seed} input=synthetic ms={ms:.3f} "
                  f"sites {int(x32[seed].num_voxels)} -> "
                  f"{int(y16.num_voxels)} (total "
                  f"{int(y16.num_out_total)}) f32_rel_err={rel32:.3e} "
                  f"bf16_rel_vs_plain={bf_rel:.3e}")
        wall, busy, ops = device_busy(torch, lambda: net16(x16[0]), 3)
        peak = peak_mib(torch, lambda: net16(x16[0]))
    print(f"chain serve: bf16, ms per request "
          f"{[round(m, 3) for m in serve_ms]}, launches "
          f"{ {kk: v for kk, v in serve_launches.items() if v} }; "
          + busy_text(wall, busy, 3, "a request", ops)
          + f"; peak allocated {peak[0]:.1f} MiB above the {peak[1]:.1f} "
          "MiB held before the request")

    # ---- train: one bf16 step per seed after a warm-up step
    step_one = dict(serve_one, dg_pos_rev=1, dg_pos_affine_transposed=1,
                    dg_dgrad_strided=1, dg_dgrad_inverse=1,
                    dg_dgrad_transposed=1, dg_wgrad=1, dg_wgrad_strided=1,
                    dg_wgrad_inverse=1, dg_wgrad_transposed=1)
    net = copy.deepcopy(net32).to(bf16)
    B.train_step(net, x16[0], 0.0)
    torch.cuda.synchronize()
    lr = 1e-2 * max(p.abs().max().item() for p in net.parameters()) / max(
        p.grad.abs().max().item() for p in net.parameters())
    D.reset_launch_counts()
    for seed in REQUEST_SEEDS:
        w_before = [p.detach().clone() for p in net.parameters()]
        before = dict(D.launch_counts)
        t0 = time.perf_counter()
        loss = B.train_step(net, x16[seed], lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {kk: D.launch_counts[kk] - v for kk, v in before.items()}
        check(got == expected(D, **step_one),
              f"chain train step {seed}: launches {got}")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0,
              f"chain train step {seed}: loss {loss}")
        for (name, p), w0 in zip(net.named_parameters(), w_before):
            check(p.grad is not None and p.grad.dtype == bf16
                  and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.any()),
                  f"chain train step {seed}: {name} grad missing, not "
                  "finite or 0")
            check(torch.equal(p.detach(), w0.add(p.grad, alpha=-lr)),
                  f"chain train step {seed}: {name} was not updated")
        print(f"chain train step seed={seed} input=synthetic ms={ms:.3f} "
              f"loss={loss:.6e} lr={lr:.4e}")
    train_launches = dict(D.launch_counts)
    wall, busy, _ = device_busy(
        torch, lambda: B.train_step(net, x16[0], 0.0), 3)
    peak = peak_mib(torch, lambda: B.train_step(net, x16[0], 0.0))
    print(f"chain train: bf16, launches over 3 steps "
          f"{ {kk: v for kk, v in train_launches.items() if v} }; "
          + busy_text(wall, busy, 3, "a step")
          + f"; peak allocated {peak[0]:.1f} MiB above the {peak[1]:.1f} "
          "MiB held before the step")

    # the f32 grads through the kernels against the plain backward on the
    # kernels' forward
    loss_k, loss_p, _, worst = step_vs_plain(
        torch, D, [copy.deepcopy(net32) for _ in range(2)],
        lambda n: zero_lr_step(B, n, x32[0]), "chain")
    print(f"chain train f32 seed=0: loss kernels {loss_k:.9e}, plain "
          f"backward {loss_p:.9e}; worst grad max|d|/max|ref| {worst[0]:.3e}"
          f" ({worst[1]}, tolerance {GRAD_F32_TOL} per tensor)")

    # ---- the general case: k3 s2 p1 op1 on the same input, whose offsets
    # match 1, 2, 4 or 8 times a row by the row's parity
    k3 = calibrate_out_bounds(
        SparseConvTranspose3d(32, 32, 3, stride=2, padding=1,
                              output_padding=1, device=dev,
                              generator=torch.Generator().manual_seed(9)),
        None, [x32[0]], margin=1.15, mult=128)
    with torch.inference_mode():
        D.reset_launch_counts()
        y = k3(x32[0])
        torch.cuda.synchronize()
        k3_launches = dict(D.launch_counts)
        check(k3_launches == expected(D, dg_pos_divide_transposed=1,
                                      dg_fwd_transposed=1),
              f"k3 transposed launches {k3_launches}")
        k_inds, k_keys, k_geom = deconv_sites(x32[0], k3)
        kdiv = D.dg_pos_divide_plain(k_keys, in_keys, **k_geom)
        check(torch.equal(y.indices, k_inds)
              and torch.equal(D.build_dg_pos_divide(
                  k_keys, in_keys, path="transposed", **k_geom), kdiv),
              "k3 transposed: sites or divide table differ from plain")
        ref = D.dg_fwd_plain(x32[0].features, D.weight_krsc_to_kv(k3.weight),
                             kdiv) + k3.bias
        ref = torch.where((k_inds[:, 0] >= 0)[:, None], ref,
                          torch.zeros_like(ref))
        _, r = rel_err(torch, y.features, ref)
        check(r <= TOL["float32"], f"k3 transposed: {r:.3e} > "
              f"{TOL['float32']} of max|ref|")
        hist = torch.bincount((kdiv >= 0).sum(0)[k_inds[:, 0] >= 0],
                              minlength=9).tolist()
        xk = x32[0].features.to(bf16)
        wk = D.weight_krsc_to_kv(k3.weight).to(bf16)
        km_div = cuda_ms(torch, lambda: D.build_dg_pos_divide(
            k_keys, in_keys, path="transposed", **k_geom), 20)
        km_fwd = cuda_ms(torch, lambda: D.dg_fwd(xk, wk, kdiv, "transposed"),
                         10)
    print(f"k3 s2 p1 op1 transposed conv (32 -> 32, f32, bound "
          f"{k3.out_bound}): {int(y.num_voxels)} sites on "
          f"{tuple(y.spatial_shape)} (total {int(y.num_out_total)}), "
          f"max|d|/max|ref| vs plain {r:.3e}; matched offsets per output "
          f"site {dict((i, n) for i, n in enumerate(hist) if n)}; bf16 "
          f"divide table {km_div:.4f} ms (bound "
          f"{table_bound(k_keys.shape[0], n_in, 27)[0]:.4f}), B2 "
          f"{km_fwd:.4f} ms (bound "
          f"{gemm_bound(xk, wk, kdiv, 32)[0]:.4f})")
    return tally, serve_launches, train_launches, k3_launches


def probe_phase(torch, dev, rank_parent_lib):
    """Phase 12: every probe script's ``main()`` on the card, each case OK,
    with the launches of each; then each probe kernel against its plain
    version at its probe's shape (exact, the bf16 GEMM within 1e-5 of
    max|ref|), timed beside the plain version, the PyTorch call that
    computes the same function (where one does) and its bound; the rank
    also on every plan of ``rank_plan``'s sweep and on the parent's kernel
    (``rank_parent_lib``, built in phase 2), in turns.  Returns ``{row:
    dict(launches, errs, tally, library_ms, ...)}``."""
    import numpy as np
    from spconv_tpu_torch._build import load_library
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops import probes as P
    from spconv_tpu_torch.tools import (probe_cast, probe_dg,
                                        probe_dma_align, probe_int8,
                                        probe_sk)
    from spconv_tpu_torch.tools import join_gather_tiles as JG

    launches = {}
    for mod in (probe_int8, probe_dma_align, probe_cast, probe_dg, probe_sk):
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"-- {name}.main()")
        P.reset_launch_counts()
        D.reset_launch_counts()
        results = mod.main()
        torch.cuda.synchronize()
        check(results and all(results.values()),
              f"{name}: cases not OK: "
              f"{[c for c, ok in results.items() if not ok]}")
        launches[name] = {k: v for k, v in {**P.launch_counts,
                                             **D.launch_counts}.items() if v}
        print(f"   {len(results)} cases OK; launches {launches[name]}")

    rows = {}

    def case(row, fn, plain, library, bnd, source, tol=0.0, **extra):
        """``fn()`` against ``plain()`` (exactly, or within ``tol`` of
        max|ref|), then the kernel, plain and library ms (CUDA events)."""
        got, ref = fn(), plain()
        check(got.dtype == ref.dtype and got.shape == ref.shape,
              f"{row}: {got.dtype} {tuple(got.shape)} vs plain {ref.dtype} "
              f"{tuple(ref.shape)}")
        diff, r = rel_err(torch, got, ref)
        check(torch.equal(got, ref) if tol == 0.0 else r <= tol,
              f"{row}: differs from plain ({diff:.3e}, {r:.3e} of max|ref|)")
        t = Tally()
        t.add(cuda_ms(torch, fn, 100), cuda_ms(torch, plain, 20), bnd)
        lib = cuda_ms(torch, library, 100) if library else None
        rows[row] = dict(errs=(diff, r), tally=t, library_ms=lib,
                         launches=launches[source[0]].get(source[1], 0),
                         extra=extra)
        print(f"  {row:22s} max|d| {diff:.3e}  {t}, torch call "
              + (f"{lib:.4f} ms" if lib is not None else "none")
              + "".join(f", {k} {v:.4f} ms" for k, v in extra.items()
                        if isinstance(v, float)))

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    print("probe kernels at their probes' shapes: max|d| vs plain, ms "
          "(CUDA events, 100 launches) beside plain, bound and torch call "
          "(the copies' slice takes its start from the host); each is "
          "launch-bound")
    i32 = torch.int32
    sms = D.sm_count(dev.index or 0)

    def show_copy_plan(row, x, rows):
        """The plan ``copy_rows`` launches on for ``x`` (``ops/probes.py::
        copy_launch_plan``)."""
        p = P.copy_launch_plan(x, rows)
        check(p.vec and p.tx * p.ty == P.COPY_THREADS, f"{row}: plan {p}")
        print(f"  {row:22s} plan: {p.grid} blocks of {p.tx} x {p.ty} "
              f"threads ({p.ty} rows a block), one 16-byte output vector "
              "a thread")
        return p._asdict()

    x8 = on((np.arange(4096 * 128).reshape(4096, 128) % 117 - 58)
            .astype(np.int8))
    s96 = torch.tensor([96], dtype=i32, device=dev)
    case("probe_copy_int8", lambda: P.copy_rows(x8, s96, 64),
         lambda: P.copy_rows_plain(x8, s96, 64),
         lambda: x8[96:160].to(torch.int32), bound(64 * 128 * 5 + 4),
         ("probe_int8", "probe_copy"),
         plan=show_copy_plan("probe_copy_int8", x8, 64))
    xb = on(np.arange(4096 * 128).reshape(4096, 128) % 977).to(torch.bfloat16)
    s384 = torch.tensor([384], dtype=i32, device=dev)
    case("probe_copy_dma_align", lambda: P.copy_rows(xb, s384, 64),
         lambda: P.copy_rows_plain(xb, s384, 64),
         lambda: xb[384:448].to(torch.bfloat16, copy=True),
         bound(2 * 64 * 128 * 2 + 4), ("probe_dma_align", "probe_copy"),
         plan=show_copy_plan("probe_copy_dma_align", xb, 64))
    tab = torch.rand((256, 128), device=dev)
    s5 = torch.tensor([5], dtype=i32, device=dev)
    case("probe_copy_chunk",
         lambda: P.copy_rows(tab, s5, 16, scale=16, off=16),
         lambda: P.copy_rows_plain(tab, s5, 16, scale=16, off=16),
         lambda: tab[96:112].to(torch.float32, copy=True),
         bound(2 * 16 * 128 * 4 + 4), ("probe_dg", "probe_copy"),
         plan=show_copy_plan("probe_copy_chunk", tab, 16))
    a = torch.rand((128, 128), device=dev)
    tplan = P.transpose_launch_plan(a)
    check(tplan.vec and tplan.grid >= sms // 3,
          f"probe_transpose: plan {tplan} on {sms} SMs")
    print(f"  {'probe_transpose':22s} plan: {tplan.grid} blocks of "
          f"{tplan.p} x {tplan.q} threads, a 4 x 4 block a thread in "
          "registers")
    case("probe_transpose", lambda: P.transpose(a),
         lambda: P.transpose_plain(a), lambda: a.t().contiguous(),
         bound(2 * 128 * 128 * 4), ("probe_dg", "probe_transpose"),
         plan=tplan._asdict())

    def show_gather_plan(row, rows, broadcast=False):
        """The plan ``lane_gather`` / ``row_broadcast`` launches on
        (``ops/probes.py::gather_plan``)."""
        p = P.gather_plan(rows, 128, sms, broadcast=broadcast)
        check(p.grid * p.rb * p.rw >= rows, f"{row}: plan {p}")
        how = ("nothing staged" if broadcast else
               "the row staged in the warp's shared memory")
        print(f"  {row:22s} plan: {p.grid} blocks of {p.rb} warp(s), "
              f"{p.rw} output row(s) a warp, 16 bytes a lane, {how}")
        return p._asdict()

    xg = torch.rand((128, 128), device=dev)
    idx = torch.randint(0, 128, (128, 128), device=dev, dtype=i32)
    idx64 = idx.long()
    case("probe_lane_gather", lambda: P.lane_gather(xg, idx),
         lambda: P.lane_gather_plain(xg, idx),
         lambda: torch.gather(xg, 1, idx64), bound(3 * 128 * 128 * 4),
         ("probe_dg", "probe_lane_gather"),
         plan=show_gather_plan("probe_lane_gather", 128))
    xs = torch.rand((8, 128), device=dev)

    def bcast_torch():
        """One PyTorch call writing the broadcast's 8 rows (the row a view,
        expanded): bit-equal to the plain version (f32 round-to-nearest
        products)."""
        return xs[3].expand(8, -1) * 4.0

    check(torch.equal(bcast_torch(), P.row_broadcast_plain(xs, 3, 4.0, 8)),
          "probe_row_broadcast: the torch call differs from plain")
    case("probe_row_broadcast", lambda: P.row_broadcast(xs, 3, 4.0, 8),
         lambda: P.row_broadcast_plain(xs, 3, 4.0, 8), bcast_torch,
         bound(9 * 128 * 4), ("probe_dg", "probe_row_broadcast"),
         plan=show_gather_plan("probe_row_broadcast", 8, broadcast=True))
    for row, (t_n, w_n, c, tdt, src) in {
            "probe_join_int8": (128, 256, 128, torch.int8, "probe_int8"),
            "probe_join_f32": (256, 1024, 64, torch.float32, "probe_cast"),
    }.items():
        probes = torch.arange(t_n, device=dev, dtype=i32) * 3
        keys = torch.arange(w_n, device=dev, dtype=i32) // 2 * 2
        table = (torch.randint(-127, 127, (w_n, c), device=dev).to(tdt)
                 if tdt == torch.int8 else torch.randn((w_n, c), device=dev))
        # no one PyTorch call joins; searchsorted is its search half
        half = cuda_ms(torch, lambda: torch.searchsorted(keys, probes), 100)
        # the output reads only the table rows some probe matches
        matched = int(torch.isin(keys, probes).sum())
        jp = P.join_launch_plan(probes, keys, table)
        check(jp.vec and jp.search == "count"
              and jp.grid * (jp.threads // 32) >= t_n, f"{row}: plan {jp}")
        print(f"  {row:22s} plan: {jp.grid} blocks of {jp.threads // 32} "
              f"warps, a warp a probe, its {w_n} keys counted in registers "
              "(32 a lane), 16 output bytes a lane")
        case(row, lambda: P.keyed_sum(probes, keys, table),
             lambda: P.keyed_sum_plain(probes, keys, table), None,
             bound(4 * (t_n + w_n + t_n * c)
                   + matched * c * table.element_size()),
             (src, "probe_join"), searchsorted_ms=half, plan=jp._asdict())
    keys, pr = JG.rank_case(dev)
    first = pr[:, 0].contiguous()
    # every plan rank_plan can give and the parent's kernel (one block a
    # row, thread 0's binary search: tools/join_gather_tiles.py's
    # PARENT_RANK build), in turns
    sweep, rplan, sweep_ms, parent_ms, _ = JG.rank_sweep(
        load_library(), rank_parent_lib, keys, pr, sms)
    check(rplan == P.rank_launch_plan(keys, pr) and rplan.search == "count"
          and rplan.kvec and rplan.grid * rplan.rb >= 16,
          f"probe_rank: plan {rplan}")
    print(f"  {'probe_rank':22s} plan: {rplan.grid} blocks of {rplan.rb} "
          "warp(s), a warp a row, its 128 keys read once 16 bytes a lane "
          "and counted, the row written 16 bytes a lane; sweep (search/"
          "blocks x warps, ms): " + "  ".join(
              f"{p.search}/{p.grid}x{p.rb} {t:.5f}"
              + ("*" if p == rplan else "") for p, t in zip(sweep, sweep_ms))
          + f"; the parent's kernel {parent_ms:.5f}")
    case("probe_rank", lambda: P.lane_rank(keys, pr),
         lambda: P.lane_rank_plain(keys, pr),
         lambda: torch.searchsorted(keys, first),
         bound(4 * (128 + 16 + 16 * 128)), ("probe_dg", "probe_rank"),
         plan=rplan._asdict(), parent_ms=parent_ms)
    a8 = torch.randint(-127, 127, (128, 256), device=dev).to(torch.int8)
    b8 = torch.randint(-127, 127, (256, 128), device=dev).to(torch.int8)
    try:
        torch._int_mm(a8, b8)
        int_mm = lambda: torch._int_mm(a8, b8)  # noqa: E731
    except RuntimeError as e:  # the yardstick only; the port never calls it
        print(f"  torch._int_mm refuses [128, 256] @ [256, 128]: {e}")
        int_mm = None

    def show_plan(row, m, k, n, is_int8):
        """The plan ``gemm`` launches on (``ops/probes.py::gemm_plan``)."""
        p = P.gemm_plan(m, k, n, is_int8, sms)
        check(p.grid >= 64, f"{row}: {p.grid} blocks on {sms} SMs (fewer "
              "than 64)")
        print(f"  {row:22s} plan: tile {p.bm} x {p.bn}, {p.grid} blocks, K "
              f"split over {p.kw} warps of {p.ks} ({p.kc} a round), "
              f"{p.smem} B shared")
        return p

    plan8 = show_plan("probe_gemm_s8", 128, 256, 128, True)
    case("probe_gemm_s8", lambda: P.gemm(a8, b8), lambda: P.gemm_plain(a8, b8),
         int_mm, bound(2 * 128 * 256 + 4 * 128 * 128,
                       2 * 128 * 256 * 128, "int8"),
         ("probe_int8", "probe_gemm_s8"), plan=plan8._asdict())
    af = torch.rand((128, 432), device=dev)
    bf = torch.rand((432, 128), device=dev)
    ab, bb = af.bfloat16(), bf.bfloat16()
    plan16 = show_plan("probe_gemm_bf16", 128, 432, 128, False)
    # torch.mm with an f32 out computes the row's function exactly (bf16
    # products, f32 sums and out), where this PyTorch has it
    try:
        torch.mm(ab, bb, out_dtype=torch.float32)
        mm_f32 = cuda_ms(torch, lambda: torch.mm(ab, bb,
                                                 out_dtype=torch.float32),
                         100)
        print(f"  torch.mm(bf16, bf16, out_dtype=float32): {mm_f32:.4f} ms")
    except (TypeError, RuntimeError) as e:
        mm_f32 = None
        print(f"  torch.mm(bf16, bf16, out_dtype=float32) is missing in "
              f"torch {torch.__version__}: {str(e).splitlines()[0]}")
    case("probe_gemm_bf16", lambda: P.gemm(af, bf),
         lambda: P.gemm_plain(af, bf), lambda: torch.matmul(ab, bb),
         bound(4 * (128 * 432 * 2 + 128 * 128), 2 * 128 * 432 * 128),
         ("probe_dg", "probe_gemm_bf16"), tol=1e-5, plan=plan16._asdict(),
         mm_out_f32_ms=mm_f32)
    # probe_sk: S1 at C = K = 64 on the stage-0 scan
    voxels, coors, shape = B.synthetic_scan(0)
    xsk = B.make_bench_input(voxels, coors, shape, dtype=torch.bfloat16,
                             device=dev)
    skeys, _ = C.linearize(xsk.indices, xsk.spatial_shape, 1)
    geom = D.SearchGeom.of(KSIZE, DIL, shape, 1)
    g = torch.Generator(device=dev).manual_seed(31)
    fs = (torch.randn((skeys.shape[0], 64), device=dev, generator=g)
          * xsk.valid_mask[:, None]).bfloat16()
    ws = (torch.randn((27, 64, 64), device=dev, generator=g) / 41.57
          ).bfloat16()
    pos = D.build_dg_pos(skeys, **geom._asdict())
    case("probe_sk_search", lambda: D.dg_fwd_search(fs, ws, skeys, geom),
         lambda: D.dg_fwd_search_plain(fs, ws, skeys, geom), None,
         gemm_bound(fs, ws, pos, 64, keys=skeys), ("probe_sk",
                                                   "dg_fwd_search"),
         tol=TOL["bfloat16"])
    return rows


# per MNIST classifier SGD step (models/classifier.py, batch 8 on 28 x 28):
# two subm convs (their tables and reversed tables; the first conv's input
# needs no gradient), two strided convs without a key (affine and divide
# tables each step)
CLS_STEP = dict(dg_pos=2, dg_pos_rev=2, dg_fwd=2, dg_dgrad=1, dg_wgrad=2,
                dg_pos_affine=2, dg_pos_divide=2, dg_fwd_strided=2,
                dg_dgrad_strided=2, dg_wgrad_strided=2)
# per MNIST QAT float step (examples/mnist_qat.py: one subm, one strided
# conv without a key); an observe pass runs each conv twice (the float conv
# for BN's statistics, then the QAT conv), the second subm call on the
# first one's table; a QAT step is an observe pass and a float-like step
QAT_FLOAT_STEP = dict(dg_pos=1, dg_pos_rev=1, dg_fwd=1, dg_wgrad=1,
                      dg_pos_affine=1, dg_pos_divide=1, dg_fwd_strided=1,
                      dg_dgrad_strided=1, dg_wgrad_strided=1)
QAT_OBSERVE = dict(dg_pos=1, dg_fwd=2, dg_pos_affine=2, dg_fwd_strided=2)
QAT_STEP = {k: QAT_FLOAT_STEP.get(k, 0) + QAT_OBSERVE.get(k, 0)
            for k in set(QAT_FLOAT_STEP) | set(QAT_OBSERVE)}
# per int8 MNIST request (QuantizedSequential): one subm and one affine
# table, one B7 launch each, no B2
QAT_INT8_REQUEST = dict(dg_pos=1, dg_pos_affine=1, dg_fwd_q=1,
                        dg_fwd_q_strided=1)
QAT_STEPS = 30  # examples/mnist_qat.py's default
CLS_STEPS = 5
# the QAT-int8 net's dequantized output against the QAT net's own eval
# forward, in output steps: the bound the JAX pair meets on the CPU
# (tests/test_torch_qat.py: QAT_INT8_STEPS, QAT_INT8_SHARE)
QAT_INT8_STEPS = 1
QAT_INT8_SHARE = 0.01
# a QAT step's fake-quantized activations, kernels against the plain
# forward: one that lies on a rounding tie may land one step apart, on at
# most this share of them
QAT_TIE_SHARE = 0.01
# per CenterPoint bn=True training step: the bn=False request's tables and
# forward launches, the reversed and divide tables, and the backward (the
# first conv's input needs no gradient); BN's four kernels count in
# ops.batch_norm.launch_counts, once each a BatchNorm1d
CP_BN_STEP = dict(CP_LAUNCHES, dg_pos_rev=4, dg_pos_divide=4, dg_dgrad=16,
                  dg_wgrad=17, dg_dgrad_strided=4, dg_wgrad_strided=4)


def launched(torch, D, fn):
    """``(fn's result, the launches it made)`` (non-zero counts only)."""
    torch.cuda.synchronize()
    before = dict(D.launch_counts)
    res = fn()
    torch.cuda.synchronize()
    return res, {k: v - before[k] for k, v in D.launch_counts.items()
                 if v != before[k]}


def recorded(mods, fn):
    """``(fn(), calls)``: ``calls`` holds the first input and the output of
    each call of a module of ``mods``, in call order (forward hooks)."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda _, args, out: calls.append((args[0], out))) for m in mods]
    try:
        return fn(), calls
    finally:
        for h in hooks:
            h.remove()


# BatchNorm1d's kernels (ops/batch_norm.py, csrc/bn.cu), in launch order
BN_KERNELS = ("bn_stats", "bn_norm", "bn_bwd_reduce", "bn_bwd_dx")
# each BN kernel against the plain formula on a step's BN inputs, at the
# card tests' tolerances (tests/test_torch_cuda.py::
# test_bn_kernels_match_plain): count, mean and var relative each (f64
# sums in another order); y within one bf16 ulp, or of max|ref| in f32
# (torch's rsqrt on the card is not correctly rounded, the kernel's is); dx
# of max|ref| (bf16: two f32 results a rounding apart can round to
# neighbouring bf16 values); dweight and dbias of max|ref| (f64 sums
# against autograd's f32 ones)
BN_STATS_RTOL = 1e-6
BN_Y_F32_TOL = 1e-5
BN_DX_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
BN_PARAM_TOL = 2e-5
BN_REPS = 5  # timed calls of each BN kernel and its plain version a BN


def bf16_ulp(torch, t):
    """One bf16 unit in the last place of each element of ``t``, in f32."""
    e = torch.frexp(t.float().abs().clamp(min=1e-30))[1]
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def bn_calls(torch, net, fn):
    """``[(bn, x, dy)]``: each ``BatchNorm1d`` call of ``net`` while
    ``fn()`` runs a forward and its backward, in call order: the module,
    its input (a ``SparseConvTensor`` or an ``[N, C]`` tensor) and the
    gradient that reached its output's features."""
    from spconv_tpu_torch.modules import BatchNorm1d

    calls = []

    def hook(bn, args, out):
        call = [bn, args[0], None]
        calls.append(call)

        def keep(grad):
            call[2] = grad

        (out if isinstance(out, torch.Tensor) else out.features
         ).register_hook(keep)

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, BatchNorm1d)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    check(all(c[2] is not None for c in calls),
          "a BatchNorm1d's output got no gradient")
    return [tuple(c) for c in calls]


def bn_step(train, x, indices, bn, dy):
    """``(y, dx, dweight, dbias)`` of ``train(x, indices, weight, bias,
    eps)`` with ``bn``'s parameters, and the backward of ``sum(y * dy)``."""
    x = x.detach().clone().requires_grad_()
    w, b = (p.detach().clone().requires_grad_() for p in (bn.weight,
                                                           bn.bias))
    y = train(x, indices, w, b, bn.eps)
    y.backward(dy)
    return y.detach(), x.grad, w.grad, b.grad


def bn_vs_plain(torch, calls):
    """Each call of :func:`bn_calls` (a step's BN inputs at their real
    shapes) through ``ops.batch_norm.batch_norm_train`` (the four kernels)
    twice and through the plain formula (:func:`bn_plain_train`,
    autograd) on the features and the gradient cast to f32, which is exact
    (in bf16, autograd casts the gradient of each of the formula's two
    uses of ``x`` to bf16 before it adds them, and they cancel: 1.2e-2 of
    max|ref| in ``dx`` at the CenterPoint encoder's last BN on the CPU),
    gated at the ``BN_*`` tolerances: the row mask equal, count,
    mean and var, ``y``, ``dx``, ``dweight`` and ``dbias``, inactive rows
    of ``y`` and ``dx`` 0, the repeat bit-equal.  Then each kernel and its
    plain version on the same operands, timed (:func:`cuda_ms`) beside its
    bound by the bytes the work needs (PERF.md's BN bound): x of the
    active rows read once by the statistics, the normalisation and the
    backward's sums, dy of the active rows by the backward's two kernels,
    y and dx written on every row (inactive rows 0), and a mask byte a row
    a kernel with the 4 bytes of ``indices[:, 0]`` a row once.  Returns
    ``{kernel: ((max|d|, max|d| / max|ref|), Tally)}``."""
    from spconv_tpu_torch.ops import batch_norm as BNK

    err = dict.fromkeys(BN_KERNELS, (0.0, 0.0))
    tally = {k: Tally() for k in BN_KERNELS}

    def worse(kernel, e):
        err[kernel] = (max(err[kernel][0], e[0]), max(err[kernel][1], e[1]))

    for i, (bn, x, dy) in enumerate(calls):
        sparse = not isinstance(x, torch.Tensor)
        feats, ind = (x.features, x.indices) if sparse else (x, None)
        feats, dt = feats.detach(), str(feats.dtype)[6:]
        n, c = feats.shape
        what = f"BatchNorm1d call {i} ([{n}, {c}] {dt})"
        check(bn.weight is not None, f"{what}: no affine part")
        got = bn_step(BNK.batch_norm_train, feats, ind, bn, dy)
        again = bn_step(BNK.batch_norm_train, feats, ind, bn, dy)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: a repeat through the kernels differs")
        want = bn_step(bn_plain_train, feats.float(), ind, bn, dy.float())
        with torch.no_grad():
            stats, mask = BNK._BN_STATS(feats, ind)
            pstats, pmask = BNK.bn_stats_plain(feats, ind)
        check(torch.equal(mask, pmask), f"{what}: the row masks differ")
        for name, k, p in zip(("mean", "var", "count"),
                              BNK.moments(stats, c, torch.float64),
                              BNK.moments(pstats, c, torch.float64)):
            d = (k - p).abs()
            check(bool((d <= BN_STATS_RTOL * p.abs()).all()),
                  f"{what}: {name} off the plain one by up to "
                  f"{float((d / p.abs()).nan_to_num(0.0).max()):.3e} "
                  f"relative (tolerance {BN_STATS_RTOL})")
            worse("bn_stats", (float(d.max()),
                               float(d.max() / p.abs().max().clamp(
                                   min=1e-300))))
        y, ref = got[0].float(), want[0].float()
        e = rel_err(torch, y, ref)
        check(bool(((y - ref).abs() <= bf16_ulp(torch, ref)).all())
              if dt == "bfloat16" else e[1] <= BN_Y_F32_TOL,
              f"{what}: y off the plain formula by {e[1]:.3e} of max|ref| "
              "(tolerance " + ("one bf16 ulp" if dt == "bfloat16" else
                               f"{BN_Y_F32_TOL}") + ")")
        worse("bn_norm", e)
        if sparse:
            off = ind[:, 0] < 0
            check(not got[0][off].any() and not got[1][off].any(),
                  f"{what}: an inactive row of y or dx is not 0")
        for kernel, name, k, p, tol in (
                ("bn_bwd_dx", "dx", got[1], want[1], BN_DX_TOL[dt]),
                ("bn_bwd_reduce", "dweight", got[2], want[2], BN_PARAM_TOL),
                ("bn_bwd_reduce", "dbias", got[3], want[3], BN_PARAM_TOL)):
            e = rel_err(torch, k, p)
            check(p.abs().max().item() > 0 and e[1] <= tol,
                  f"{what}: {name} off the plain formula by {e[1]:.3e} of "
                  f"max|ref| (tolerance {tol})")
            worse(kernel, e)
        # each kernel and its plain version on the same operands
        w, b, eps = bn.weight.detach(), bn.bias.detach(), bn.eps
        with torch.no_grad():
            _, mean, rstd = BNK._BN_NORM(feats, mask, stats, w, b, eps)
            sums, _ = BNK._BN_BWD_REDUCE(dy, feats, mask, mean, rstd)
            calls_of = {
                "bn_stats": (lambda: BNK._BN_STATS(feats, ind),
                             lambda: BNK.bn_stats_plain(feats, ind)),
                "bn_norm": (
                    lambda: BNK._BN_NORM(feats, mask, stats, w, b, eps),
                    lambda: BNK.bn_norm_plain(feats, mask, stats, w, b,
                                              eps)),
                "bn_bwd_reduce": (
                    lambda: BNK._BN_BWD_REDUCE(dy, feats, mask, mean, rstd),
                    lambda: BNK.bn_bwd_reduce_plain(dy, feats, mask, mean,
                                                    rstd)),
                "bn_bwd_dx": (
                    lambda: BNK._BN_BWD_DX(dy, feats, mask, mean, rstd, w,
                                           sums, stats),
                    lambda: BNK.bn_bwd_dx_plain(dy, feats, mask, mean, rstd,
                                                w, sums, stats)),
            }
            act = int(mask.sum()) if sparse else n
            elem = act * c * feats.element_size()  # active rows
            out = n * c * feats.element_size()  # every row
            row_b = n if sparse else 0  # a mask byte a row
            nbytes = dict(bn_stats=elem + 5 * row_b,
                          bn_norm=elem + out + row_b,
                          bn_bwd_reduce=2 * elem + row_b,
                          bn_bwd_dx=2 * elem + out + row_b)
            for k, (kern, plain) in calls_of.items():
                tally[k].add(cuda_ms(torch, kern, BN_REPS),
                             cuda_ms(torch, plain, BN_REPS),
                             bound(nbytes[k]))
    return {k: (err[k], tally[k]) for k in BN_KERNELS}


def qat_phase(torch, dev, cp_in, cp_bounds, net32):
    """Phase 13: the MNIST classifier's SGD steps, the MNIST QAT flow from
    float pretraining through PTQ and QAT to int8, both int8 nets served
    on B7 at ndim 2, and the CenterPoint encoder with BN trained three
    steps (``cp_in``: the f32 scans, ``cp_bounds`` / ``net32``: phase 6's
    bounds and bn=False f32 encoder, whose plain run gives the
    coordinates).  Returns ``({path: launches}, {BN kernel: (launches,
    errors, Tally)})``."""
    import copy

    import numpy as np

    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.calibrate import apply_out_bounds
    from spconv_tpu_torch.examples import mnist_qat as MQ
    from spconv_tpu_torch.examples import mnist_sparse as MS
    from spconv_tpu_torch.models import SparseClassifier, centerpoint_encoder
    from spconv_tpu_torch.modules import BatchNorm1d
    from spconv_tpu_torch.ops import batch_norm as BNK
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.quantization import QATConvBnReLU, qat_observe

    launches = {}

    # ---- the MNIST classifier, SGD at the example's lr ----------------
    rng = np.random.RandomState(0)
    net = SparseClassifier(ndim=2, in_channels=1, num_classes=10,
                           device=dev, seed=0)
    batches = [MS.make_batch(rng, device=dev) for _ in range(CLS_STEPS)]

    def cls_step(n):
        logits = n(batches[0][0])
        loss = MS.ce(logits, batches[0][1])
        loss.backward()
        return (loss, logits), list(n.named_parameters())

    # the first step's loss, logits and grads against the plain backward
    # on B2's forward, then against the plain forward and backward: the
    # f32 B2 at C = 1 -> 32 and 32 -> 64 -> 64 -> 128, ndim 2
    cls_cmp = [step_vs_plain(torch, D, [copy.deepcopy(net) for _ in
                                        range(2)], cls_step, "classifier",
                             b2_forward) for b2_forward in (True, False)]
    D.reset_launch_counts()
    losses, cls_ms = [], []
    for step, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        loss, got = launched(torch, D, lambda: MS.sgd_step(net, x, y))
        cls_ms.append((time.perf_counter() - t0) * 1e3)
        check(got == CLS_STEP, f"classifier step {step}: launches {got}, "
              f"expected {CLS_STEP}")
        losses.append(loss.item())
        check(np.isfinite(losses[-1]), f"classifier step {step}: loss "
              f"{losses[-1]}")
    launches["classifier"] = dict(D.launch_counts)
    wall, busy, _ = device_busy(torch, lambda: MS.sgd_step(
        net, *batches[0], lr=0.0), 3)
    print(f"classifier (SparseClassifier(2, 1, 10), batch 8 on 28 x 28, "
          f"SGD lr {MS.LR}): losses {[round(v, 6) for v in losses]}, ms "
          f"{[round(v, 3) for v in cls_ms]}, launches a step {CLS_STEP}; "
          + busy_text(wall, busy, 3, "a step (lr 0)")
          + "; first step in f32 against "
          + ", against ".join(
              f"{what}: loss {c[0]:.9e} vs {c[1]:.9e}, logits and loss "
              f"{c[2]:.3e} of max|ref| (tolerance {NET_F32_TOL}), worst grad"
              f" {c[3][0]:.3e} ({c[3][1]}, tolerance {GRAD_F32_TOL} per "
              "tensor)" for what, c in zip(
                  ("the plain backward", "the plain forward and backward"),
                  cls_cmp)))

    # ---- the MNIST QAT flow, the example's main -----------------------
    D.reset_launch_counts()
    t0 = time.perf_counter()
    res = MQ.main(device=dev, steps=QAT_STEPS)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    launches["qat_flow"] = dict(D.launch_counts)
    check(all(np.isfinite(v) for v in res["losses_float"]
              + res["losses_qat"]), "QAT flow: a loss is not finite")
    acc = res["accuracy"]
    enc, pool, head = res["enc"], res["pool"], res["head"]
    qnet, qhead = res["qnet"], res["qhead"]
    print(f"QAT flow ({QAT_STEPS} float + {MQ.OBSERVE_BATCHES} observe + "
          f"{QAT_STEPS} QAT steps, batch 8 on 28 x 28): {flow_s:.3f} s; "
          f"float loss {res['losses_float'][0]:.6f} -> "
          f"{res['losses_float'][-1]:.6f}, QAT loss "
          f"{res['losses_qat'][0]:.6f} -> {res['losses_qat'][-1]:.6f}; "
          f"accuracy on the same {MQ.EVAL_BATCHES} batches: float "
          f"{acc['float']:.4f}, PTQ int8 {acc['ptq_int8']:.4f}, QAT int8 "
          f"{acc['qat_int8']:.4f}; launches "
          f"{ {k: v for k, v in launches['qat_flow'].items() if v} }")
    # one float step, one observe pass and one QAT step, counted; one QAT
    # step's grads against the plain backward
    x, y = MS.make_batch(rng, device=dev)
    f_enc = copy.deepcopy(enc).train()
    f_head = tuple(t.detach().clone().requires_grad_() for t in head)
    opt = torch.optim.Adam(list(f_enc.parameters()) + list(f_head),
                           lr=MQ.FLOAT_LR)
    step_ms = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        res_, got_ = launched(torch, D, fn)
        step_ms[what] = (time.perf_counter() - t0) * 1e3
        return res_, got_

    _, got = timed("float step", lambda: MQ.float_step(
        f_enc, pool, f_head, opt, x, y))
    check(got == QAT_FLOAT_STEP, f"QAT flow float step: launches {got}, "
          f"expected {QAT_FLOAT_STEP}")
    q_net = copy.deepcopy(qnet)
    _, got = timed("observe pass", lambda: qat_observe(q_net, x))
    check(got == QAT_OBSERVE, f"QAT observe pass: launches {got}, "
          f"expected {QAT_OBSERVE}")
    # the same step's loss on copies of the net from before it (scales and
    # running stats observed alike), through the kernels, the plain
    # backward on B2's forward, and the plain forward and backward
    pairs = [[(copy.deepcopy(q_net), tuple(
        t.detach().clone().requires_grad_() for t in qhead))
        for _ in range(2)] for _ in range(2)]
    q_head = tuple(t.detach().clone().requires_grad_() for t in qhead)
    q_opt = torch.optim.Adam(list(q_net.parameters()) + list(q_head),
                             lr=MQ.QAT_LR)
    _, got = timed("QAT step", lambda: MQ.qat_step(q_net, pool, q_head,
                                                   q_opt, x, y))
    check(got == QAT_STEP, f"QAT step: launches {got}, expected {QAT_STEP}")

    def qat_layers(n_):
        return [m for m in n_ if isinstance(m, QATConvBnReLU)]

    acts = []  # each run's (input, fake-quantized output) of each layer

    def qat_loss(pair):
        n_, h_ = pair

        def run():
            logits = MQ.logits_of(n_, pool, h_, x)
            loss = MQ.ce(logits, y)
            loss.backward()
            return loss, logits

        outs, calls = recorded(qat_layers(n_), run)
        acts.append(calls)
        return outs, list(n_.named_parameters()) + [("head.w", h_[0]),
                                                    ("head.b", h_[1])]

    q_bwd = step_vs_plain(torch, D, pairs[0], qat_loss, "QAT step")
    q_all = step_vs_plain(torch, D, pairs[1], qat_loss, "QAT step", False,
                          gate_outputs=False, gate_grads=False)
    # the plain forward may put an activation on a rounding tie one step
    # from the kernels' (the f32 sums differ in order); then the logits
    # and grads differ by that step's effect, and only the ties are gated
    act_k, act_p = acts[-2:]  # the last pair's runs
    ties, entries, tie_steps = 0, 0, 0.0
    for layer, (_, a), (_, b) in zip(qat_layers(pairs[1][0][0]), act_k,
                                     act_p):
        st = ((a.features - b.features).detach().abs()
              / layer.act_scale)[b.valid_mask]
        ties += int((st > 0.5).sum())
        entries += st.numel()
        tie_steps = max(tie_steps, float(st.max()))
    check(tie_steps <= 1 + 1e-3 and ties <= QAT_TIE_SHARE * entries,
          f"QAT step, plain forward: {ties} of {entries} activations off, "
          f"by up to {tie_steps:.3f} steps (at most 1 step on "
          f"{QAT_TIE_SHARE} of them)")
    if not ties:
        check(q_all[2] <= NET_F32_TOL and q_all[3][0] <= GRAD_F32_TOL,
              f"QAT step f32 vs plain forward and backward: logits and loss "
              f"{q_all[2]:.3e} (tolerance {NET_F32_TOL}), grad "
              f"{q_all[3][1]} {q_all[3][0]:.3e} (tolerance {GRAD_F32_TOL})")
    # each QAT conv's f32 output (before the ReLU and the fake quant) on
    # the kernels' run's input of that layer, against the plain forward
    conv_rel = []
    with torch.no_grad():
        for layer, (x_in, _) in zip(qat_layers(pairs[1][0][0]), act_k):
            got = recorded([layer.conv], lambda: layer(x_in))[1][0][1]
            with plain_kernels(D):
                ref = recorded([layer.conv], lambda: layer(x_in))[1][0][1]
            conv_rel.append(rel_err(torch, got.features, ref.features)[1])
    check(max(conv_rel) <= TOL["float32"], f"QAT convs' f32 forward vs "
          f"plain: {conv_rel} > {TOL['float32']} of max|ref|")
    print(f"QAT flow steps counted: float {QAT_FLOAT_STEP}; observe "
          f"{QAT_OBSERVE} (the QAT conv reuses the float conv's subm "
          f"table; the keyless downsample discovers again); QAT step "
          f"{QAT_STEP}; host ms of each: " + ", ".join(
              f"{k} {v:.3f}" for k, v in step_ms.items()))
    print(f"QAT step in f32 against the plain backward: loss "
          f"{q_bwd[0]:.9e} vs {q_bwd[1]:.9e}, logits and loss "
          f"{q_bwd[2]:.3e} of max|ref|, worst grad {q_bwd[3][0]:.3e} "
          f"({q_bwd[3][1]}, tolerance {GRAD_F32_TOL} per tensor); against "
          f"the plain forward and backward: {ties} of {entries} "
          f"fake-quantized activations one step apart, loss {q_all[0]:.9e} "
          f"vs {q_all[1]:.9e}, logits and loss {q_all[2]:.3e} of max|ref|, "
          f"worst grad {q_all[3][0]:.3e} ({q_all[3][1]}; "
          + ("gated at the tolerances above" if not ties else
             "not gated: a tie moved an activation")
          + f"); each QAT conv's output on the same input vs plain "
          f"{[f'{r:.3e}' for r in conv_rel]} of max|ref| (tolerance "
          f"{TOL['float32']})")

    # ---- serve both int8 nets: 3 requests each ------------------------
    reqs = [MS.make_batch(rng, device=dev) for _ in range(len(
        REQUEST_SEEDS))]
    qnet.eval()
    for name in ("int8_ptq", "int8_qat"):
        inet = res[name]
        with torch.inference_mode():
            inet(reqs[0][0])  # warm-up
            ms = []
            for i, (x, _) in enumerate(reqs):
                t0 = time.perf_counter()
                out, got = launched(torch, D, lambda: inet(x))
                ms.append((time.perf_counter() - t0) * 1e3)
                check(got == QAT_INT8_REQUEST, f"{name} request {i}: "
                      f"launches {got}, expected {QAT_INT8_REQUEST}")
                launches[name] = {k: launches.get(name, {}).get(k, 0) + v
                                  for k, v in got.items()}
                check(out.q_scale is None and bool(
                    torch.isfinite(out.features).all()),
                    f"{name} request {i}: output")
                for li, (g, p) in enumerate(zip(q_layers(inet, x),
                                                plain_q_layers(torch, inet,
                                                               x))):
                    check(torch.equal(g.indices, p.indices)
                          and torch.equal(g.features, p.features),
                          f"{name} request {i}: int8 layer {li} differs "
                          "from the plain run")
                if name == "int8_qat":
                    ref = qnet(x).features
                    valid = out.valid_mask
                    steps = ((out.features - ref).abs()[valid]
                             / inet.out_scale)
                    worst_steps = float(steps.max())
                    share = float((steps > 0.5).float().mean())
                    check(worst_steps <= QAT_INT8_STEPS + 1e-3
                          and share <= QAT_INT8_SHARE,
                          f"QAT int8 request {i}: {worst_steps:.3f} steps, "
                          f"{share:.4f} of entries off the QAT net's "
                          f"forward (bound {QAT_INT8_STEPS} on "
                          f"{QAT_INT8_SHARE})")
            wall, busy, _ = device_busy(torch, lambda: inet(reqs[0][0]), 3)
            peak = peak_mib(torch, lambda: inet(reqs[0][0]))
        print(f"{name} serve: ms per request {[round(m, 3) for m in ms]}, "
              f"launches a request {QAT_INT8_REQUEST}, every int8 layer "
              f"bit-equal to the plain run; "
              + busy_text(wall, busy, 3, "a request")
              + f"; peak allocated {peak[0]:.3f} MiB above the "
              f"{peak[1]:.1f} MiB held before the request"
              + (f"; vs the QAT net's forward: at most {worst_steps:.0f} "
                 f"steps, {share:.4f} of entries off"
                 if name == "int8_qat" else ""))

    # ---- CenterPoint with BN, trained --------------------------------
    def cp_bn(dtype):
        return apply_out_bounds(centerpoint_encoder(
            in_channels=5, bn=True, dtype=dtype, device=dev), cp_bounds)

    net16 = cp_bn(torch.bfloat16).train()
    x16 = {s: x.replace_feature(x.features.bfloat16())
           for s, x in cp_in.items()}
    B.train_step(net16, x16[0], 0.0)  # warm-up, no update
    torch.cuda.synchronize()
    lr = 1e-2 * max(p.abs().max().item() for p in net16.parameters()) / max(
        p.grad.abs().max().item() for p in net16.parameters())
    D.reset_launch_counts()
    step_ms = []
    want = {k: v for k, v in CP_BN_STEP.items() if v}
    n_bn = sum(isinstance(m, BatchNorm1d) for m in net16.modules())
    for seed in REQUEST_SEEDS:
        BNK.reset_launch_counts()
        t0 = time.perf_counter()
        loss, got = launched(torch, D, lambda: B.train_step(
            net16, x16[seed], lr))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(got == want, f"CenterPoint bn=True step {seed}: launches "
              f"{got}, expected {want}")
        check(BNK.launch_counts == dict.fromkeys(BNK.launch_counts, n_bn),
              f"CenterPoint bn=True step {seed}: BN launches "
              f"{BNK.launch_counts}, expected {n_bn} of each")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0,
              f"CenterPoint bn=True step {seed}: loss {loss}")
        for name, p in net16.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.any()),
                  f"CenterPoint bn=True step {seed}: {name} grad")
    launches["cp_bn"] = dict(D.launch_counts)
    bn_launches = n_bn * len(REQUEST_SEEDS)
    # each BN kernel on the step's BN inputs against the plain formula, and
    # timed beside it and its bound
    calls = bn_calls(torch, net16, lambda: B.train_step(net16, x16[0], 0.0))
    check(len(calls) == n_bn, f"CenterPoint bn=True: {len(calls)} "
          f"BatchNorm1d calls recorded in a step, expected {n_bn}")
    rows = [int(x.indices.shape[0]) for _, x, _ in calls]
    active = [int(x.valid_mask.sum()) for _, x, _ in calls]
    bn_report = {k: (bn_launches, *v) for k, v in
                 bn_vs_plain(torch, calls).items()}
    del calls
    print(f"CenterPoint bn=True bf16 step's {n_bn} BatchNorm1d inputs "
          f"({sum(active)} active of {sum(rows)} rows, channels 16-128) "
          "through BN's kernels against the plain formula (autograd), "
          f"each within its tolerance (count, mean, var {BN_STATS_RTOL} "
          f"relative; y one bf16 ulp; dx {BN_DX_TOL['bfloat16']}, dweight "
          f"and dbias {BN_PARAM_TOL} of max|ref|), a repeat bit-equal, "
          "inactive rows 0; worst max|d| / max|ref| and summed ms: "
          + "; ".join(f"{k} {e[1]:.3e}, {t}" for k, (_, e, t)
                      in bn_report.items()))

    def b2_window(ops):
        modes = [b2_mode(o) for o in ops]
        fwd = CP_BN_STEP["dg_fwd"] + CP_BN_STEP["dg_fwd_strided"]
        dgrad = CP_BN_STEP["dg_dgrad"] + CP_BN_STEP["dg_dgrad_strided"]
        if modes.count("fwd") == fwd and modes.count("dgrad") == dgrad:
            return None
        return (f"{modes.count('fwd')} forward and {modes.count('dgrad')} "
                "dgrad B2 launches")

    ops = counted_ops(torch, lambda: B.train_step(net16, x16[0], 0.0),
                      D.launch_counts, CP_BN_STEP, b2_window,
                      "a CenterPoint bn=True step")
    wall, busy, _ = device_busy(torch, lambda: B.train_step(
        net16, x16[0], 0.0), 3)
    peak = peak_mib(torch, lambda: B.train_step(net16, x16[0], 0.0))
    with torch.no_grad():
        stages = net16.forward_stages(x16[0])
        ref = plain_encoder_stages(torch, net32, cp_in[0])
    for si, (g, r) in enumerate(zip(stages, ref)):
        check(torch.equal(g.indices, r.indices), f"CenterPoint bn=True: "
              f"stage {si} coordinates differ from the plain run")
    loss_k, loss_p, _, cp_worst = step_vs_plain(
        torch, D, [cp_bn(torch.float32).train() for _ in range(2)],
        lambda n: zero_lr_step(B, n, cp_in[0]), "CenterPoint bn=True")
    print(f"CenterPoint bn=True train (bf16, BN on batch statistics, SGD "
          f"lr={lr:.4e}): ms per step {[round(m, 3) for m in step_ms]}, "
          f"launches a step {want} and {n_bn} of each BN kernel; profiler "
          f"window: {len(ops)} device ops;"
          f" " + busy_text(wall, busy, 3, "a step")
          + f"; peak allocated {peak[0]:.1f} MiB above the {peak[1]:.1f} "
          f"MiB held before the step; coordinates equal to the plain run "
          f"at every stage; f32 loss {loss_k:.9e} (plain backward, BN's "
          f"included: {loss_p:.9e}), worst f32 grad vs it "
          f"{cp_worst[0]:.3e} ({cp_worst[1]}, tolerance {GRAD_F32_TOL} per "
          "tensor)")
    return launches, bn_report


# per native BenchNet request: 14 B2 launches on the subm rulebooks' tables
# and no B1 (the rulebooks are torch ops); a step adds 13 dgrad (the first
# conv's input needs no gradient) and 14 wgrad launches
NATIVE_SERVE = dict(dg_fwd_native=14)
NATIVE_STEP = dict(NATIVE_SERVE, dg_dgrad_native=13, dg_wgrad_native=14)
# the grid past 2**31 sites: four batch items of the CenterPoint scans on a
# [160, 2048, 2048] grid (int64 keys)
BIG_SHAPE = (160, 2048, 2048)


def native_phase(torch, dev, gen, scans, geo, bounds, served, tables, revs,
                 cp_in, note):
    """Phase 14: the native rulebook path.  BenchNet on ``algo="native"``
    (bf16, phase 4's pool buffers): every stage's subm rulebook equal to
    phase 3's B1 tables (``tables``, ``revs``), timed beside them; three
    requests (14 ``dg_fwd_native`` launches each, no table kernel) bit-equal
    to phase 4's keyed DG net (``served``) at every stage; three training
    steps with launch counts, a zero-lr step's grads bit-equal to the DG
    net's, the f32 grads against the plain backward; host ms, device busy
    and peak memory beside the DG net's.  Then phase 4's scans with rows
    shuffled through the ``"auto"`` net (stage 0 native), equal to phase 4
    after aligning rows by coordinate; a keyed ``SparseMaxPool3d`` and its
    ``SparseInverseConv3d`` (f32, forward and backward) and a subm +
    strided pair on a grid past 2**31 sites against a plain run; an int8
    ``SparseConvTranspose3d(64, 32, 2, s2)`` bit-equal to plain; and one
    native conv's forward under ``torch.cuda.set_sync_debug_mode("error")``.
    Each native kernel's error against plain goes to ``note``.  Returns
    ``(step launches, int8 launches, B7's tally)``: the launch counts of
    the three native training steps and of the int8 request, and B7's
    times there."""
    import numpy as np
    from spconv_tpu_torch import (SparseConv3d, SparseConvTensor,
                                  SparseConvTranspose3d, SparseInverseConv3d,
                                  SparseMaxPool3d, SubMConv3d)
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.core import IndiceData
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops import rulebook as R
    from spconv_tpu_torch.quantization import (PerChannelMinMaxObserver,
                                               QuantizedSparseConv)

    bf16 = torch.bfloat16

    def bench_net(dtype, algo, train=False):
        net = B.BenchNet(SHAPE, dtype=dtype, pool_bounds=bounds, device=dev,
                         algo=algo, seed=0)
        return net if train else net.eval()

    # ---- the subm rulebooks against B1's tables, both timed
    print("stage  N_buf  rulebook_ms  B1 table_ms (forward + reversed)")
    for s, g in enumerate(geo):
        geom = dict(spatial_shape=g.spatial_shape, batch_size=1,
                    ksize=KSIZE, dilation=DIL)
        rb = R.build_subm_rulebook(g.indices, **geom)
        check(torch.equal(rb.pair_fwd, tables[s])
              and torch.equal(rb.pair_bwd, revs[s]),
              f"stage {s}: the subm rulebook differs from B1's tables")
        keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        tgeom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=g.spatial_shape,
                     batch_size=1)
        rb_ms = cuda_ms(torch, lambda: R.build_subm_rulebook(g.indices,
                                                             **geom), 5)
        b1_ms = cuda_ms(torch, lambda: (D.build_dg_pos(keys, **tgeom),
                                        D.build_dg_pos(keys, reverse=True,
                                                       **tgeom)), 10)
        print(f"{s:5d} {g.indices.shape[0]:6d}  {rb_ms:11.4f}  {b1_ms:.4f}")

    # ---- serve: three requests, bit-equal to phase 4 at every stage
    native, dg = bench_net(bf16, "native"), bench_net(bf16, None)
    worst = 0.0
    with torch.inference_mode():
        native(served[0][1])  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        for seed, x, stages, dg_ms in served:
            before = dict(D.launch_counts)
            t0 = time.perf_counter()
            got = native.forward_stages(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            delta = {k: D.launch_counts[k] - before[k] for k in before}
            check(delta == expected(D, **NATIVE_SERVE),
                  f"native request {seed}: launches {delta}")
            recs = got[-1].indice_dict
            check(all(isinstance(recs[f"c{i}"], IndiceData)
                      for i in range(7)),
                  f"native request {seed}: a stage left no IndiceData")
            if seed == served[0][0]:
                for i in range(7):
                    check(torch.equal(recs[f"c{i}"].pair_fwd, tables[i]),
                          f"native request {seed}: stage {i}'s rulebook "
                          "differs from B1's table")
            for i, (a, b) in enumerate(zip(got, stages)):
                check(torch.equal(a.indices, b.indices),
                      f"native request {seed}: stage {i} sites differ")
                if not torch.equal(a.features, b.features):
                    d, r = rel_err(torch, a.features, b.features)
                    rows = int((a.features != b.features).any(1).sum())
                    print(f"native request {seed}: stage {i} differs from "
                          f"phase 4 in {rows} rows, max|d| {d:.3e} "
                          f"({r:.3e} of max|ref|)")
                    check(r <= TOL["bfloat16"], f"native request {seed}: "
                          f"stage {i} {r:.3e} > {TOL['bfloat16']}")
                    worst = max(worst, r)
            print(f"native request seed={seed} ms={ms:.3f} (DG, phase 4: "
                  f"{dg_ms:.3f}); " + ("bit-equal to phase 4's keyed net at "
                                       "every stage" if not worst else
                                       f"within {worst:.3e} of phase 4"))
        x0 = served[0][1]
        busy = [(name, device_busy(torch, lambda: m(x0), 3))
                for name, m in (("dg", dg), ("native", native),
                                ("native", native), ("dg", dg))]
        peaks = [(name, peak_mib(torch, lambda: m(x0)))
                 for name, m in (("dg", dg), ("native", native))]
    print("native vs DG BenchNet, 3 bf16 requests of seed 0 a window, in "
          "turns: " + turns_text(busy) + "; peak allocated in a request: "
          + ", ".join(f"{name} {p:.1f} MiB above {b:.1f}"
                      for name, (p, b) in peaks))

    # ---- train: three steps, then a zero-lr step against the DG net's
    net = bench_net(bf16, "native", train=True)
    xs = [B.make_bench_input(*scans[s], dtype=bf16, device=dev)
          for s in REQUEST_SEEDS]
    B.train_step(net, xs[0], 0.0)  # warm-up, no update
    torch.cuda.synchronize()
    lr = 1e-2 * max(p.abs().max().item() for p in net.parameters()) / max(
        p.grad.abs().max().item() for p in net.parameters())
    D.reset_launch_counts()
    for seed, x in zip(REQUEST_SEEDS, xs):
        before = dict(D.launch_counts)
        t0 = time.perf_counter()
        loss = B.train_step(net, x, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: D.launch_counts[k] - before[k] for k in before}
        check(delta == expected(D, **NATIVE_STEP),
              f"native train step {seed}: launches {delta}")
        loss = loss.item()
        check(np.isfinite(loss) and loss > 0,
              f"native step {seed}: loss {loss}")
        for name, p in net.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  and bool(p.grad.any()), f"native step {seed}: {name} "
                  "grad missing, 0 or not finite")
        print(f"native train step seed={seed} ms={ms:.3f} loss={loss:.6e}")
    launches = dict(D.launch_counts)
    steps = (("dg", bench_net(bf16, None, train=True)),
             ("native", bench_net(bf16, "native", train=True)))
    for _, m in steps:
        B.train_step(m, xs[0], 0.0)
    grads = [[p.grad for p in m.parameters()] for _, m in steps]
    same = [torch.equal(a, b) for a, b in zip(*grads)]
    if not all(same):
        rels = [rel_err(torch, b, a)[1] for a, b in zip(*grads)]
        print(f"native step grads differ from the DG step's in "
              f"{same.count(False)} of {len(same)} tensors, worst "
              f"{max(rels):.3e} of max|ref|")
        check(max(rels) <= WGRAD_TOL["bfloat16"],
              "native step grads beyond the bf16 bound of the DG step's")
    step_busy = [(name, device_busy(torch, lambda: B.train_step(
        m, xs[0], 0.0), 3)) for name, m in steps + steps[::-1]]
    step_peaks = [(name, peak_mib(torch, lambda: B.train_step(m, xs[0], 0.0)))
                  for name, m in steps]
    print("native vs DG BenchNet step (bf16, seed 0, lr 0): grads "
          + ("bit-equal" if all(same) else "within the bf16 bound")
          + "; windows of 3 in turns: " + turns_text(step_busy)
          + "; peak allocated in a step: " + ", ".join(
              f"{name} {p:.1f} MiB above {b:.1f}"
              for name, (p, b) in step_peaks))
    x32 = B.make_bench_input(*scans[0], device=dev)
    *losses, _, worst_g = step_vs_plain(
        torch, D, [bench_net(torch.float32, "native", train=True)
                   for _ in range(2)],
        lambda n: zero_lr_step(B, n, x32), "native BenchNet")
    print(f"native train f32 seed=0: loss kernels {losses[0]:.9e}, plain "
          f"backward {losses[1]:.9e}; worst weight grad max|d|/max|ref| "
          f"{worst_g[0]:.3e} ({worst_g[1]}, tolerance {GRAD_F32_TOL})")

    # ---- phase 4's scans with rows shuffled, through the "auto" net
    with torch.inference_mode():
        for seed, x, stages, _ in served:
            perm = torch.randperm(x.indices.shape[0], device=dev,
                                  generator=gen)
            xs_ = SparseConvTensor(x.features[perm], x.indices[perm], SHAPE,
                                   1)
            D.reset_launch_counts()
            out = dg(xs_)
            torch.cuda.synchronize()
            check(dict(D.launch_counts) == expected(
                D, dg_fwd_native=2, dg_pos=6, dg_fwd=12),
                f"shuffled request {seed}: launches {D.launch_counts}")
            ref = stages[-1]
            keys, _ = C.linearize(out.indices, out.spatial_shape, 1)
            order = torch.sort(keys, stable=True).indices
            check(torch.equal(out.indices[order], ref.indices),
                  f"shuffled request {seed}: sites differ from phase 4")
            d, r = rel_err(torch, out.features[order], ref.features)
            check(r <= TOL["bfloat16"], f"shuffled request {seed}: {r:.3e}")
            print(f"shuffled request seed={seed}: stage 0 native, the rest "
                  f"DG; after aligning rows by coordinate "
                  + ("bit-equal to phase 4" if d == 0 else
                     f"max|d| {d:.3e} ({r:.3e} of max|ref|) from phase 4"))

    # ---- a keyed pool and its inverse conv, f32, against a plain run
    g0 = geo[0]
    feats = (torch.randn((g0.indices.shape[0], 64), device=dev,
                         generator=gen) * g0.valid_mask[:, None])

    def pool_inverse():
        pool = SparseMaxPool3d(2, 2, indice_key="p", out_bound=bounds[0])
        inv = SparseInverseConv3d(64, 32, 2, indice_key="p", device=dev,
                                  generator=torch.Generator().manual_seed(3))
        x = SparseConvTensor(feats.clone().requires_grad_(), g0.indices,
                             SHAPE, 1, keys_sorted=True)
        y = inv(pool(x))
        (y.features ** 2).sum().backward()
        return [y.features.detach(), x.features.grad, inv.weight.grad]

    D.reset_launch_counts()
    got = pool_inverse()
    torch.cuda.synchronize()
    check(dict(D.launch_counts) == expected(
        D, dg_fwd_native=1, dg_dgrad_native=1, dg_wgrad_native=1),
        f"pool + inverse launches {D.launch_counts}")
    with plain_kernels(D):
        ref = pool_inverse()
    rels = [rel_err(torch, a, b) for a, b in zip(got, ref)]
    for (d, r), tol in zip(rels, (TOL["float32"], TOL["float32"],
                                  WGRAD_TOL["float32"])):
        check(r <= tol, f"keyed pool + inverse: {r:.3e} > {tol} of plain")
    for kern, (d, r) in zip(("dg_fwd_native", "dg_dgrad_native",
                             "dg_wgrad_native"), rels):
        note(kern, d, r)
    print("keyed SparseMaxPool3d(2, 2) + SparseInverseConv3d(64, 32, 2) on "
          "stage 0, f32 (every child gets W[0], as in the JAX package): "
          "max|d|/max|ref| vs plain out {:.3e}, din {:.3e}, dW {:.3e}".format(
              *[r for _, r in rels]))

    # ---- a subm + strided pair on a grid past 2**31 sites, f32
    rows = [torch.cat([torch.full_like(cp_in[s].indices[:, :1], b),
                       cp_in[s].indices[:, 1:]], 1)
            for b, s in enumerate((0, 1, 2, 0))]
    big_inds = torch.cat(rows)
    big_inds[big_inds[:, 1] < 0] = -1
    check(C.use_int64_keys(BIG_SHAPE, 4), "the big grid has int32 keys")
    big_feats = (torch.randn((big_inds.shape[0], 16), device=dev,
                             generator=gen) * (big_inds[:, :1] >= 0))

    def big_pair():
        g = torch.Generator().manual_seed(4)
        convs = [SubMConv3d(16, 16, 3, indice_key="s", device=dev,
                            generator=g),
                 SparseConv3d(16, 32, 3, stride=2, padding=1,
                              indice_key="d", device=dev, generator=g)]
        x = SparseConvTensor(big_feats, big_inds, BIG_SHAPE, 4)
        with torch.no_grad():
            return convs[1](convs[0](x))

    D.reset_launch_counts()
    t0 = time.perf_counter()
    y_big = big_pair()
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    check(dict(D.launch_counts) == expected(D, dg_fwd_native=2),
          f"big-grid pair launches {D.launch_counts}")
    with plain_kernels(D):
        y_ref = big_pair()
    d, r = rel_err(torch, y_big.features, y_ref.features)
    check(torch.equal(y_big.indices, y_ref.indices) and r <= TOL["float32"],
          f"big-grid pair vs plain: {r:.3e}")
    note("dg_fwd_native", d, r)
    print(f"subm + strided pair on {BIG_SHAPE} x 4 (int64 keys, "
          f"{int((big_inds[:, 0] >= 0).sum())} sites -> "
          f"{int(y_big.num_voxels)}): {big_ms:.3f} ms host, max|d|/max|ref| "
          f"vs plain {r:.3e}")

    # ---- the int8 transposed conv: USAGE.md's ConvTranspose(64, 32, 2, s2)
    tconv = SparseConvTranspose3d(64, 32, 2, stride=2, device=dev,
                                  generator=torch.Generator().manual_seed(5))
    obs = PerChannelMinMaxObserver()
    obs.observe(tconv.weight)
    qt = QuantizedSparseConv(tconv, obs.scale, 0.02, 0.05, act_type="relu")
    x_in = cp_in[0]
    q_in = (torch.randint(-100, 101, (x_in.indices.shape[0], 64), device=dev,
                          generator=gen, dtype=torch.int8)
            * (x_in.indices[:, :1] >= 0))
    xq = SparseConvTensor(q_in.to(torch.int8), x_in.indices,
                          x_in.spatial_shape, 1, keys_sorted=True)
    with torch.inference_mode():
        D.reset_launch_counts()
        yq = qt(xq)
        torch.cuda.synchronize()
        q_launches = dict(D.launch_counts)
        check(q_launches == expected(D, dg_fwd_q_native=1),
              f"int8 transposed launches {q_launches}")
        rb = R.build_conv_rulebook(
            xq.indices, spatial_shape=xq.spatial_shape, batch_size=1,
            ksize=(2, 2, 2), stride=(2, 2, 2), padding=(0, 0, 0),
            dilation=DIL, transposed=True, out_bound=yq.indices.shape[0])
        args = (xq.features, qt.weight_kv, rb.pair_fwd, qt.scale_q,
                qt.bias_q)
        want = D.dg_fwd_q_plain(*args, act="relu")
        want = want * (rb.out_indices[:, :1] >= 0)
        check(torch.equal(yq.features, want.to(torch.int8))
              and torch.equal(yq.indices, rb.out_indices),
              "int8 transposed conv differs from plain")
        note("dg_fwd_q_native", 0.0, 0.0)
        q_tally = Tally()
        q_tally.add(cuda_ms(torch, lambda: D.dg_fwd_q(
                        *args, act="relu", path="native"), 10),
                    cuda_ms(torch, lambda: D.dg_fwd_q_plain(
                        *args, act="relu"), 2),
                    q_bound(xq.features, qt.weight_kv, rb.pair_fwd, 32,
                            False))
    print(f"int8 SparseConvTranspose3d(64, 32, 2, s2) on the CenterPoint "
          f"scan ({int(xq.num_voxels)} -> {int(yq.num_voxels)} sites on "
          f"{tuple(yq.spatial_shape)}): bit-equal to plain; B7 {q_tally}")

    # ---- the rulebooks read nothing back to the host
    conv = SubMConv3d(64, 64, 3, indice_key="sync", algo="native",
                      dtype=bf16, device=dev)
    xb = g0.replace_feature(feats.to(bf16))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            conv(xb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("a native SubMConv3d forward (rulebook + B2) ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")
    return launches, q_launches, q_tally


# per served points -> BEV request: the voxelizer and the tensor build are
# torch ops (no kernel); the encoder launches phase 6's kernels
POINTS_LAUNCHES = CP_LAUNCHES
CP_BEV_SHAPE = (1, 512, 128, 128)  # [B, C * D, H, W] of the encoder
# boxes for rotate_nms: 500 seeded (cx, cy, w, h, yaw) over a 100 m square
NMS_BOXES = 500
NMS_THRESH = 0.2
VOXEL_OUTPUTS = ("voxels", "coords", "num_per_voxel", "pc_voxel_id",
                 "num_voxels")


def points_phase(torch, dev, cp_in, cp_net, cp_bounds):
    """Phase 15: raw point clouds on the card.  Voxelizes
    ``synthetic_centerpoint_points(seed)`` with the JAX loader's
    ``PointToVoxel`` (coordinates equal to the stand-in scans' sites in
    ``cp_in``, every output bit-equal to the CPU's, timed); serves three
    points -> BEV requests through phase 6's calibrated bf16 encoder
    ``cp_net`` (launch counts, the BEV against a ``plain_kernels`` run,
    host ms, busy, idle and peak memory, the voxelizer's share); maps a
    layer's output back to the points; runs ``sparse_add``,
    ``RemoveDuplicate`` (feeding a subm conv on B1 + B2), a ``HashTable``,
    ``rotate_nms`` and the three ported examples on the card against the
    same calls on the CPU; and round-trips the encoder through
    ``save_checkpoint`` / ``load_checkpoint`` (``cp_bounds``: its buffers),
    bit-equal.  Returns ``{path: launches}``."""
    import tempfile

    import numpy as np

    import spconv_tpu_torch as st
    from spconv_tpu_torch.benchmark import centerpoint as CPB
    from spconv_tpu_torch.calibrate import apply_out_bounds
    from spconv_tpu_torch.examples import fuse_bn_act as FB
    from spconv_tpu_torch.examples import int8_ptq_encoder as IP
    from spconv_tpu_torch.examples import voxel_gen as VG
    from spconv_tpu_torch.models import centerpoint_encoder
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.utils import (PointToVoxel, boxops,
                                        gather_features_by_pc_voxel_id)

    launches = {}
    args = (CPB.CP_VSIZE, CPB.CP_RANGE, 3, CPB.CP_MAX_VOXELS, 1)
    gen, gen_cpu = PointToVoxel(*args, device=dev), PointToVoxel(
        *args, device="cpu")
    lo, hi = np.array(CPB.CP_RANGE[:3]), np.array(CPB.CP_RANGE[3:])

    # ---- voxelize: the stand-in's sites, the card against the CPU
    t0 = time.perf_counter()
    clouds = {s: CPB.synthetic_centerpoint_points(s) for s in REQUEST_SEEDS}
    print(f"CenterPoint point clouds: {time.perf_counter() - t0:.2f} s on "
          f"the host, {[len(clouds[s]) for s in REQUEST_SEEDS]} points")
    pts = {s: torch.from_numpy(p).to(dev) for s, p in clouds.items()}
    for s in REQUEST_SEEDS:
        got = gen.generate_voxel_with_id(pts[s])
        want = gen_cpu.generate_voxel_with_id(clouds[s])
        for name, g, w in zip(VOXEL_OUTPUTS, got, want):
            check(g.device == dev and torch.equal(g.cpu(), w),
                  f"voxelizer seed {s}: {name} on the card differs from the "
                  "CPU's")
        nv, n_site = int(got[4]), int(cp_in[s].num_voxels)
        sites = cp_in[s].indices[:n_site, 1:]
        check(nv == n_site and torch.equal(got[1][:nv], sites)
              and bool((got[1][nv:] == -1).all()),
              f"voxelizer seed {s}: {nv} voxels, not the stand-in scan's "
              f"{n_site} sites")
        outside = ~((clouds[s] >= lo) & (clouds[s] < hi)).all(1)
        vid = got[3].cpu().numpy()
        check(np.array_equal(vid < 0, outside),
              f"voxelizer seed {s}: dropped points are not those outside "
              "the range")
        print(f"voxelize seed={s}: {len(clouds[s])} points ({outside.sum()} "
              f"outside the range) -> {nv} voxels, the stand-in scan's "
              f"sites; all five outputs bit-equal to the CPU")

    def voxelize():
        return gen.generate_voxel_with_id(pts[0])

    n_pts = len(clouds[0])
    vox_ms = cuda_ms(torch, voxelize, 10)
    vox_win = device_busy(torch, voxelize, 3)
    print("voxelizer's device time by op over 3 calls (profiler): " + "; ".join(
        f"{name} {us / 1e3:.4f} ms x{k}"
        for name, us, k in device_ops_by_time(torch, voxelize, 3)[:8]))
    vox_peak, _ = peak_mib(torch, voxelize)
    m = CPB.CP_MAX_VOXELS
    # each input read once, each output written once: the points, the
    # [M, 1, 3] voxels, [M, 3] coords, [M] counts, [N] ids and the count
    vox_bound = bound(4 * (3 * n_pts + 3 * m + 3 * m + m + n_pts + 1))
    print(f"voxelizer ({n_pts} points -> {int(voxelize()[4])} voxels, cap "
          f"{m}): {vox_ms:.4f} ms a call (CUDA events, 10 calls); "
          + busy_text(*vox_win[:2], 3, "a call", vox_win[2])
          + f"; peak +{vox_peak:.1f} MiB; bytes bound {vox_bound[0]:.4f} ms")

    # ---- serve points -> BEV through phase 6's encoder
    def request(s):
        x, _ = CPB.voxelized_centerpoint_input(
            points=pts[s], dtype=torch.bfloat16, device=dev)
        return cp_net.bev(x), x

    with torch.inference_mode():
        request(0)  # warm-up
        torch.cuda.synchronize()
        D.reset_launch_counts()
        req_ms = {}
        for s in REQUEST_SEEDS:
            t0 = time.perf_counter()
            bev, x = request(s)
            torch.cuda.synchronize()
            req_ms[s] = (time.perf_counter() - t0) * 1e3
            check(torch.equal(x.indices, cp_in[s].indices)
                  and x.spatial_shape == cp_in[s].spatial_shape,
                  f"points request {s}: the voxelized tensor's rows differ "
                  "from phase 6's scan")
            check(tuple(bev.shape) == CP_BEV_SHAPE
                  and bev.dtype == torch.bfloat16
                  and bool(torch.isfinite(bev).all()) and bool(bev.any()),
                  f"points request {s}: bev {tuple(bev.shape)} {bev.dtype}, "
                  "not finite or all 0")
        launches["points -> BEV, 3 requests"] = dict(D.launch_counts)
        want = expected(D, **{k: len(REQUEST_SEEDS) * v
                              for k, v in POINTS_LAUNCHES.items()})
        check(launches["points -> BEV, 3 requests"] == want,
              f"points -> BEV launches {D.launch_counts}, expected {want}")
        for s in REQUEST_SEEDS:
            bev, _ = request(s)
            with plain_kernels(D):
                ref, _ = request(s)  # its own tensor: no cached table
            _, r = rel_err(torch, bev, ref)
            check(r <= TOL["bfloat16"], f"points request {s}: bev against "
                  f"plain {r:.3e} > {TOL['bfloat16']} of max|ref|")
            print(f"points request seed={s} ms={req_ms[s]:.3f} bev "
                  f"{tuple(bev.shape)} bf16_rel_vs_plain={r:.3e}")
        req_win = device_busy(torch, lambda: request(0), 3)
        req_peak, req_base = peak_mib(torch, lambda: request(0))
        enc_x, _ = CPB.voxelized_centerpoint_input(
            points=pts[0], dtype=torch.bfloat16, device=dev)
        enc_win = device_busy(torch, lambda: cp_net.bev(enc_x), 3)
    print("points -> BEV request (voxelizer, tensor build, bf16 encoder): "
          + busy_text(*req_win[:2], 3, "a request", req_win[2])
          + f"; peak +{req_peak:.1f} MiB (above {req_base:.1f}); encoder "
          "alone on the same tensor: "
          + busy_text(*enc_win[:2], 3, "a request", enc_win[2])
          + (f"; the voxelizer's share of the request's device busy "
             f"{100 * vox_win[1] / req_win[1]:.1f} %"
             if vox_win[1] and req_win[1] else ""))

    # ---- a layer's output mapped back to the points
    with torch.inference_mode():
        got = gen.generate_voxel_with_id(pts[0])
        y = cp_net.conv_input(enc_x).features
        per_point = gather_features_by_pc_voxel_id(y, got[3], -1.0)
    f = y.float().cpu().numpy()
    vid = got[3].cpu().numpy()
    want = np.where(vid[:, None] >= 0, f[np.maximum(vid, 0)], -1.0)
    check(np.array_equal(per_point.float().cpu().numpy(), want),
          "gather_features_by_pc_voxel_id differs from a numpy gather")
    print(f"conv_input's {tuple(y.shape)} output mapped to {n_pts} points: "
          f"equal to a numpy gather, {(vid < 0).sum()} out-of-range points "
          "at invalid_value -1")

    # ---- the other modules, each on the card against the CPU
    def cpu(x):
        return st.SparseConvTensor(x.features.cpu(), x.indices.cpu(),
                                   x.spatial_shape, x.batch_size,
                                   keys_sorted=x.keys_sorted)

    def same(a, b, what):
        for name in ("features", "indices", "num_voxels"):
            check(torch.equal(getattr(a, name).cpu(), getattr(b, name)),
                  f"{what}: {name} on the card differs from the CPU's")

    a = cp_in[0]
    inds = a.indices.clone()
    inds[:, 3] += 1  # one voxel along x; rows pushed off the grid drop
    off = (a.indices[:, 0] < 0) | (inds[:, 3] >= a.spatial_shape[2])
    inds[off] = -1
    b = st.SparseConvTensor(torch.where(off[:, None], 0.0, a.features * 2),
                            inds, a.spatial_shape, 1)
    t0 = time.perf_counter()
    s_add = st.sparse_add(a, b)
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t0) * 1e3
    same(s_add, st.sparse_add(cpu(a), cpu(b)), "sparse_add")
    print(f"sparse_add of the scan and its copy shifted one voxel: "
          f"{int(s_add.num_voxels)} sites in {s_add.indices.shape[0]} rows, "
          f"{add_ms:.3f} ms host; bit-equal to the CPU")

    g = torch.Generator().manual_seed(0)
    n_act = int(a.num_voxels)
    dup = torch.randperm(n_act, generator=g)[:n_act // 10].to(dev)
    perm = torch.randperm(a.indices.shape[0] + dup.shape[0],
                          generator=g).to(dev)
    xd = st.SparseConvTensor(
        torch.cat([a.features, a.features[dup] - 1.0])[perm],
        torch.cat([a.indices, a.indices[dup]])[perm], a.spatial_shape, 1)
    dedup = st.RemoveDuplicate()(xd)
    same(dedup, st.RemoveDuplicate()(cpu(xd)), "RemoveDuplicate")
    check(int(dedup.num_voxels) == n_act and dedup.keys_sorted,
          "RemoveDuplicate did not keep one row a site")
    conv = st.SubMConv3d(5, 16, 3, indice_key="dedup", device=dev,
                         generator=torch.Generator().manual_seed(1))
    conv_cpu = st.SubMConv3d(5, 16, 3, indice_key="dedup", device="cpu",
                             generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        D.reset_launch_counts()
        yd = conv(dedup)
        torch.cuda.synchronize()
        launches["RemoveDuplicate + subm conv"] = dict(D.launch_counts)
        check(dict(D.launch_counts) == expected(D, dg_pos=1, dg_fwd=1),
              f"subm conv after RemoveDuplicate: launches {D.launch_counts}")
        _, r = rel_err(torch, yd.features.cpu(),
                       conv_cpu(cpu(dedup)).features)
    check(r <= TOL["float32"], f"subm conv after RemoveDuplicate: {r:.3e} "
          "of max|ref| from the CPU")
    print(f"RemoveDuplicate of the scan with {dup.shape[0]} rows repeated: "
          f"{n_act} sites kept, bit-equal to the CPU; a subm conv on it "
          f"(B1 + B2) within {r:.3e} of max|ref| of the CPU's")

    keys, _ = C.linearize(a.indices, a.spatial_shape, 1)
    keys = keys[:n_act]
    queries = torch.cat([keys, keys + 1])
    tables = []
    for device in (dev, "cpu"):
        t = st.HashTable(1 << 18, device=device).insert(
            keys.to(device), torch.arange(n_act, dtype=torch.int32,
                                          device=device))
        tables.append([v.cpu() for v in (*t.query(queries.to(device)),
                                         *t.items())])
    check(all(torch.equal(p, q) for p, q in zip(*tables)),
          "HashTable on the card differs from the CPU's")
    check(int(tables[0][4]) == n_act and not bool(tables[0][1][:n_act].any()),
          "HashTable lost keys")
    print(f"HashTable of the scan's {n_act} keys, queried with them and "
          f"{n_act} others: bit-equal to the CPU, "
          f"{int((~tables[0][1]).sum())} found")

    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-50, 50, (NMS_BOXES, 2)),
                            rng.uniform(1, 6, (NMS_BOXES, 2)),
                            rng.uniform(-np.pi, np.pi, (NMS_BOXES, 1))], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    scores = torch.from_numpy(rng.rand(NMS_BOXES).astype(np.float32))
    t0 = time.perf_counter()
    keep = boxops.rotate_nms(boxes.to(dev), scores.to(dev), NMS_THRESH)
    torch.cuda.synchronize()
    nms_ms = (time.perf_counter() - t0) * 1e3
    keep_cpu = boxops.rotate_nms(boxes, scores, NMS_THRESH)
    check(torch.equal(keep.cpu(), keep_cpu)
          and 0 < int(keep_cpu.sum()) < NMS_BOXES,
          "rotate_nms keep mask on the card differs from the CPU's")
    _, r = rel_err(torch, boxops.rbbox_iou(boxes.to(dev), boxes.to(dev)),
                   boxops.rbbox_iou(boxes, boxes).to(dev))
    print(f"rotate_nms of {NMS_BOXES} boxes: {int(keep.sum())} kept, the "
          f"keep mask equal to the CPU's, {nms_ms:.3f} ms host; IoU within "
          f"{r:.3e} of max")

    # ---- the ported examples, on the card against the CPU
    D.reset_launch_counts()
    vg = VG.main(device=dev)
    torch.cuda.synchronize()
    launches["examples.voxel_gen"] = dict(D.launch_counts)
    _, r_vg = rel_err(torch, vg.cpu(), VG.main(device="cpu"))
    D.reset_launch_counts()
    fb = FB.main(device=dev)
    torch.cuda.synchronize()
    launches["examples.fuse_bn_act"] = dict(D.launch_counts)
    fb_cpu = FB.main(device="cpu")
    r_fb = max(rel_err(torch, p.cpu(), q)[1] for p, q in zip(fb, fb_cpu))
    D.reset_launch_counts()
    ip = IP.main(device=dev)
    torch.cuda.synchronize()
    launches["examples.int8_ptq_encoder"] = dict(D.launch_counts)
    ip_cpu = IP.main(device="cpu")
    _, r_ip = rel_err(torch, ip[0].cpu(), ip_cpu[0])
    steps = (ip[1].cpu() - ip_cpu[1]).abs() / ip_cpu[3]
    check(launches["examples.voxel_gen"] == expected(D, dg_pos=1, dg_fwd=1)
          and launches["examples.fuse_bn_act"].get("dg_fwd_native", 0) > 0
          and launches["examples.int8_ptq_encoder"].get("dg_fwd_q", 0) > 0,
          f"examples' launches {launches}")
    check(max(r_vg, r_fb, r_ip) <= NET_F32_TOL,
          f"examples on the card against the CPU: voxel_gen {r_vg:.3e}, "
          f"fuse_bn_act {r_fb:.3e}, int8_ptq_encoder fp {r_ip:.3e} > "
          f"{NET_F32_TOL} of max|ref|")
    # scales observed through B2 on the card and the plain version on the
    # CPU may differ in the last bit, so a rounding tie may land one step
    # apart, and the layers after carry it on
    check(float(steps.max()) <= 2 + 1e-3
          and float((steps > 1e-3).float().mean()) <= QAT_TIE_SHARE,
          f"int8_ptq_encoder's int8 output on the card vs the CPU: "
          f"{float(steps.max()):.3f} steps max")
    print(f"examples on the card vs the CPU: voxel_gen per-point features "
          f"{r_vg:.3e} of max|ref|; fuse_bn_act {r_fb:.3e}; int8_ptq_encoder "
          f"fp {r_ip:.3e}, int8 {float(steps.max()):.3f} steps max, L2 error "
          f"{ip[2]:.4f} (CPU {ip_cpu[2]:.4f})")

    # ---- checkpoints: the encoder through an npz, served bit-equal
    net2 = apply_out_bounds(centerpoint_encoder(
        in_channels=5, bn=False, device=dev, seed=1).eval(), cp_bounds).to(
            torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/centerpoint.npz"
        st.save_checkpoint(cp_net, path)
        st.load_checkpoint(net2, path)
    with torch.inference_mode():
        same_bev = torch.equal(cp_net.bev(enc_x), net2.bev(enc_x))
    check(same_bev, "the encoder loaded from its checkpoint serves another "
          "BEV")
    print("checkpoint: the bf16 encoder saved, loaded into a net of other "
          "weights and served: BEV bit-equal")
    return launches



# ---- phase 16: the tuner, per-layer timing, data parallelism -------------

# BenchNet's convs: (stage, C, K), in layer order
def bench_layers(B):
    return [(i // 2, B.CHANNELS[i], B.CHANNELS[i + 1]) for i in range(14)]


# the CenterPoint data-parallel step: ranks on the one card (gloo), steps,
# and the seconds a run of ranks may take before it is stopped and fails
DP_WORLD = 2
DP_STEPS = 3
DP_TIMEOUT = 600
# a data-parallel f32 step against one process's step on the batch of both
# scans, per tensor of max|ref|: sums in another order (the BN statistics
# accumulate in f64, so the order leaves the gradient alone)
DP_F32_TOL = 1e-4


def b2_tile(name):
    """The ``B2_TILES`` entry ``(BM, BN, BK)`` of a device op of B2's bf16
    kernel, else None."""
    m = re.search(r"dg_fwd_bf16_kernel<[^<]*Tile<(\d+), (\d+), \d+, \d+, "
                  r"(\d+)>", name)
    return tuple(int(v) for v in m.groups()) if m else None


def tune_phase(torch, dev, scans, bounds, served, geo, cache_root):
    """Phase 16's tuner parts on BenchNet (seed 0, bf16, phase 4's pool
    bounds), each tuner in its own directory under ``cache_root``: one
    request and one training step under ``"auto"`` with tuning forced
    (every conv signature tuned for inference and for training), each
    signature's candidates printed; three requests from the cache
    bit-equal to phase 4's keyed net at every stage (``served``); a
    zero-lr step's grads bit-equal to the DG net's; a second tuner reading
    every winner back.  Then B2's five bf16 tiles on the native table of
    stage 0 (``geo[0]``) at C = K = 64: each within the bf16 gate of the
    plain version, tuned, the winner read back, and a native conv's
    forward launching the tuned tile (and, tuned in turn, every other
    one)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spconv_tpu_torch import tuner as TU
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.modules import SubMConv3d
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.ops import gather_gemm as G
    from spconv_tpu_torch.ops.rulebook import build_subm_rulebook

    bf16 = torch.bfloat16
    default = TU.CONV_TUNER
    tuned = TU.ConvTuner(cache_dir=str(cache_root / "benchnet"))
    tuned.force_tune = True
    TU.CONV_TUNER = tuned
    try:
        net = B.BenchNet(SHAPE, dtype=bf16, pool_bounds=bounds, device=dev,
                         seed=0)
        x0 = B.make_bench_input(*scans[0], dtype=bf16, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            net(x0)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        B.train_step(net, x0, 0.0)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        cache_file = tuned._cache_file()
        cache = json.loads(cache_file.read_text())
        rows = {(s, c, k): geo[s].indices.shape[0]
                for s, c, k in bench_layers(B)}
        want = {tuned.key(op, tuned.bucket_n(n), c, k, 27, "bfloat16")
                for (s, c, k), n in rows.items()
                for op in ("algo", "algo_train")}
        check(set(cache) == want, f"tuned signatures {sorted(cache)}, "
              f"expected {sorted(want)}")
        print(f"tuner on BenchNet (bf16, seed 0, tuning forced): a request "
              f"tuned {sum(k.startswith('algo|') for k in cache)} "
              f"signatures in {serve_s:.2f} s, a training step "
              f"{sum(k.startswith('algo_train|') for k in cache)} in "
              f"{train_s:.2f} s; ms of each candidate (forward; training: "
              "forward and backward to the features and the weight):")
        for key in sorted(cache, key=lambda k: (k.split("|")[0],
                                               -int(k.split("|")[1][1:]))):
            rec = cache[key]
            cands = rec["candidates"]
            check(all(np.isfinite(cands[a]) for a in ("native", "sk", "dg")),
                  f"{key}: a candidate failed: {cands}")
            print(f"  {key}: native {cands['native']:.4f} sk "
                  f"{cands['sk']:.4f} dg {cands['dg']:.4f} -> "
                  f"{rec['algo']}")
        # three requests from the cache, bit-equal to phase 4's keyed net
        stamp = cache_file.stat().st_mtime_ns
        with torch.inference_mode():
            for seed, x, stages, _ in served:
                got = net.eval().forward_stages(x)
                check(all(torch.equal(a.features, b.features)
                          and torch.equal(a.indices, b.indices)
                          for a, b in zip(got, stages)),
                      f"tuned request {seed} differs from phase 4's")
        # a zero-lr step against the DG net's
        dg = B.BenchNet(SHAPE, dtype=bf16, pool_bounds=bounds, device=dev,
                        seed=0, algo="dg")
        B.train_step(net, x0, 0.0)
        B.train_step(dg, x0, 0.0)
        same = [torch.equal(a.grad, b.grad)
                for a, b in zip(net.parameters(), dg.parameters())]
        check(all(same), f"the tuned net's zero-lr step grads differ from "
              f"the DG net's in {same.count(False)} of {len(same)} tensors")
        check(cache_file.stat().st_mtime_ns == stamp,
              "the cached net tuned again")
        again = TU.ConvTuner(cache_dir=str(cache_root / "benchnet"))
        for key, rec in cache.items():
            op, n, c, k, kv, dt = key.split("|")
            sig = dict(n=int(n[1:]), c=int(c[1:]), k=int(k[1:]),
                       kv=int(kv[2:]), dtype=dt,
                       training=op == "algo_train")
            check(again.has_algo(**sig) and again.select_algo(
                subm=True, sk_supported=True, dg_supported=True, **sig)
                == rec["algo"], f"a second tuner reads {key} as another "
                "winner")
        winners = [rec["algo"] for rec in cache.values()]
        print(f"tuned BenchNet: 3 requests from the cache bit-equal to "
              f"phase 4 at every stage; a zero-lr step's grads bit-equal to "
              f"the DG net's; a second tuner read all {len(cache)} winners "
              f"back ({ {a: winners.count(a) for a in set(winners)} })")

        # B2's tiles on the native table of stage 0, C = K = 64
        g = geo[0]
        gen = torch.Generator(device=dev).manual_seed(16)
        pair = build_subm_rulebook(
            g.indices, spatial_shape=g.spatial_shape, batch_size=1,
            ksize=KSIZE, dilation=DIL).pair_fwd
        f = (torch.randn((g.indices.shape[0], 64), device=dev, generator=gen)
             * g.valid_mask[:, None]).to(bf16)
        w = (torch.randn((27, 64, 64), device=dev, generator=gen)
             / float(np.sqrt(27 * 64))).to(bf16)
        ref = D.dg_fwd_plain(f, w, pair)
        for tile in range(len(D.B2_TILES)):
            _, r = rel_err(torch, G.gather_mm(f, w, pair, None, tile=tile),
                           ref)
            check(r <= TOL["bfloat16"], f"B2 tile {tile} on the native "
                  f"table: {r:.3e} > {TOL['bfloat16']} of max|ref|")
        tile_dir = str(cache_root / "tile")
        won = TU.ConvTuner(cache_dir=tile_dir).tune_conv_tile(f, w, pair,
                                                             None)
        n = pair.shape[1]
        back = TU.ConvTuner(cache_dir=tile_dir).get_tuned_params(
            "gather_mm", n, 64, 64, 27, "bfloat16")
        check(back == won, f"the tuned tile read back as {back}, not {won}")
        own = D.b2_variant(n, 64, 64).tile
        print(f"B2 bf16 tiles on the native stage-0 table (N {n}, C = K = "
              f"64), each within {TOL['bfloat16']} of max|ref| of plain; "
              "ms: " + ", ".join(
                  f"{D.B2_TILES[int(v.split('=')[1])][:2]} {ms:.4f}"
                  for v, ms in won["candidates"].items())
              + f"; tuned tile {won['tile']} {D.B2_TILES[won['tile']][:2]}, "
              f"b2_variant's own {own}; read back")
        conv = SubMConv3d(64, 64, 3, bias=False, indice_key="tile",
                          algo="native", dtype=bf16, device=dev)
        x = SparseConvTensor(f, g.indices, g.spatial_shape, 1,
                             keys_sorted=True)

        def launched_tiles():
            """The B2 tiles of three forwards' device ops (a window can
            lose a device op's record)."""
            with torch.inference_mode():
                conv(x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        conv(x)
                    torch.cuda.synchronize()
            return [t for t in (b2_tile(e.name) for e in device_ops(prof))
                    if t is not None]

        shown = []
        for tile in [won["tile"]] + [t for t in range(len(D.B2_TILES))
                                     if t != won["tile"]]:
            if tile == won["tile"]:
                TU.CONV_TUNER = TU.ConvTuner(cache_dir=tile_dir)
            else:  # a tuning whose one variant is this tile caches it
                TU.CONV_TUNER = TU.ConvTuner(
                    cache_dir=str(cache_root / f"tile{tile}"))
                TU.CONV_TUNER.tune_and_cache(
                    "gather_mm", n, 64, 64, 27, "bfloat16",
                    {f"tile={tile}": lambda a, t=tile: G.gather_mm(
                        a, w, pair, None, tile=t)}, (f,))
            tiles = launched_tiles()
            check(tiles and set(tiles) == {D.B2_TILES[tile]},
                  f"native convs with tile {tile} cached launched B2 tiles "
                  f"{tiles}")
            shown.append(tile)
        print(f"native SubMConv3d(64, 64) forward with the tuned tile cached: "
              f"its profiler window shows B2 on tile {D.B2_TILES[won['tile']]}"
              f"; with each other tile cached in turn, that tile ({shown})")
    finally:
        TU.CONV_TUNER = default


def timing_phase(torch, dev, scans, bounds, served, cp_net, cp16, cp_ms):
    """Phase 16's per-layer timing: one BenchNet request with
    ``benchmark=True`` (20 records, phase 4's stage sizes, times > 0,
    their sum beside a request's host ms and profiler busy);
    ``KernelTimer`` spans around the net's seven stages against the host
    ms around them; a profiler window with every layer's
    ``record_function`` range and phase 4's launches; phase 6's
    CenterPoint request host ms again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.ops import dg_conv as D
    from spconv_tpu_torch.tools import KernelTimer

    bf16 = torch.bfloat16
    net = B.BenchNet(SHAPE, dtype=bf16, pool_bounds=bounds, device=dev,
                     seed=0).eval()
    active = [int(t.num_voxels) for t in served[0][2]]
    with torch.inference_mode():
        x = B.make_bench_input(*scans[0], dtype=bf16, device=dev)
        net(x)  # warm-up
        xb = x.shadow_copy()
        xb.benchmark = True
        out = net(xb)
        torch.cuda.synchronize()
    recs = list(out.benchmark_record.values())
    want = []
    for s in range(7):
        if s:
            want.append(("SparseMaxPool3d", active[s - 1], active[s]))
        want += [("SubMConv3d", active[s], active[s])] * 2
    got = [(r["type"], r["num_voxels_in"], r["num_voxels_out"])
           for r in recs]
    check(got == want, f"benchmark records {got}, expected {want}")
    check(all(r["time_ms"] > 0 for r in recs),
          f"a layer's time_ms is not > 0: {[r['time_ms'] for r in recs]}")
    layer_sum = sum(r["time_ms"] for r in recs)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net(x)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        wall, busy, n_ops = device_busy(torch, lambda: net(x), 3)
        timer = KernelTimer(device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = x
        for s in range(7):
            with timer.namespace(f"stage{s}"):
                if s:
                    y = net.pools[s - 1](y)
                y = net.convs[2 * s + 1](net.convs[2 * s](y))
        torch.cuda.synchronize()
        stage_host = (time.perf_counter() - t0) * 1e3
    spans = timer.get_all_pair_time()
    check(sorted(spans) == [f"stage{s}" for s in range(7)],
          f"KernelTimer keys {sorted(spans)}")
    check(sum(spans.values()) <= stage_host, f"the stages' CUDA-event spans "
          f"sum to {sum(spans.values()):.3f} ms, past the {stage_host:.3f} ms "
          "host ms around them")
    print(f"benchmark=True BenchNet request (bf16, seed 0): 20 records, "
          f"voxel counts phase 4's {active}, per-layer ms (CUDA events, a "
          f"sync after each layer) " + ", ".join(
              f"{name} {r['time_ms']:.3f}"
              for name, r in out.benchmark_record.items())
          + f"; sum {layer_sum:.3f} ms vs a request without it: host "
          f"{host:.3f} ms, " + busy_text(wall, busy, 3, "a request", n_ops))
    print("KernelTimer spans around the 7 stages (CUDA events, one sync at "
          "the end): " + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
          + f"; sum {sum(spans.values()):.3f} ms <= host "
          f"{stage_host:.3f} ms around them")
    # a profiler window: every layer's range; the launches of phase 4
    names = {"SubMConv3d": 14, "SparseMaxPool3d": 6}
    with torch.inference_mode():
        before = dict(D.launch_counts)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in D.launch_counts.items()
             if v != before[k]}
    check(delta == {"dg_pos": 7, "dg_fwd": 14},
          f"a profiled request launched {delta}, not phase 4's")
    events = prof.events()
    ranges = {n: sum(1 for e in events if e.name == n
                     and e.device_type == DeviceType.CPU) for n in names}
    check(ranges == names, f"record_function ranges {ranges}, expected "
          f"{names}")
    ops = device_ops(prof)
    check(not any(e.name in names for e in ops),
          "a layer's range counts as a device op")
    mirrored = sum(1 for e in events if e.device_type == DeviceType.CUDA
                   and e.is_user_annotation)
    print(f"profiler window of a request: record_function ranges {ranges} "
          f"(host events; {mirrored} mirrored on the device timeline as "
          f"user annotations, not counted), launches {delta} (phase 4's), "
          f"{len(ops)} device ops")
    # the host cost a layer pays with no profiler and no benchmark: the
    # auto resolution (nothing cached: the heuristic at once; a cached
    # winner: a signature and a dict lookup) and run_layer's two checks,
    # timed on their own over many calls
    from spconv_tpu_torch import tuner as TU
    from spconv_tpu_torch.modules.modules import run_layer

    conv = cp_net.stages[0][0].conv1
    calls = 20000
    t0 = time.perf_counter()
    for _ in range(calls):
        TU.CONV_TUNER.resolve(conv, cp16[0], True)
    resolve_us = (time.perf_counter() - t0) / calls * 1e6
    cached = TU.ConvTuner(cache_dir=str(Path(os.environ[
        "SPCONV_TPU_TUNE_CACHE"]) / "resolve"))
    cached.cache_algo(n=1, c=1, k=1, kv=1, dtype="float32", algo="dg")
    t0 = time.perf_counter()
    for _ in range(calls):
        cached.resolve(conv, cp16[0], True)
    cached_us = (time.perf_counter() - t0) / calls * 1e6

    class Passthrough:
        name = None

        def _forward(self, x):
            return x

    layer = Passthrough()
    t0 = time.perf_counter()
    for _ in range(calls):
        layer._forward(cp16[0])
    direct_us = (time.perf_counter() - t0) / calls * 1e6
    t0 = time.perf_counter()
    for _ in range(calls):
        run_layer(layer, cp16[0])
    wrapped_us = (time.perf_counter() - t0) / calls * 1e6
    n_convs = sum(1 for m in cp_net.modules()
                  if type(m).__name__.startswith(("SubMConv", "SparseConv")))
    print(f"host cost a layer (mean of {calls} calls on the card's host): "
          f"auto resolution {resolve_us:.3f} us with nothing cached, "
          f"{cached_us:.3f} us with a winner cached; run_layer's checks "
          f"{wrapped_us - direct_us:.3f} us; a CenterPoint request ({n_convs} "
          f"convs, nothing cached) "
          f"{(resolve_us + wrapped_us - direct_us) * n_convs:.1f} us")
    # phase 6's CenterPoint request host ms, again after the rest ran
    again = []
    with torch.inference_mode():
        for seed in REQUEST_SEEDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp_net.bev(cp16[seed])
            torch.cuda.synchronize()
            again.append((time.perf_counter() - t0) * 1e3)
    print(f"CenterPoint request host ms (auto resolution, the benchmark "
          f"and profiler checks on every layer): phase 6 "
          f"{[round(m, 3) for m in cp_ms]}, phase 16 "
          f"{[round(m, 3) for m in again]}")


def bn_kernel_cost(torch, dev, cp_in, cp_bounds):
    """A bf16 ``bn=True`` CenterPoint training step (phase 13's) with
    BatchNorm on its kernels and on the plain formula
    (:func:`bn_plain_train`), profiler windows of 3 steps in turns."""
    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.calibrate import apply_out_bounds
    from spconv_tpu_torch.models import centerpoint_encoder
    from spconv_tpu_torch.modules import modules as MM

    net = apply_out_bounds(centerpoint_encoder(
        in_channels=5, bn=True, dtype=torch.bfloat16, device=dev),
        cp_bounds).train()
    x = cp_in[0].replace_feature(cp_in[0].features.bfloat16())
    kernels = MM.batch_norm_train
    windows = []
    try:
        for name, fn in (("kernels", kernels), ("plain", bn_plain_train),
                         ("plain", bn_plain_train), ("kernels", kernels)):
            MM.batch_norm_train = fn
            windows.append((name, device_busy(
                torch, lambda: B.train_step(net, x, 0.0), 3)))
    finally:
        MM.batch_norm_train = kernels
    print("CenterPoint bn=True bf16 step with BatchNorm on its kernels "
          "(csrc/bn.cu) and on the plain formula, windows of 3 in turns: "
          + turns_text(windows))


def batch_of(torch, xs):
    """One tensor holding the active rows of ``xs`` (key-sorted scans of
    one grid) as batch items 0, 1, ...: still key-sorted."""
    from spconv_tpu_torch.core import SparseConvTensor

    feats, inds = [], []
    for b, x in enumerate(xs):
        n = int(x.num_voxels)
        i = x.indices[:n].clone()
        i[:, 0] = b
        feats.append(x.features[:n])
        inds.append(i)
    n = sum(f.shape[0] for f in feats)
    nbuf = -(-n // 1024) * 1024
    f = feats[0].new_zeros((nbuf, feats[0].shape[1]))
    i = inds[0].new_full((nbuf, inds[0].shape[1]), -1)
    f[:n] = torch.cat(feats)
    i[:n] = torch.cat(inds)
    return SparseConvTensor(f, i, xs[0].spatial_shape, len(xs),
                            keys_sorted=True)


def bev_loss(torch, net, x, scale, checked):
    """``sum(bev ** 2) * scale`` of the encoder ``net`` on ``x`` (``checked``:
    every stage's bound read back and checked uncut, a sync a stage)."""
    stages = net.forward_stages(x)
    if checked:
        for s in stages:
            s.check_overflow("the encoder")
    return (stages[-1].dense().float() ** 2).sum() * scale


def dp_rank(rank, world, device, cp_bounds, steps):
    """One rank of phase 16's data-parallel CenterPoint run, on ``device``
    (the one card): ``centerpoint_encoder(5, bn=True)`` with every BN on ``"dp"``
    (SyncBN) and phase 6's buffers, on ``synthetic_centerpoint_input
    (rank)``; a bf16 warm-up step and ``steps`` SGD steps (ms, busy, peak
    memory), then an f32 step (loss and grads for the gate) and the
    encoder's last 128-channel conv column-parallel against the whole
    layer on scan 0's stage-3 output (the input replicated), f32 and
    bf16."""
    import torch

    from spconv_tpu_torch import parallel as P
    from spconv_tpu_torch.benchmark import centerpoint as CPB
    from spconv_tpu_torch.calibrate import apply_out_bounds
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.models import centerpoint_encoder
    from spconv_tpu_torch.modules import BatchNorm1d

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = P.make_mesh(world)
    tp = P.make_mesh(world, axis="tp")
    x = CPB.synthetic_centerpoint_input(rank, device=dev)[0]
    shape = x.spatial_shape

    def encoder(dtype):
        net = apply_out_bounds(centerpoint_encoder(
            in_channels=5, bn=True, dtype=dtype, device=dev), cp_bounds)
        for m in net.modules():
            if isinstance(m, BatchNorm1d):
                m.axis_name = "dp"
        return net.train()

    def stacked(dtype):
        return (x.features.to(dtype)[None].expand(world, -1, -1),
                x.indices[None].expand(world, -1, -1))

    def loss_fn(checked):
        return lambda net, f, i: bev_loss(torch, net, SparseConvTensor(
            f, i, shape, 1, keys_sorted=True), 1.0, checked)

    res = {}
    net16 = encoder(torch.bfloat16)
    f16, i16 = stacked(torch.bfloat16)
    step = P.data_parallel_value_and_grad(loss_fn(False), mesh)
    step(net16, f16, i16)  # warm-up, no update
    torch.cuda.synchronize()
    lr = 1e-2 * max(p.abs().max().item() for p in net16.parameters()) / max(
        p.grad.abs().max().item() for p in net16.parameters())
    res["ms"], res["losses"] = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(net16, f16, i16)
        with torch.no_grad():
            for p in net16.parameters():
                p.add_(p.grad, alpha=-lr)
        torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["losses"].append(loss.item())
    res["lr"] = lr
    res["busy"] = device_busy(torch, lambda: step(net16, f16, i16), 3)
    res["peak"] = peak_mib(torch, lambda: step(net16, f16, i16))
    net32 = encoder(torch.float32)
    loss, grads = P.data_parallel_value_and_grad(loss_fn(True), mesh)(
        net32, *stacked(torch.float32))
    res["loss32"] = loss.item()
    res["grads32"] = {k: g.cpu() for k, g in grads.items()}
    # the last 128-channel conv (conv_out), its 128 columns over the ranks
    # on a replicated input: scan 0's stage-3 output on every rank
    x0 = x if rank == 0 else CPB.synthetic_centerpoint_input(0, device=dev)[0]
    for name, net in (("float32", net32), ("bfloat16", net16)):
        conv = net.conv_out
        with torch.no_grad():
            x3 = net.forward_stages(x0.replace_feature(
                x0.features.to(next(net.parameters()).dtype)))[3]
            whole = conv(SparseConvTensor(x3.features, x3.indices,
                                          x3.spatial_shape, 1,
                                          keys_sorted=True))
            cols, idx = P.channel_parallel_conv(
                conv, tp, axis="tp", keys_sorted=True)(
                    conv.weight, conv.bias, x3.features, x3.indices,
                    x3.spatial_shape, 1)
        check(torch.equal(idx, whole.indices),
              f"channel-parallel conv_out sites differ ({name})")
        res[f"cp_{name}"] = rel_err(torch, cols, whole.features)[1]
    res["cp_k"] = (net32.conv_out.out_channels // world,
                   net32.conv_out.out_channels)
    return res


def dp_phase(torch, dev, cp_in, cp_bounds):
    """Phase 16's data parallelism: :func:`dp_rank` on ``DP_WORLD`` ranks
    of one card (``gloo``, ``file://`` rendezvous; the library was built
    before any rank starts), the f32 step against one process's step on
    the batch of both scans (buffers calibrated for it, uncut), the ranks'
    grads bit-equal, the column-parallel conv within the gates, then the
    ``dist_train`` example's 2 steps.  No process is left behind."""
    import multiprocessing

    import numpy as np

    from spconv_tpu_torch.calibrate import calibrate_out_bounds
    from spconv_tpu_torch.examples import dist_train
    from spconv_tpu_torch.models import centerpoint_encoder
    from spconv_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    res = run_ranks(dp_rank, DP_WORLD, (str(dev), cp_bounds, DP_STEPS),
                    backend="gloo", timeout=DP_TIMEOUT)
    run_s = time.perf_counter() - t0
    check(multiprocessing.active_children() == [],
          "a rank outlived its run")
    for r, out in enumerate(res):
        wall, busy, n_ops = out["busy"]
        print(f"data-parallel CenterPoint rank {r} of {DP_WORLD} on ONE card "
              f"(gloo: each all-reduce goes through host memory; not a "
              f"reading of {DP_WORLD} cards), bf16, SyncBN, SGD lr "
              f"{out['lr']:.4e}: step ms {[round(m, 3) for m in out['ms']]}, "
              f"mean losses {[f'{v:.6e}' for v in out['losses']]}, "
              + busy_text(wall, busy, 3, "a step", n_ops)
              + f", peak allocated {out['peak'][0]:.1f} MiB above "
              f"{out['peak'][1]:.1f}")
        check(all(np.isfinite(out["losses"])), f"rank {r}: a loss is not "
              "finite")
    check(all(torch.equal(g, res[1]["grads32"][k])
              for k, g in res[0]["grads32"].items()),
          "the ranks' mean grads differ")
    # one process, one tensor holding both scans
    x2 = batch_of(torch, [cp_in[0], cp_in[1]])
    net = calibrate_out_bounds(
        centerpoint_encoder(in_channels=5, bn=True, device=dev).train(),
        lambda m, t: m.bev(t), [x2], margin=1.15, mult=512)
    loss = bev_loss(torch, net, x2, 0.5, True)
    loss.backward()
    check(abs(res[0]["loss32"] - loss.item()) <= DP_F32_TOL * loss.item(),
          f"data-parallel f32 loss {res[0]['loss32']} vs one process "
          f"{loss.item()}")
    worst = max((rel_err(torch, res[0]["grads32"][name], p.grad.cpu())[1],
                 name) for name, p in net.named_parameters())
    check(worst[0] <= DP_F32_TOL, f"data-parallel f32 grad {worst[1]}: "
          f"{worst[0]:.3e} > {DP_F32_TOL} of max|ref| of one process's")
    for name, tol in TOL.items():
        for r, out in enumerate(res):
            check(out[f"cp_{name}"] <= tol, f"rank {r}: channel-parallel "
                  f"conv_out {name} {out[f'cp_{name}']:.3e} > {tol}")
    kd, k = res[0]["cp_k"]
    print(f"data-parallel f32 step ({DP_WORLD} ranks, seeds 0 and 1) vs one "
          f"process on the batch of both scans (buffers calibrated for it, "
          f"every stage uncut): loss {res[0]['loss32']:.9e} vs "
          f"{loss.item():.9e}, worst grad {worst[0]:.3e} of max|ref| "
          f"({worst[1]}, gate {DP_F32_TOL}); the ranks' grads bit-equal; "
          f"conv_out column-parallel ({kd} of {k} columns a rank) vs the "
          f"whole layer: f32 {max(o['cp_float32'] for o in res):.3e}, bf16 "
          f"{max(o['cp_bfloat16'] for o in res):.3e} of max|ref|; "
          f"{run_s:.1f} s for the ranks' run")
    ex = dist_train.main(steps=2, device=dev.type)
    check(all(np.isfinite(ex["losses"])) and ex["loss_after"]
          < ex["losses"][0], f"dist_train: losses {ex['losses']}, step 0's "
          f"scans after training {ex['loss_after']}")
    check(np.allclose(ex["ddp_losses"], ex["losses"], rtol=1e-6),
          f"dist_train: DistributedDataParallel losses {ex['ddp_losses']} "
          f"vs {ex['losses']}")
    check(multiprocessing.active_children() == [],
          "a dist_train rank outlived its run")
    print(f"dist_train example on the card (2 ranks, gloo): losses "
          f"{[f'{v:.6e}' for v in ex['losses']]}, step 0's scans after "
          f"step 1 {ex['loss_after']:.6e} (falling); the "
          f"DistributedDataParallel path's {[f'{v:.6e}' for v in ex['ddp_losses']]}")


# ---- phase 17: export, save and reload (torch.export) ---------------------

# one process that reloads a blob: it imports the port (which registers the
# kernels' ops) and nothing of the model, runs the program on the saved
# inputs on the card and saves its output and launch counts
EXPORT_CHILD = """
import sys
import torch
import spconv_tpu_torch  # registers the kernels' ops
from spconv_tpu_torch.export import deserialize_and_call
from spconv_tpu_torch.ops import dg_conv as D

blob_path, in_path, out_path = sys.argv[1:4]
data = torch.load(in_path)
args = [data[k].to("cuda") for k in ("f", "i")]
D.reset_launch_counts()
out = deserialize_and_call(open(blob_path, "rb").read(), *args)
torch.cuda.synchronize()
torch.save({"out": out.cpu(), "counts": dict(D.launch_counts)}, out_path)
if "jax" in sys.modules or "spconv_tpu" in sys.modules:
    sys.exit("the child imported JAX or the JAX package")
"""
SMOKE_LIBS = []  # the torch.library.Library objects dispatch_us made
DISPATCH_CALLS = 500  # calls a reading: fewer than the launch queue holds
DISPATCH_ROWS = 128   # B2's rows: a few µs on the card


def dispatch_us(torch, dev):
    """Host µs a call, on the host clock with no sync inside
    ``DISPATCH_CALLS`` calls (the card takes them as fast as they come and
    the launch queue holds them all, so the host's cost is what is read),
    read in turns (the calls in order, then in reverse), a sync before and
    after each reading: B2 (bf16, a ``[27, DISPATCH_ROWS]`` table, 16 ->
    16 channels) by the launch the op wraps (``_gather_gemm_cuda``), by
    the ``dg_gather_gemm`` op (``_gather_gemm_op``) and by the wrapper
    ``dg_fwd`` (its checks and the op), all three bit-equal; and a clone
    of 16 floats, alone, as an op defined by ``torch.library.Library``
    (the port's way) and as one made by the ``custom_op`` decorator.
    Returns ``({call: [µs, µs]}, B2's µs on the card)``."""
    from spconv_tpu_torch.ops import dg_conv as D

    g = torch.Generator(device=dev).manual_seed(17)
    n = DISPATCH_ROWS
    x = torch.randn((n, 16), device=dev, generator=g).bfloat16()
    w = torch.randn((27, 16, 16), device=dev, generator=g).bfloat16()
    pos = torch.randint(-1, n, (27, n), device=dev, generator=g,
                        dtype=torch.int32)
    small = torch.randn(16, device=dev, generator=g)
    # a Library kept for the life of the process: deleting one leaves its
    # op's stale entry in torch.ops, on which torch 2.11's decomposition
    # table (AOTInductor's, phase 18) fails
    lib = torch.library.Library("spconv_tpu_smoke", "DEF")
    SMOKE_LIBS.append(lib)
    lib.define("clone_lib(Tensor x) -> Tensor")
    lib.impl("clone_lib", lambda t: t.clone(), "CUDA")

    @torch.library.custom_op("spconv_tpu_smoke::clone_deco", mutates_args=())
    def clone_deco(t: torch.Tensor) -> torch.Tensor:
        return t.clone()

    calls = {
        "direct": lambda: D._gather_gemm_cuda(x, w, pos, "dg_fwd"),
        "op": lambda: D._gather_gemm_op(x, w, pos, "dg_fwd"),
        "wrapper": lambda: D.dg_fwd(x, w, pos),
        "clone": lambda: small.clone(),
        "clone Library op": lambda: torch.ops.spconv_tpu_smoke.clone_lib(
            small),
        "clone custom_op": lambda: clone_deco(small)}
    outs = [calls[k]() for k in ("direct", "op", "wrapper")]
    check(all(torch.equal(o, outs[0]) for o in outs),
          "dispatch: the op or the wrapper differs from the direct launch")
    check(torch.equal(calls["clone Library op"](), small)
          and torch.equal(calls["clone custom_op"](), small),
          "dispatch: a clone op differs from its input")
    device_us = cuda_ms(torch, calls["direct"], DISPATCH_CALLS) * 1e3
    reads = {k: [] for k in calls}
    for k in [*calls, *reversed(calls)]:
        fn = calls[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        reads[k].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
        torch.cuda.synchronize()
    D.reset_launch_counts()
    return reads, device_us


def export_phase(torch, dev, cp16, cp_net, cp_in, qnet):
    """Phase 17: the full-width bf16 CenterPoint encoder (phase 6's
    calibrated buffers) and the int8 encoder of phase 8, each exported
    (``spconv_tpu_torch.export``, a ``bev`` request of seed 0's buffers),
    saved to bytes, reloaded in this process and in a fresh interpreter
    (``EXPORT_CHILD``).  Every request of the exported and the reloaded
    program bit-equal to eager and launching exactly eager's kernels, kernel
    by kernel (the child's on seed 0 too); the blob's bytes; host ms of
    eager against ``ExportedProgram.module()`` over the same window, in
    turns; and the dispatch µs of one op call against the direct launch
    (:func:`dispatch_us`).  Returns ``{net: {"eager": host ms,
    "exported": host ms}}`` of the requests timed in turns."""
    import gc
    import io

    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.export import export_inference
    from spconv_tpu_torch.ops import dg_conv as D

    tmp = Path(tempfile.mkdtemp(prefix="spconv_tpu_export_"))
    launches, host_ms = {}, {}
    try:
        for name, net, inputs, want in (
                ("bf16", cp_net, cp16, CP_LAUNCHES),
                ("int8", qnet, cp_in, CP_INT8_LAUNCHES)):
            x0 = inputs[0]

            def request(f, i, net=net, x0=x0):
                return net.bev(SparseConvTensor(
                    f, i, x0.spatial_shape, x0.batch_size, keys_sorted=True))

            args = {s: (inputs[s].features, inputs[s].indices)
                    for s in REQUEST_SEEDS}
            t0 = time.perf_counter()
            program = export_inference(request, args[0])
            t_export = time.perf_counter() - t0
            buf = io.BytesIO()
            t0 = time.perf_counter()
            torch.export.save(program, buf)
            blob = buf.getvalue()
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            reloaded = torch.export.load(io.BytesIO(blob)).module()
            t_load = time.perf_counter() - t0
            exported = program.module()
            nodes = sum(1 for n in program.graph.nodes
                        if str(n.target).startswith("spconv_tpu_torch."))
            # the tensors the program holds: the net's weights and
            # buffers, lifted (the request closes over the net)
            held = sum(t.numel() * t.element_size() for t in (
                *program.constants.values(), *program.state_dict.values())
                if isinstance(t, torch.Tensor))
            runs = {"eager": request, "exported": exported,
                    "reloaded": reloaded}
            eager0 = None
            with torch.no_grad():
                for seed in REQUEST_SEEDS:
                    outs, counts = {}, {}
                    for how, fn in runs.items():
                        torch.cuda.synchronize()
                        D.reset_launch_counts()
                        outs[how] = fn(*args[seed])
                        torch.cuda.synchronize()
                        counts[how] = dict(D.launch_counts)
                    check(counts["eager"] == expected(D, **want),
                          f"export {name} request {seed}: eager launches "
                          f"{counts['eager']}, expected {want}")
                    for how in ("exported", "reloaded"):
                        check(counts[how] == counts["eager"],
                              f"export {name} request {seed}: {how} "
                              f"launches {counts[how]} != eager's "
                              f"{counts['eager']}")
                        check(outs[how].shape == outs["eager"].shape
                              and torch.equal(outs[how], outs["eager"]),
                              f"export {name} request {seed}: {how} output "
                              "differs from eager")
                    check(bool(torch.isfinite(outs["eager"]).all())
                          and bool(outs["eager"].any()),
                          f"export {name} request {seed}: bev not finite "
                          "or all 0")
                    if eager0 is None:
                        eager0 = outs["eager"]
                launches[name] = counts["eager"]
                # host ms a request, in turns over the same window; the
                # tracing's garbage collected first (a full collection of
                # it takes ~0.2 s, which fell on the first request timed)
                gc.collect()
                ms = {"eager": [], "exported": []}
                for how in ("eager", "exported", "exported", "eager"):
                    for seed in REQUEST_SEEDS:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        runs[how](*args[seed])
                        torch.cuda.synchronize()
                        ms[how].append((time.perf_counter() - t0) * 1e3)
            host_ms[name] = ms
            # a fresh interpreter: the blob and seed 0's inputs from files
            blob_path = tmp / f"cp_{name}.pt2"
            blob_path.write_bytes(blob)
            torch.save({"f": args[0][0].cpu(), "i": args[0][1].cpu()},
                       tmp / f"{name}_in.pt")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-c", EXPORT_CHILD, str(blob_path),
                 str(tmp / f"{name}_in.pt"), str(tmp / f"{name}_out.pt")],
                capture_output=True, text=True, timeout=600, cwd=str(ROOT))
            t_child = time.perf_counter() - t0
            check(r.returncode == 0, f"export {name}: the fresh interpreter "
                  f"failed ({r.returncode}):\n{r.stderr[-3000:]}")
            child = torch.load(tmp / f"{name}_out.pt")
            check(torch.equal(child["out"], eager0.cpu()),
                  f"export {name}: the fresh interpreter's output differs "
                  "from eager")
            check(child["counts"] == launches[name],
                  f"export {name}: the fresh interpreter launched "
                  f"{child['counts']}, eager {launches[name]}")
            print(f"export {name}: {len(blob)} B blob ({held} B of tensors), "
                  f"{nodes} kernel op "
                  f"nodes of {len(program.graph.nodes)}; export "
                  f"{t_export:.2f} s, save {t_save:.2f} s, load "
                  f"{t_load:.2f} s, the fresh interpreter {t_child:.2f} s; "
                  f"{len(REQUEST_SEEDS)} requests exported and reloaded "
                  "bit-equal to eager with its launches "
                  f"{ {k: v for k, v in launches[name].items() if v} } "
                  "(the fresh interpreter's too); host ms a request, in "
                  f"turns: eager {[round(m, 3) for m in ms['eager']]}, "
                  "exported "
                  f"{[round(m, 3) for m in ms['exported']]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reads, device_us = dispatch_us(torch, dev)
    print("dispatch: host us a call (B2: bf16, [27, "
          f"{DISPATCH_ROWS}] table, 16 -> 16, {device_us:.3f} us on the "
          f"card; {DISPATCH_CALLS} calls a reading, in turns): " + "; ".join(
              f"{k} {[round(v, 3) for v in r]}" for k, r in reads.items()))
    return host_ms


# ---- phase 18: the C++ loader (libtorch, no Python) -----------------------

# requests a loader run serves: the first LOADER_CHECKED each timed and
# reported, the LOADER_TIMED after them timed for the median; every one's
# outputs are checked against the goldens and its launches against the
# first's
LOADER_CHECKED = 3
LOADER_TIMED = 20


def cpp_loader_phase(torch, dev, cp16, cp_net, cp_in, qnet, cpp_built,
                     export_ms):
    """Phase 18: the bf16 and int8 CenterPoint encoders of phase 17 (a
    ``bev`` request of seed 0's buffers) and ``examples.export_model``'s
    native net at its ``NBUF``, each packaged ahead of time
    (``export.package``: an AOTInductor package, with its manifest, inputs
    and eager outputs, ``export_model.write_artifact``) and served by the
    C++ loader (``cpp_built``: the CUDA op library and the loader, built in
    phase 2) in a process with no Python: ``LOADER_OK``; indices, int8 and
    f32 outputs bit-equal to eager on the card, bf16 within its gate with
    the difference printed; the loader's launches a request equal to
    eager's.  Prints each package's bytes and compile s, the loader's load
    s, its first request's ms and its host ms a request beside phase 17's
    eager and exported-module ms (``export_ms``), and the device busy a
    request of eager against the package loaded in this process."""
    from torch._inductor import aoti_load_package

    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.examples import export_model as EM
    from spconv_tpu_torch.ops import dg_conv as D

    (ops_lib, ops_s, _), (loader, loader_s, _) = cpp_built
    print(f"C++ loader: op library {ops_lib.name} ({ops_s:.1f} s of g++), "
          f"loader {loader.name} ({loader_s:.1f} s), built in phase 2 beside "
          "the kernels")
    r = subprocess.run(["ldd", str(loader)], capture_output=True, text=True,
                       timeout=60)
    check(r.returncode == 0 and "libtorch_cuda" in r.stdout
          and "libpython" not in r.stdout,
          f"ldd of the loader: libpython linked, or no libtorch_cuda:\n"
          f"{r.stdout}{r.stderr}")
    tmp = Path(tempfile.mkdtemp(prefix="spconv_tpu_loader_"))
    programs = {}
    try:
        for name, net, inputs, want in (
                ("bf16", cp_net, cp16, CP_LAUNCHES),
                ("int8", qnet, cp_in, CP_INT8_LAUNCHES)):
            x0 = inputs[0]

            def request(f, i, net=net, x0=x0):
                return net.bev(SparseConvTensor(
                    f, i, x0.spatial_shape, x0.batch_size, keys_sorted=True))

            programs[name] = (request, (x0.features, x0.indices), want)
        net = EM.build_net(dev, EM.NBUF)
        feats, inds, shape = EM.load_input(0, EM.NBUF)

        def native(f, i):
            y = net(SparseConvTensor(f, i, shape, 1, keys_sorted=True))
            return y.features, y.indices

        programs["native"] = (native, (torch.from_numpy(feats).to(dev),
                                       torch.from_numpy(inds).to(dev)),
                              dict(dg_fwd_native=3))
        for name, (fn, args, want) in programs.items():
            with torch.no_grad():
                torch.cuda.synchronize()
                D.reset_launch_counts()
                fn(*args)
                torch.cuda.synchronize()
            eager = {k: v for k, v in D.launch_counts.items() if v}
            check(eager == want, f"loader {name}: eager launches {eager}, "
                  f"expected {want}")
            art = tmp / name
            res = EM.write_artifact(art, fn, args, package=True)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            run = EM.run_loader(ops_lib, loader, art,
                                LOADER_CHECKED + LOADER_TIMED)
            wall = time.perf_counter() - t0
            check(run["rc"] == 0 and run["ok"],
                  f"loader {name}: exit {run['rc']}\n{run['stdout'][-3000:]}"
                  f"\n{run['stderr'][-3000:]}")
            check(run["launches"] == eager,
                  f"loader {name}: launches {run['launches']} a request, "
                  f"eager {eager}")
            check(len(run["outputs"]) == len(res["outputs"]),
                  f"loader {name}: {len(run['outputs'])} outputs")
            for o, ref in zip(run["outputs"], res["outputs"]):
                check(o["ok"] and (o["bitequal"]
                                   or ref.dtype == torch.bfloat16),
                      f"loader {name}: {o['dtype']} output not bit-equal "
                      f"to eager (max|d| {o['max_abs_diff']}, gate "
                      f"{o['gate']})")
                check(o["max_abs_ref"] > 0, f"loader {name}: output all 0")
            # device busy a request: eager against the same package loaded
            # in this process (its kernel nodes call the Python ops, which
            # launch the same kernels)
            compiled = aoti_load_package(str(art / "package.pt2"))
            with torch.no_grad():
                outs = compiled(*args)  # a tensor where fn returns one
                if isinstance(outs, torch.Tensor):
                    outs = (outs,)
                check(len(outs) == len(res["outputs"])
                      and all(torch.equal(o, r) for o, r in
                              zip(outs, res["outputs"])),
                      f"loader {name}: the package in this process differs "
                      "from eager")
                busy = {how: device_busy(torch, lambda f=f: f(*args), 3)
                        for how, f in (("eager", fn), ("package", compiled))}
            del compiled, outs
            ms = run["request_ms"]
            timed = sorted(ms[LOADER_CHECKED:])
            size = (art / "package.pt2").stat().st_size
            eager_ms = export_ms.get(name, {})
            print(f"loader {name}: package.pt2 {size} B compiled in "
                  f"{res['package_s']:.2f} s; the loader process "
                  f"{wall:.2f} s, load {run['load_s']:.3f} s, "
                  f"{LOADER_CHECKED + LOADER_TIMED} requests each checked "
                  f"against eager ("
                  + "; ".join(f"{o['dtype']} [{o['dims']}] max|d| "
                              f"{o['max_abs_diff']} of max|ref| "
                              f"{o['max_abs_ref']}, bit-equal "
                              f"{o['bitequal']}" for o in run["outputs"])
                  + f"), launches a request {run['launches']} = eager's; "
                  f"host ms: first request {ms[0]:.3f}, checked "
                  f"{[round(m, 3) for m in ms[:LOADER_CHECKED]]}, then "
                  f"{LOADER_TIMED} timed median "
                  f"{timed[len(timed) // 2]:.3f} (min {timed[0]:.3f}, max "
                  f"{timed[-1]:.3f}); phase 17 eager "
                  f"{[round(m, 3) for m in eager_ms.get('eager', [])]}, "
                  "exported module "
                  f"{[round(m, 3) for m in eager_ms.get('exported', [])]}; "
                  "device busy a request (3 in a profiler window): " + ", ".join(
                      f"{how} {b[1] / 3:.3f} ms of {b[2] // 3} device ops"
                      if b[1] else f"{how} not measured (no device time)"
                      for how, b in busy.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    if not (ROOT / "spconv_tpu_torch" / "__init__.py").is_file():
        fail(f"no spconv_tpu_torch package beside {Path(__file__).name}; "
             "run it from the root of a checkout")
    # the tuner's cache: a fresh directory, set before the port is
    # imported, so that no winner of an earlier run changes a route (phases
    # 1-15 run with it empty); no tuning or algorithm forced from outside
    tune_root = Path(tempfile.mkdtemp(prefix="spconv_tpu_tune_"))
    os.environ["SPCONV_TPU_TUNE_CACHE"] = str(tune_root)
    for flag in ("SPCONV_TPU_TUNE", "SPCONV_TPU_ALGO"):
        os.environ.pop(flag, None)
    try:
        run(tune_root)
    finally:
        shutil.rmtree(tune_root, ignore_errors=True)


def run(tune_root):
    """Phases 1-19 (see the module docstring), the tuner's cache under
    ``tune_root``."""
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
    from concurrent.futures import ThreadPoolExecutor

    from spconv_tpu_torch._build import (BUILD_DIR, build_library,
                                         build_loader, build_ops_library,
                                         load_library)
    from spconv_tpu_torch.tools import ablation as AB
    from spconv_tpu_torch.tools import b7_ablation as BA
    from spconv_tpu_torch.tools import join_gather_tiles as JG
    from spconv_tpu_torch.tools import table_count as TCN
    from spconv_tpu_torch.tools import wgrad_ablation as WA

    # beside the library: the bf16 wgrad's and B7's counting builds (their
    # MMAs counted on the card, tools/wgrad_ablation.py's and
    # tools/b7_ablation.py's COUNT), B1's (its windows that did not fit
    # its pool whole, tools/table_count.py's COUNT) and the probes with
    # the parent's rank kernel (tools/join_gather_tiles.py's PARENT_RANK,
    # timed beside the rank in phase 12)
    # and phase 18's C++ op library and loader (g++ beside nvcc)
    with ThreadPoolExecutor(6) as pool:
        cpp_builds = [pool.submit(build_ops_library, True),
                      pool.submit(build_loader, True)]
        rank_parent_build = pool.submit(AB.build, "probes.cu",
                                        (JG.PARENT_RANK,), JG.RANK_ARGTYPES,
                                        BUILD_DIR / "rank_parent")
        count_build = pool.submit(AB.build, "dg_wgrad.cu", (WA.COUNT,),
                                  WA.COUNT_ARGTYPES,
                                  BUILD_DIR / "wgrad_count")
        b7_count_build = pool.submit(AB.build, "dg_fwd_q.cu", (BA.COUNT,),
                                     BA.COUNT_ARGTYPES,
                                     BUILD_DIR / "b7_count")
        table_count_build = pool.submit(AB.build, "dg_pos.cu", (TCN.COUNT,),
                                        TCN.COUNT_ARGTYPES,
                                        BUILD_DIR / "table_count")
        path, secs, log = build_library()
        load_library()
        count_lib = count_build.result()[WA.COUNT[0]]
        b7_count_lib = b7_count_build.result()[BA.COUNT[0]]
        table_count_lib = table_count_build.result()[TCN.COUNT[0]]
        rank_parent_lib = rank_parent_build.result()[JG.PARENT_RANK[0]]
        cpp_built = [b.result() for b in cpp_builds]
    print(f"build: {path.name} in {secs:.2f} s, the wgrad, B7 and B1 "
          "counting builds and the parent rank's")

    from spconv_tpu_torch.benchmark import basic as B
    from spconv_tpu_torch.core import SparseConvTensor
    from spconv_tpu_torch.modules import SparseMaxPool3d, SubMConv3d
    from spconv_tpu_torch.ops import coords as C
    from spconv_tpu_torch.ops import dg_conv as D

    # ptxas's report of every kernel: B2's, wgrad's and B7's variants with
    # the dynamic shared memory of their launch (b2_smem_bytes,
    # wgrad_smem_bytes, b7_smem_bytes), printed; a wgrad or B7 variant that
    # spills fails
    tiles = {t: i for i, t in enumerate(D.B2_TILES)}
    w_tiles = {t: i for i, t in enumerate(D.WGRAD_TILES)}
    q_tiles = {(bm, bn, bk): i for i, (bm, bn, bk) in enumerate(D.B7_TILES)}
    w_seen = q_seen = b1_seen = b6_seen = 0
    spilled = []
    report = ptxas_report(log)
    for name, lines in report:
        m = re.search(r"dg_fwd_bf16_kernel<[^<]*Tile<(\d+), (\d+), \d+, \d+, "
                      r"(\d+)>, (true|false)", name)
        w = wgrad_tile(name)
        q = b7_tile(name)
        spills = [int(v) for line in lines
                  for v in re.findall(r"(\d+) bytes spill", line)]
        dyn = ""
        if m:
            tile = tiles[(int(m[1]), int(m[2]), int(m[3]))]
            dyn = (f"; {D.b2_smem_bytes(tile, m[4] == 'true')} bytes dynamic"
                   " smem")
        if w:
            tile = w_tiles[w]
            dyn = f"; {D.wgrad_smem_bytes(tile)} bytes dynamic smem"
            w_seen += 1
            if any(spills):
                spilled.append(f"wgrad variant {name}: {lines}")
        if q:
            (bm, bn, _, _, bk), vec, packed = q
            tile = q_tiles[(bm, bn, bk)]
            dyn = (f"; {D.b7_smem_bytes(tile)} bytes dynamic smem (B7 tile "
                   f"{tile}, vec {vec}, packed {packed})")
            q_seen += 1
            if any(spills):
                spilled.append(f"B7 variant {name}: {lines}")
        if re.search(r"dg_pos_(direct_)?kernel|sk_pool_kernel", name):
            if "dg_pos" in name:
                b1_seen += 1
            else:
                b6_seen += 1
            if any(spills):
                spilled.append(f"B1 / B6 kernel {name}: {lines}")
        print(f"  ptxas {name}: {'; '.join(lines)}{dyn}")
    check(not spilled, "variants spill: " + "; ".join(spilled))
    # B1: (windowed, direct) x ndim 1-4 x (affine, divide); B6: ndim 1-4
    # x dtype x vec
    check(b1_seen == 16 and b6_seen == 16,
          f"ptxas reported {b1_seen} B1 and {b6_seen} B6 kernels, not 16 "
          "and 16")
    # 6 tiles x vec x (table, search), their names demangled or not
    check(w_seen == 4 * len(D.WGRAD_TILES),
          f"ptxas reported {w_seen} wgrad bf16 variants, not "
          f"{4 * len(D.WGRAD_TILES)}")
    # B7: 4 tiles x vec x packed x (table, search)
    check(q_seen == 8 * len(D.B7_TILES),
          f"ptxas reported {q_seen} B7 variants, not {8 * len(D.B7_TILES)}")

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
        err[kern] = max(err.get(kern, 0.0), diff)
        rel[kern] = max(rel.get(kern, 0.0), r)
    # kernel, plain and bound ms summed over one bf16 forward (dg_pos,
    # dg_fwd) or one bf16 training step's backward (the rest)
    tot = {k: Tally() for k in names}
    per_layer = {}  # (layer, kernel) -> (bf16 kernel ms, plain ms, bound)

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
                                 2), gemm_bound(dout, w, rev, c)),
            "dg_wgrad": (cuda_ms(torch, lambda: D.dg_wgrad(x, dout, rev), 10),
                         cuda_ms(torch, lambda: D.dg_wgrad_plain(x, dout, rev),
                                 2), wgrad_bound(x, dout, rev)),
        }
        if x.dtype == torch.bfloat16:
            for kern, t in times.items():
                per_layer[(layer, kern)] = t
                if kern == "dg_dgrad" and layer == 0:
                    continue  # the input features need no gradient
                tot[kern].add(*t)
        return d_rel, w_rel, times

    tables, revs = [], []
    print("stage  N_buf  active  kernel            dtype      C    K   "
          "max|d|/max|ref|  kernel_ms  plain_ms  bound_ms")
    for s, g in enumerate(geo):
        n, act = g.indices.shape[0], int(g.num_voxels)
        keys, _ = C.linearize(g.indices, g.spatial_shape, 1)
        geom = dict(ksize=KSIZE, dilation=DIL, spatial_shape=g.spatial_shape,
                    batch_size=1)
        pk = D.build_dg_pos(keys, **geom)
        rev = D.build_dg_pos(keys, reverse=True, **geom)
        tables.append(pk)
        revs.append(rev)
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
            bnd = table_bound(n, n, 27)
            tot[kern].add(km, pm, bnd)
            print(f"{s:5d} {n:6d} {act:7d}  {kern:17s} int32      -    - "
                  f"  {float(d):15.3e}  {km:9.4f}  {pm:8.4f}  {bnd[0]:.4f}")
        check(torch.equal(rev, pk.flip(0)),
              f"stage {s}: the reversed table is not the forward one "
              "flipped on its offset axis")
        for layer in (2 * s, 2 * s + 1):
            c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
            for dt, (x, w, r) in zip(DTYPES, fwd_cases(g, pk, c, k)):
                km = cuda_ms(torch, lambda: D.dg_fwd(x, w, pk), 10)
                pm = cuda_ms(torch, lambda: D.dg_fwd_plain(x, w, pk), 3)
                dtn = str(dt)[6:]
                bnd = gemm_bound(x, w, pk, k)
                if dt == torch.bfloat16:
                    per_layer[(layer, "dg_fwd")] = (km, pm, bnd)
                    tot["dg_fwd"].add(km, pm, bnd)
                print(f"{s:5d} {n:6d} {act:7d}  dg_fwd   conv{layer:<3d}   "
                      f"{dtn:9s} {c:4d} {k:4d}  {r:15.3e}  "
                      f"{km:9.4f}  {pm:8.4f}  {bnd[0]:.4f}")
                d_rel, w_rel, times = bwd_case(g, rev, x, w, layer)
                for kern, rel_b in (("dg_dgrad", d_rel), ("dg_wgrad", w_rel)):
                    km, pm, bnd = times[kern]
                    print(f"{s:5d} {n:6d} {act:7d}  {kern} conv{layer:<3d}   "
                          f"{dtn:9s} {c:4d} {k:4d}  {rel_b:15.3e}  "
                          f"{km:9.4f}  {pm:8.4f}  {bnd[0]:.4f}")
    # every other width at the stage-0 shape too (checked, not timed)
    for layer in range(2, 14):
        c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
        rels = [r for _, _, r in fwd_cases(geo[0], tables[0], c, k)]
        print(f"    0 stage-0 shape  dg_fwd conv{layer} widths C={c} K={k}: "
              f"max|d|/max|ref| f32 {rels[0]:.3e}, bf16 {rels[1]:.3e}")
    # one width of each B2 bf16 variant at the stage-0 shape, timed
    n0_pairs = int((tables[0] >= 0).sum())
    b2_variants = {}
    print("B2 bf16 variants at the stage-0 shape: C K tile grid vec "
          "kernel_ms bound_ms matched-pair TFLOP/s")
    for c, k in B2_WIDTHS:
        x, w, _ = list(fwd_cases(geo[0], tables[0], c, k))[-1]
        v = D.b2_variant(x.shape[0], c, k, aligned=x.data_ptr() % 16 == 0)
        km = cuda_ms(torch, lambda: D.dg_fwd(x, w, tables[0]), 10)
        bnd = gemm_bound(x, w, tables[0], k)
        b2_variants[f"C{c}_K{k}"] = dict(tile=[v.bm, v.bn], grid=list(v.grid),
                                         vec=v.vec, ms=km, bound_ms=bnd[0])
        print(f"  {c:4d} {k:4d} {v.bm}x{v.bn} {v.grid} {v.vec}  {km:9.4f}  "
              f"{bnd[0]:.4f}  {2 * n0_pairs * c * k / km / 1e9:.1f}")
    # dgrad reads W[k]^T inside the kernel: one call is one device op
    dout = (torch.randn((x.shape[0], 64), device=dev, generator=gen)
            * geo[0].valid_mask[:, None]).bfloat16()
    w = torch.randn((27, 64, 64), device=dev, generator=gen).bfloat16()
    dgrad_ops = counted_ops(
        torch, lambda: D.dg_dgrad(dout, w, revs[0]), D.launch_counts,
        {"dg_dgrad": 1},
        lambda ops: None if len(ops) == 1 and b2_mode(ops[0]) == "dgrad"
        else f"{ops}, not one B2 launch", "a bf16 dg_dgrad call")
    print(f"bf16 dg_dgrad call: one device op, {dgrad_ops[0]}")
    # one width of each bf16 wgrad variant at the stage-0 shape, timed, and
    # the MMA rows it issues per matched pair, counted on the card by the
    # counting build (at most WGRAD_MMA_ROWS, and as many as wgrad_mma_rows
    # finds in the table: whole 16-row slices of listed rows)
    wg_pairs = int((revs[0] >= 0).sum())
    wgrad_variants = {}
    print(f"wgrad bf16 variants at the stage-0 shape ({wg_pairs} matched "
          "pairs): C K tile grid vec kernel_ms bound_ms matched-pair "
          "TFLOP/s, MMA rows per matched pair (counted on the card)")
    for c, k in WGRAD_WIDTHS:
        x, _, _ = list(fwd_cases(geo[0], tables[0], c, k))[-1]
        dout = (torch.randn((x.shape[0], k), device=dev, generator=gen)
                * geo[0].valid_mask[:, None]).bfloat16()
        v = D.wgrad_variant(x.shape[0], c, k, aligned=x.data_ptr() % 16 == 0)
        dw = D.dg_wgrad(x, dout, revs[0])
        _, r = rel_err(torch, dw, D.dg_wgrad_plain(x, dout, revs[0]))
        check(r <= WGRAD_TOL["bfloat16"] and torch.equal(
            dw, D.dg_wgrad(x, dout, revs[0])),
            f"dg_wgrad C={c} K={k} at stage 0: {r:.3e} or repeats differ")
        km = cuda_ms(torch, lambda: D.dg_wgrad(x, dout, revs[0]), 10)
        bnd = wgrad_bound(x, dout, revs[0])
        rows = WA.issued_mma_rows(count_lib, x, dout, revs[0])
        listed = D.wgrad_mma_rows(revs[0], c, k)[0]
        check(rows <= WGRAD_MMA_ROWS * wg_pairs and rows == listed,
              f"bf16 wgrad C={c} K={k} issues {rows / wg_pairs:.4f} MMA "
              f"rows per matched pair at stage 0 (at most {WGRAD_MMA_ROWS}; "
              f"{listed / wg_pairs:.4f} in whole slices of listed rows)")
        wgrad_variants[f"C{c}_K{k}"] = dict(
            tile=[v.bm, v.bn], grid=list(v.grid), vec=v.vec, ms=km,
            bound_ms=bnd[0], mma_rows_per_pair=rows / wg_pairs)
        print(f"  {c:4d} {k:4d} {v.bm}x{v.bn} {v.grid} {v.vec}  {km:9.4f}  "
              f"{bnd[0]:.4f}  {2 * wg_pairs * c * k / km / 1e9:.1f}  "
              f"{rows / wg_pairs:.4f}")
    # the f32 partials of a step, from the split rule (a host count)
    part_bytes = 0
    for layer in range(14):
        g = geo[layer // 2]
        c, k = B.CHANNELS[layer], B.CHANNELS[layer + 1]
        splits = D.wgrad_splits(g.indices.shape[0], 27, c, k)
        part_bytes += 4 * 27 * c * k * splits if splits > 1 else 0
    print(f"bf16 wgrad f32 partials a BenchNet step, counted on the host "
          f"from wgrad_splits: {part_bytes} bytes written, read once by the "
          "reduce")
    print(f"per bf16 forward: dg_pos {tot['dg_pos']}, dg_fwd "
          f"{tot['dg_fwd']}")
    n_edge = edge_tables(torch, dev, "subm")
    print(f"B1 subm tables at the edge inputs: {n_edge} bit-equal to plain")
    fallbacks = table_fallbacks(torch, dev, geo, table_count_lib)
    print(f"B1 windows that did not fit whole, their searches ending in "
          f"global memory (counted on the card, equal to the host count, "
          f"tables bit-equal): {fallbacks}")
    print(f"per bf16 training step, backward: dg_pos_rev "
          f"{tot['dg_pos_rev']}, dg_dgrad {tot['dg_dgrad']}, dg_wgrad "
          f"{tot['dg_wgrad']}")

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
    cp_tot = {k: Tally() for k in ("cp_dg_pos", "cp_dg_fwd")
              + strided_names}
    # (layer, C, K, times per request, bf16 ms, plain ms, bound)
    cp_layer_ms = []

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
            bnd = gemm_bound(x, w, pos, k)
            print(f"  cp {layer:10s} {kern:14s} {dtn:9s} {c:4d} {k:4d} "
                  f"N_in {x.shape[0]:6d} N_out {pos.shape[1]:6d}  "
                  f"{r:12.3e}  {km:9.4f}  {pm:8.4f}  {bnd[0]:.4f}")
            if dt == torch.bfloat16:
                cp_layer_ms.append((layer, c, k, mult, km, pm, bnd))
                tot_key = "cp_dg_fwd" if kern == "dg_fwd" else kern
                cp_tot[tot_key].add(km, pm, bnd, mult)

    def cp_table(kern, build, plain, layer, table_rows):
        """A match-table kernel against plain (exact), both timed."""
        got, want = build(), plain()
        d = (got.long() - want.long()).abs().max().item() if got.numel() \
            else 0
        note("dg_pos" if kern == "cp_dg_pos" else kern, float(d), float(d))
        check(d == 0, f"{kern} {layer} differs from plain")
        km, pm = cuda_ms(torch, build, 20), cuda_ms(torch, plain, 3)
        bnd = table_bound(got.shape[1], table_rows, got.shape[0])
        cp_tot[kern].add(km, pm, bnd)
        print(f"  cp {layer:10s} {kern:14s} int32     kv {got.shape[0]:3d} "
              f"N_out {got.shape[1]:6d}  exact  {km:9.4f}  {pm:8.4f}  "
              f"{bnd[0]:.4f}")
        return got

    print("CenterPoint layers: layer kernel dtype C K N_in N_out "
          "max|d|/max|ref| kernel_ms plain_ms bound_ms")
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
                       lambda: D.dg_pos_plain(keys, **geom), f"subm{si}",
                       keys.shape[0])
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
            key, rec.in_keys.shape[0])
        cp_gemm("dg_fwd_strided",
                lambda x, w, pos: D.dg_fwd(x, w, pos, "strided"),
                D.dg_fwd_plain,
                cp_rec[f"__dgreg_in__{key}"][:, 0] >= 0,
                rec.out_indices[:, 0] >= 0, pos, c, k, key, 1)
    print("per bf16 CenterPoint request: " + ", ".join(
        f"{k} {v}" for k, v in cp_tot.items()))
    n_edge = edge_tables(torch, dev, "affine")
    print(f"B1 affine tables at the edge inputs: {n_edge} bit-equal to "
          "plain")

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
    # a profiler window of one step: B2's device launches by mode, and the
    # ops beside each dgrad (no weight-transpose copy: the kernel reads W^T)
    # (the forward and dgrad launches counted across the same step; a
    # window that dropped a record is retaken)
    def b2_window(ops):
        modes = [b2_mode(o) for o in ops]
        if modes.count("fwd") == 14 and modes.count("dgrad") == 13:
            return None
        return (f"{modes.count('fwd')} forward and {modes.count('dgrad')} "
                "dgrad B2 launches")

    ops = counted_ops(torch, lambda: B.train_step(net, xs[0], 0.0),
                      D.launch_counts, {"dg_fwd": 14, "dg_dgrad": 13},
                      b2_window, "a train step")
    modes = [b2_mode(o) for o in ops]
    beside_dgrad = sorted({ops[j][:160] for i, m in enumerate(modes)
                           if m == "dgrad" for j in (i - 1, i + 1)
                           if 0 <= j < len(ops)})
    check(not any("copy" in o for o in beside_dgrad),
          f"a copy runs beside a dgrad: {beside_dgrad}")
    print(f"train step profiler window: {len(ops)} device ops, 14 forward "
          f"and 13 dgrad B2 launches; no copy beside a dgrad, the ops "
          f"beside one: {beside_dgrad}")

    # the f32 net: grads through the kernels vs through the plain backward
    # (gated) and the plain forward and backward (printed)
    x32 = B.make_bench_input(*scans[0], device=dev)
    cmp = [step_vs_plain(
        torch, D, [B.BenchNet(SHAPE, dtype=torch.float32, pool_bounds=bounds,
                              device=dev, seed=0) for _ in range(2)],
        lambda n: zero_lr_step(B, n, x32), "BenchNet", b2_forward,
        gate_grads=b2_forward) for b2_forward in (True, False)]
    losses = [cmp[0][0], cmp[0][1], cmp[1][1]]
    worst = [cmp[0][3], cmp[1][3]]
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
    check(sk_counts == dg_counts == expected(D, dg_pos=1, dg_pos_rev=1,
                                             dg_fwd=2, dg_dgrad=2,
                                             dg_wgrad=2),
          f"sk pair launches {sk_counts}, dg pair {dg_counts}")
    check(all(torch.equal(a, b) for a, b in zip(sk, dg)),
          "algo='sk' and algo='dg' differ on the stage-2 pair")
    # the same pair through the plain versions
    with plain_kernels(D):
        plain = pair_run("dg")[0]
    sk_err, sk_rel = {}, {}
    for kern, pairs in (("sk_fwd", [(sk[0], plain[0])]),
                        ("sk_bwd", list(zip(sk[1:], plain[1:])))):
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
    sk_ms = {"sk_fwd": Tally(), "sk_bwd": Tally()}
    for ly in sk_layers:
        sk_ms["sk_fwd"].add(*per_layer[(ly, "dg_fwd")])
        for kern in ("dg_dgrad", "dg_wgrad"):
            sk_ms["sk_bwd"].add(*per_layer[(ly, kern)])

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
        # no divide table: serving has no inverse conv and no gradient
        want = expected(D, **{k: len(REQUEST_SEEDS) * v
                              for k, v in CP_LAUNCHES.items()})
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
        check(dict(D.launch_counts) == expected(
            D, dg_pos_affine=1, dg_fwd_strided=1),
            f"sk downsample launches {D.launch_counts}")
        check(torch.equal(y_sk.features, down(stage0).features)
              and torch.equal(y_sk.indices, down(stage0).indices),
              "algo='sk' and algo='dg' differ on the first downsample")
    print(f"CenterPoint serve: bf16 bev {tuple(bev.shape)}, ms per request "
          f"{[round(m, 3) for m in cp_ms]}, launches {cp_launches}; "
          f"algo='sk' downsample bit-equal to 'dg'")

    # ---- 7. the U-Net --------------------------------------------------
    (u_tot, u_layer, u_serve, u_train,
     u_sk) = unet_phase(torch, dev, gen, cp_in, cp_rec, note)

    # ---- 8. the int8 CenterPoint encoder -------------------------------
    q_tot, q_serve, q_pair, b7_variants, qnet = int8_phase(
        torch, dev, gen, cp_in, cp16, cp_net, net32, cp_rec, note,
        b7_count_lib)

    # ---- 9. the sorted-key pool (B6) ----------------------------------
    (sk_pool, sk_seg_ms, sk_pool_err, sk_serve, sk_train,
     sk_avg) = sk_pool_phase(torch, dev, gen, scans, geo, bounds, served)

    # ---- 10. the table-free subm conv (S1-S4) -------------------------
    (s_tot, s_table, s_serve, s_train, s_q,
     run_int8) = search_phase(torch, dev, gen, scans, geo, bounds, served,
                              note)

    # ---- 11. the transposed conv: the USAGE.md decoder chain ----------
    (t_tot, t_serve, t_train,
     t_k3) = transposed_phase(torch, dev, cp_in, note)

    # ---- 12. the probe kernels (B9) -----------------------------------
    probes = probe_phase(torch, dev, rank_parent_lib)

    # ---- 13. the MNIST classifier and QAT flow, CenterPoint with BN ----
    qat_launches, bn_report = qat_phase(torch, dev, cp_in, cp_bounds,
                                        net32)
    print("phase 13 launches (each path counted on its own; the kernels "
          "line below keeps the counts of phases 3-12 and 14): " + "; ".join(
              f"{path} { {k: v for k, v in c.items() if v} }"
              for path, c in qat_launches.items()))

    # ---- 14. the native rulebook path ---------------------------------
    native_launches, nq_launches, nq_tally = native_phase(
        torch, dev, gen, scans, geo, bounds, served, tables, revs, cp_in,
        note)

    # ---- 15. raw point clouds: the voxelizer, points -> BEV, the rest --
    points_launches = points_phase(torch, dev, cp_in, cp_net, cp_bounds)
    print("phase 15 launches (each path counted on its own; the kernels "
          "line below keeps the counts of phases 3-12 and 14): " + "; ".join(
              f"{path} { {k: v for k, v in c.items() if v} }"
              for path, c in points_launches.items()))

    # phases 1-15 ran with the tuner's cache empty
    from spconv_tpu_torch import tuner as TU

    check(TU.CONV_TUNER.cache_dir == tune_root
          and not any(tune_root.iterdir()),
          f"phases 1-15 ran with a tuner cache in {TU.CONV_TUNER.cache_dir}"
          f" holding {[p.name for p in tune_root.iterdir()]}")
    print(f"phases 1-15 ran with the tuner's cache empty ({tune_root})")

    # ---- 16. the tuner, per-layer timing, data parallelism -----------
    parts = [time.perf_counter()]
    tune_phase(torch, dev, scans, bounds, served, geo, tune_root)
    parts.append(time.perf_counter())
    timing_phase(torch, dev, scans, bounds, served, cp_net, cp16, cp_ms)
    bn_kernel_cost(torch, dev, cp_in, cp_bounds)
    parts.append(time.perf_counter())
    dp_phase(torch, dev, cp_in, cp_bounds)
    parts.append(time.perf_counter())
    print(f"phase 16: {parts[-1] - parts[0]:.1f} s (the tuner "
          f"{parts[1] - parts[0]:.1f}, timing {parts[2] - parts[1]:.1f}, "
          f"data parallelism {parts[3] - parts[2]:.1f})")

    # ---- 17. export, save and reload ---------------------------------
    t0 = time.perf_counter()
    export_ms = export_phase(torch, dev, cp16, cp_net, cp_in, qnet)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # ---- 18. the C++ loader ------------------------------------------
    t0 = time.perf_counter()
    cpp_loader_phase(torch, dev, cp16, cp_net, cp_in, qnet, cpp_built,
                     export_ms)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # ---- 19. report --------------------------------------------------
    def row(name, source, replaces, launches, errs, t, library_ms=None,
            **extra):
        """One kernel's entry: ``errs`` = (max|d|, max|d|/max|ref|) against
        its plain version, ``t`` its Tally of times and bound,
        ``library_ms`` the one PyTorch call that computes the same function
        (None where none does)."""
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=errs[0], max_rel_err=errs[1], ms=t.ms,
                    plain_ms=t.plain_ms, bound_ms=t.bound_ms,
                    bound_by=t.bound_by, library_ms=library_ms, **extra)

    def errs(*keys):
        return max(err[k] for k in keys), max(rel[k] for k in keys)

    def layers(*keys):
        """A Tally of the U-Net's (layer, kernel) times in ``keys``."""
        t = Tally()
        for key in keys:
            t.add(*u_layer[key])
        return t

    down1 = Tally()
    down1.add(*next(r for r in cp_layer_ms if r[0] == "down1")[4:])
    pallas = "spconv_tpu/ops/pallas/"
    csrc = "spconv_tpu_torch/csrc/"
    up_last = f"dec_up.{len(UNET_CHANNELS) - 2}"  # the down0 inverse
    kernels = [
        row("dg_pos", csrc + "dg_pos.cu", pallas + "dg_conv.py:710",
            train_launches["dg_pos"], errs("dg_pos"), tot["dg_pos"],
            serve_launches=serve_launches["dg_pos"],
            windows_fallen_back=fallbacks),
        row("dg_pos_reverse", csrc + "dg_pos.cu",
            pallas + "dg_conv.py:710 (reverse=True, built at :1707)",
            train_launches["dg_pos_rev"], errs("dg_pos_rev"),
            tot["dg_pos_rev"]),
        row("dg_fwd", csrc + "dg_fwd.cu", pallas + "dg_conv.py:339",
            train_launches["dg_fwd"], errs("dg_fwd"), tot["dg_fwd"],
            serve_launches=serve_launches["dg_fwd"], variants=b2_variants),
        row("dg_dgrad", csrc + "dg_fwd.cu", pallas + "dg_conv.py:1307 (din)",
            train_launches["dg_dgrad"], errs("dg_dgrad"), tot["dg_dgrad"]),
        row("dg_wgrad", csrc + "dg_wgrad.cu",
            pallas + "dg_conv.py:1307 (dW)", train_launches["dg_wgrad"],
            errs("dg_wgrad"), tot["dg_wgrad"], variants=wgrad_variants),
        row("sk_fwd", csrc + "dg_fwd.cu", pallas + "sorted_conv.py:446",
            sk_fwd_launches, (sk_err["sk_fwd"], sk_rel["sk_fwd"]),
            sk_ms["sk_fwd"]),
        row("sk_bwd", csrc + "dg_fwd.cu + " + csrc + "dg_wgrad.cu",
            pallas + "sorted_conv.py:815",
            sk_counts["dg_dgrad"] + sk_counts["dg_wgrad"],
            (sk_err["sk_bwd"], sk_rel["sk_bwd"]), sk_ms["sk_bwd"]),
        row("dg_pos_affine", csrc + "dg_pos.cu",
            pallas + "dg_conv.py:302 (_vec_affine_probes of _dg_fwd_kernel "
            ":339, launched at :1020 by _dg_reg_conv)",
            cp_launches["dg_pos_affine"], errs("dg_pos_affine"),
            cp_tot["dg_pos_affine"]),
        row("dg_fwd_strided", csrc + "dg_fwd.cu",
            pallas + "dg_conv.py:339 (affine probes, launched at :1020 by "
            "_dg_reg_conv :1837)", cp_launches["dg_fwd_strided"],
            errs("dg_fwd_strided"), cp_tot["dg_fwd_strided"]),
        row("sk_fwd_strided", csrc + "dg_fwd.cu",
            pallas + "sorted_conv.py:446 (sk_regular_conv :1356)",
            sk_strided_launches, errs("dg_fwd_strided"), down1),
        row("dg_pos_divide", csrc + "dg_pos.cu",
            pallas + "dg_conv.py:315 (_vec_divide_probes of _dg_fwd_kernel "
            ":339 and _dg_bwd_kernel :1307, launched at :1020 and :1598)",
            u_train["dg_pos_divide"], errs("dg_pos_divide"),
            u_tot["dg_pos_divide"], serve_launches=u_serve["dg_pos_divide"]),
        row("dg_fwd_inverse", csrc + "dg_fwd.cu",
            pallas + "dg_conv.py:339 (divide probes, launched at :1020 by "
            "_dg_reg_conv :1850)", u_train["dg_fwd_inverse"],
            errs("dg_fwd_inverse"), u_tot["dg_fwd_inverse"],
            serve_launches=u_serve["dg_fwd_inverse"]),
        row("dg_dgrad_strided", csrc + "dg_fwd.cu",
            pallas + "dg_conv.py:1307 (din, divide probes, launched at "
            ":1598 by _dg_reg_conv_bwd :1874)", u_train["dg_dgrad_strided"],
            errs("dg_dgrad_strided"), u_tot["dg_dgrad_strided"]),
        row("dg_wgrad_strided", csrc + "dg_wgrad.cu",
            pallas + "dg_conv.py:1307 (dW, divide probes, launched at "
            ":1598 by _dg_reg_conv_bwd :1874)", u_train["dg_wgrad_strided"],
            errs("dg_wgrad_strided"), u_tot["dg_wgrad_strided"]),
        row("dg_dgrad_inverse", csrc + "dg_fwd.cu",
            pallas + "dg_conv.py:1307 (din, affine probes, launched at "
            ":1598 by _dg_reg_conv_bwd :1882)", u_train["dg_dgrad_inverse"],
            errs("dg_dgrad_inverse"), u_tot["dg_dgrad_inverse"]),
        row("dg_wgrad_inverse", csrc + "dg_wgrad.cu",
            pallas + "dg_conv.py:1307 (dW, affine probes, launched at "
            ":1598 by _dg_reg_conv_bwd :1882)", u_train["dg_wgrad_inverse"],
            errs("dg_wgrad_inverse"), u_tot["dg_wgrad_inverse"]),
        row("sk_fwd_inverse", csrc + "dg_pos.cu + " + csrc + "dg_fwd.cu",
            pallas + "sorted_conv.py:446 (sk_regular_conv :1356, "
            "inverse=True)", u_sk["dg_fwd_inverse"], errs("dg_fwd_inverse"),
            layers((up_last, "dg_fwd_inverse"))),
        row("sk_bwd_strided", csrc + "dg_fwd.cu + " + csrc + "dg_wgrad.cu",
            pallas + "sorted_conv.py:815 (_sk_reg_conv_bwd :1320)",
            u_sk["dg_dgrad_strided"] + u_sk["dg_wgrad_strided"],
            errs("dg_dgrad_strided", "dg_wgrad_strided"),
            layers(("enc_down.0", "dg_dgrad_strided"),
                   ("enc_down.0", "dg_wgrad_strided"))),
        row("sk_bwd_inverse", csrc + "dg_fwd.cu + " + csrc + "dg_wgrad.cu",
            pallas + "sorted_conv.py:815 (_sk_reg_conv_bwd :1320, "
            "inverse=True)",
            u_sk["dg_dgrad_inverse"] + u_sk["dg_wgrad_inverse"],
            errs("dg_dgrad_inverse", "dg_wgrad_inverse"),
            layers((up_last, "dg_dgrad_inverse"),
                   (up_last, "dg_wgrad_inverse"))),
        row("dg_fwd_q", csrc + "dg_fwd_q.cu",
            pallas + "dg_conv.py:339 (packmode q4, shift probes, posmode; "
            "launched at :1152 by dg_subm_conv_q :1162)",
            q_serve["dg_fwd_q"], errs("dg_fwd_q"), q_tot["dg_fwd_q"],
            variants=b7_variants),
        row("dg_fwd_q_strided", csrc + "dg_fwd_q.cu",
            pallas + "dg_conv.py:339 (packmode q4, affine probes; launched "
            "at :1152 by dg_regular_conv_q :1219)",
            q_serve["dg_fwd_q_strided"], errs("dg_fwd_q_strided"),
            q_tot["dg_fwd_q_strided"]),
        row("dg_fwd_q_inverse", csrc + "dg_fwd_q.cu",
            pallas + "dg_conv.py:339 (packmode q4, divide probes; launched "
            "at :1152 by dg_regular_conv_q :1219, inverse=True)",
            q_pair["dg_fwd_q_inverse"], errs("dg_fwd_q_inverse"),
            q_tot["dg_fwd_q_inverse"]),
        # B8 computes B7's subm function; its launches and times are B7's
        # subm path's
        row("sk_fwd_q", csrc + "dg_pos.cu + " + csrc + "dg_fwd_q.cu",
            pallas + "sorted_conv.py:573 (sk_subm_conv_q :704, launched at "
            ":805)", q_serve["dg_fwd_q"], errs("dg_fwd_q"),
            q_tot["dg_fwd_q"]),
        # no single PyTorch call searches the children: the yardstick is
        # the port's seg route (pool2_seg: a sort and a scatter) at the
        # same shapes, with its own output discovery
        row("sk_pool", csrc + "sk_pool.cu",
            pallas + "sorted_pool.py:92 (_sk_pool_kernel, mode max; "
            "launched at :309 by sk_pool2 :226, wrapped by sk_pool2_ad "
            ":320)", sk_train["sk_pool"], sk_pool_err["max"],
            sk_pool["max"], serve_launches=sk_serve["sk_pool"],
            seg_route_ms=sk_seg_ms["max"]),
        row("sk_pool_mean", csrc + "sk_pool.cu",
            pallas + "sorted_pool.py:92 (_sk_pool_kernel, mode mean; "
            "launched at :309)", sk_avg["sk_pool"], sk_pool_err["mean"],
            sk_pool["mean"], seg_route_ms=sk_seg_ms["mean"]),
        # the search mode: each row's table_path_ms is B1 + the table-mode
        # kernel on the same inputs, its yardstick
        row("dg_fwd_search", csrc + "dg_fwd.cu + " + csrc + "dg_search.cuh",
            pallas + "dg_conv.py:339 (_dg_fwd_kernel, posmode=False, shift "
            "probes; launched at :1020 by _dg_conv :1639)",
            s_train["dg_fwd_search"], errs("dg_fwd_search"),
            s_tot["dg_fwd_search"], serve_launches=s_serve["dg_fwd_search"],
            table_path_ms=s_table["dg_fwd_search"]),
        row("dg_dgrad_search", csrc + "dg_fwd.cu + " + csrc + "dg_search.cuh",
            pallas + "dg_conv.py:1307 (_dg_bwd_kernel din, posmode=False; "
            "launched at :1598 by _dg_conv_bwd :1661)",
            s_train["dg_dgrad_search"], errs("dg_dgrad_search"),
            s_tot["dg_dgrad_search"],
            table_path_ms=s_table["dg_dgrad_search"]),
        row("dg_wgrad_search", csrc + "dg_wgrad.cu + " + csrc
            + "dg_search.cuh",
            pallas + "dg_conv.py:1307 (_dg_bwd_kernel dW, posmode=False; "
            "launched at :1598 by _dg_conv_bwd :1661)",
            s_train["dg_wgrad_search"], errs("dg_wgrad_search"),
            s_tot["dg_wgrad_search"],
            table_path_ms=s_table["dg_wgrad_search"]),
        row("dg_fwd_q_search", csrc + "dg_fwd_q.cu + " + csrc
            + "dg_search.cuh",
            pallas + "dg_conv.py:339 (packmode q4, posmode=False; launched "
            "at :1152 by dg_subm_conv_q :1162 with pos=None)",
            s_q["dg_fwd_q_search"], errs("dg_fwd_q_search"),
            s_tot["dg_fwd_q_search"],
            table_path_ms=s_table["dg_fwd_q_search"], run_int8=run_int8),
        # the transposed conv: the inverse mode on swapped spaces
        # (spconv_tpu/modules/conv.py:816-826), timed at the chain's shape
        row("dg_pos_divide_transposed", csrc + "dg_pos.cu",
            pallas + "dg_conv.py:315 (_vec_divide_probes of _dg_fwd_kernel "
            ":339 on swapped spaces; launched at :1020 by _dg_reg_conv "
            ":1850 from modules/conv.py:819)",
            t_train["dg_pos_divide_transposed"],
            errs("dg_pos_divide_transposed"),
            t_tot["dg_pos_divide_transposed"],
            serve_launches=t_serve["dg_pos_divide_transposed"]),
        row("dg_fwd_transposed", csrc + "dg_fwd.cu",
            pallas + "dg_conv.py:339 (divide probes on swapped spaces; "
            "launched at :1020 by _dg_reg_conv :1850 from "
            "modules/conv.py:819)", t_train["dg_fwd_transposed"],
            errs("dg_fwd_transposed"), t_tot["dg_fwd_transposed"],
            serve_launches=t_serve["dg_fwd_transposed"]),
        row("dg_pos_affine_transposed", csrc + "dg_pos.cu",
            pallas + "dg_conv.py:302 (_vec_affine_probes of _dg_bwd_kernel "
            ":1307 on swapped spaces; launched at :1598 by _dg_reg_conv_bwd "
            ":1882)", t_train["dg_pos_affine_transposed"],
            errs("dg_pos_affine_transposed"),
            t_tot["dg_pos_affine_transposed"]),
        row("dg_dgrad_transposed", csrc + "dg_fwd.cu",
            pallas + "dg_conv.py:1307 (din, affine probes on swapped spaces; "
            "launched at :1598 by _dg_reg_conv_bwd :1882)",
            t_train["dg_dgrad_transposed"], errs("dg_dgrad_transposed"),
            t_tot["dg_dgrad_transposed"]),
        row("dg_wgrad_transposed", csrc + "dg_wgrad.cu",
            pallas + "dg_conv.py:1307 (dW, affine probes on swapped spaces; "
            "launched at :1598 by _dg_reg_conv_bwd :1882)",
            t_train["dg_wgrad_transposed"], errs("dg_wgrad_transposed"),
            t_tot["dg_wgrad_transposed"]),
        # the native rulebook path: the same kernels on the rulebooks'
        # tables, which phase 14 holds bit-equal to B1's at every BenchNet
        # stage, so their times are phase 3's on those tables; the JAX
        # native route they replace is XLA (take + einsum), not Pallas
        row("dg_fwd_native", csrc + "dg_fwd.cu",
            "spconv_tpu/ops/gather_gemm.py:75 (gather_mm, XLA; "
            "indice_conv :222)", native_launches["dg_fwd_native"],
            errs("dg_fwd_native"), tot["dg_fwd"]),
        row("dg_dgrad_native", csrc + "dg_fwd.cu",
            "spconv_tpu/ops/gather_gemm.py:113 (dgrad_gather_mm, XLA; "
            "_indice_conv_bwd :182)", native_launches["dg_dgrad_native"],
            errs("dg_dgrad_native"), tot["dg_dgrad"]),
        row("dg_wgrad_native", csrc + "dg_wgrad.cu",
            "spconv_tpu/ops/gather_gemm.py:149 (wgrad_gather_mm, XLA; "
            "_indice_conv_bwd :182)", native_launches["dg_wgrad_native"],
            errs("dg_wgrad_native"), tot["dg_wgrad"]),
        row("dg_fwd_q_native", csrc + "dg_fwd_q.cu",
            "spconv_tpu/quantization/quantize.py:91 (_int8_gather_mm, XLA; "
            "the native route :337-404)", nq_launches["dg_fwd_q_native"],
            errs("dg_fwd_q_native"), nq_tally),
    ]
    # the probe kernels (B9): each at its probe's shape, launch-bound
    probe_src = {
        "probe_copy_int8": "tools/probe_int8.py:14 (probe_dma.kern, "
                           "launched at :28)",
        "probe_copy_dma_align": "tools/probe_dma_align.py:16 (make.kern, "
                                "launched at :30)",
        "probe_copy_chunk": "tools/probe_dg.py:127 (kd, launched at :144)",
        "probe_transpose": "tools/probe_dg.py:113 (kt, launched at :25)",
        "probe_lane_gather": "tools/probe_dg.py:43 and :56 (k, ki, launched "
                             "at :25)",
        "probe_row_broadcast": "tools/probe_dg.py:83 (ks, launched at :25)",
        "probe_join_int8": "tools/probe_int8.py:47 (probe_matmul.kern, "
                           "launched at :66)",
        "probe_join_f32": "tools/probe_cast.py:48, :57, :64 (k_2d, k_3d, "
                          "k_2d_bcast, launched at :26)",
        "probe_rank": "tools/probe_dg.py:69 (kr, launched at :25)",
        "probe_gemm_s8": "tools/probe_int8.py:87 (probe_plain_matmul.kern, "
                         "launched at :91)",
        "probe_gemm_bf16": "tools/probe_dg.py:101 (kg, launched at :25)",
        "probe_sk_search": "tools/probe_sk_v2.py:47 and tools/probe_sk_v3.py"
                           ":86 (launched at :208, :347)",
    }
    for name, replaces in probe_src.items():
        r = probes[name]
        source = (csrc + "dg_fwd.cu + " + csrc + "dg_search.cuh"
                  if name == "probe_sk_search" else csrc + "probes.cu")
        kernels.append(row(name, source, replaces, r["launches"], r["errs"],
                           r["tally"], library_ms=r["library_ms"],
                           **r["extra"]))
    # BatchNorm1d's training kernels (phase 13): no TPU kernel behind them
    for name, (launches, e, t) in bn_report.items():
        kernels.append(row(
            name, csrc + "bn.cu", "none: the JAX BatchNorm1d "
            "(spconv_tpu/modules/modules.py:208) is plain jnp that XLA "
            "fuses", launches, e, t))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched on its "
              "path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
