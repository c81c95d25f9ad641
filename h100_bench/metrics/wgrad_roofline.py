"""``wgrad_roofline``: kernel B3's weight gradient (``csrc/dg_wgrad.cu``,
with its fixed-order reduce) against its roofline in a training step, in
%: the summed least time of every conv's weight gradient
(``harness/work.py``) over the profiled part's steps, over the device
time of the wgrad kernels there.  Moves ``train_scans_per_s``."""

from h100_bench.harness import work as W

KERNELS = ("dg_wgrad_bf16_kernel", "dg_wgrad_f32_kernel",
           "dg_wgrad_reduce_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    bound = sum(W.bound_s_of(ctx.work[s], ["wgrad"], ctx.dtype)
                for s in ctx.trace.slots)
    return 100.0 * bound / t
