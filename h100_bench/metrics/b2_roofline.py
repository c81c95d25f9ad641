"""``b2_roofline.<loop>``: kernel B2 (``csrc/dg_fwd.cu``, which runs both
the forward and the input gradient) against its roofline, in %: the
summed least time (``harness/work.py``) of every conv's forward, and in
training its input gradient, over the profiled part's calls, over the
device time of B2's kernels there.  Moves the loop's scans a second."""

from h100_bench.harness import work as W

KERNELS = ("dg_fwd_bf16_kernel", "dg_fwd_f32_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_s(KERNELS)
    if t <= 0:
        return None
    passes = [p for p in ctx.passes if p in ("forward", "dgrad")]
    bound = sum(W.bound_s_of(ctx.work[s], passes, ctx.dtype)
                for s in ctx.trace.slots)
    return 100.0 * bound / t
