"""``mfu.<loop>`` (``mfu.serve``, ``mfu.train``): the whole request's or
step's share of the card's peak, in %: the operations of every conv
product the loop kind runs (``2 * C * K`` a matched pair, counted by the
reference's rulebook on each call's own coordinates; a step's first conv
has no input gradient), summed over the window's calls, over the
window's seconds on the host clock, over the peak rate of the served
dtype.  Moves the loop's scans a second."""

from h100_bench.harness import work as W


def read(ctx):
    done = sum(W.pass_ops(ctx.work[s], ctx.passes) for s in ctx.window.slots)
    return 100.0 * done / (ctx.window.seconds * W.PEAK_OPS[ctx.dtype])
