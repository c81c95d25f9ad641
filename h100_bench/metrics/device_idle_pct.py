"""``device_idle_pct.<loop>``: the share of a call in which no device op
runs, in %: one minus the device's busy time a call, the union of the
device ops' intervals in the profiled part (device activity alone) over
its calls, over the time a call takes in the window, which runs without
the profiler (its seconds on the host clock over its calls).  The
profiler slows the host, so a part's own length would count its cost as
idle.  Moves the loop's scans a second."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_s / len(ctx.trace.slots)
    return 100.0 * (1.0 - busy / (ctx.window.seconds / ctx.window.count))
