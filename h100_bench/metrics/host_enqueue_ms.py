"""``host_enqueue_ms.<loop>``: the median host time from a call (a
request, or a step: forward, loss, backward and update) until it
returns, before its sync, over the window's calls, in ms: the Python
front end's enqueue (the modules, the ops' dispatch, the launches).
Moves the serving tail or the scans trained a second."""

import statistics


def read(ctx):
    return 1e3 * statistics.median(ctx.window.enqueue_s)
