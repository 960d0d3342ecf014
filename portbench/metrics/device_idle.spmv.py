"""Device: the share of the device stretch of SpMV calls in which no
device operation runs (torch.profiler's timeline)."""

from portbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.window_s)
