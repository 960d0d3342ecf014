"""Kernels: the share of the steps' bound (steps × the SpMV bound of
``work.py``) in the device time of the operations launched inside the
traced fixpoint steps."""

from portbench import trace


def read(ctx):
    if ctx.range_trace is None or not ctx.traced_steps:
        return None
    busy = trace.device_s(ctx.range_trace, ("fixpoint.step",))
    return 100.0 * ctx.traced_steps * ctx.bound_s / busy if busy else None
