"""Kernels: the share of the SpMV's bound (``work.py``: the matrix's folded
values, x and the output once, over 3.35 TB/s) in the device time of the
operations launched inside the range stretch's ``spmv`` calls."""

from portbench import trace


def read(ctx):
    if ctx.range_trace is None or not ctx.traced_calls:
        return None
    busy = trace.device_s(ctx.range_trace, ("spmv",))
    return 100.0 * ctx.traced_calls * ctx.bound_s / busy if busy else None
