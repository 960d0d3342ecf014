"""SpMV entry: microseconds of device time a call of the ops launched
inside ``spmv.fold`` (the fold of the kernel's output), on the span
stretch's trace."""

from portbench import spans


def read(ctx):
    return spans.fold_device_us(ctx.span_trace)
