"""SpMV entry: microseconds of device idle a call that the span stretch
charges to ``spmv`` and the spans it holds (the host's work in the entry
while the device waits)."""

from portbench import spans


def read(ctx):
    return spans.entry_idle_us(ctx.span_trace)
