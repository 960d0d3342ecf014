"""Fixpoint loop: microseconds of device idle a step that the span stretch
charges to ``fixpoint.converged`` (the convergence test and its
readback)."""

from portbench import spans


def read(ctx):
    return spans.flag_idle_us(ctx.span_trace)
