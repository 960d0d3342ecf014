"""Fixpoint loop: microseconds of device idle a step that the span stretch
charges to ``fixpoint.step`` and the spans it holds (the host's work
before and around the step's launches)."""

from portbench import spans


def read(ctx):
    return spans.step_idle_us(ctx.span_trace)
