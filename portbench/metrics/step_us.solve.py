"""Fixpoint loop: microseconds a step, the window's solves' wall time over
their steps (host clock, tracing off)."""


def read(ctx):
    steps = sum(ctx.iterations)
    return sum(ctx.solve_s) / steps * 1e6 if steps else None
