"""Fixpoint loop: the mean of the window's solves' step counts
(``FixpointResult.iterations``)."""


def read(ctx):
    return sum(ctx.iterations) / len(ctx.iterations) if ctx.iterations else None
