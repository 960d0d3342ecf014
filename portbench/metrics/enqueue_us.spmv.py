"""SpMV entry: microseconds the host takes to enqueue one ``spmv`` call,
the median over bursts of calls issued from an idle queue, each timed by
the host clock with no synchronise inside it."""

import statistics


def read(ctx):
    return statistics.median(ctx.enqueue_s) * 1e6 if ctx.enqueue_s else None
