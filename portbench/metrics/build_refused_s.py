"""Operand build: seconds of the ``build.try`` spans whose variant refused
the matrix, from the program's spans recorded around the build in set-up
(traced runs only)."""

from portbench import spans


def read(ctx):
    return spans.build_refused_s(ctx.build_spans) if ctx.build_spans is not None else None
