"""Operand build: seconds of the ``build.encode`` stages under the try that
built the operand, from the program's spans recorded around the build in
set-up (traced runs only)."""

from portbench import spans


def read(ctx):
    return spans.build_encode_s(ctx.build_spans) if ctx.build_spans is not None else None
