"""Operand build: host seconds around the program's build call in set-up
(``build_operand_auto`` or ``fixpoint_components``), to a synchronise."""


def read(ctx):
    return ctx.build_s if ctx.build_s > 0 else None
