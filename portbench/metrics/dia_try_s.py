"""Operand build: seconds of the ``build.try`` spans whose variant is
``dia``, from the program's spans recorded around the build in set-up
(traced runs only): the guard's refusal where ``auto`` passes dia by, the
guard and the whole build where it takes it, and 0 where ``auto`` built a
variant before it reached dia. None for a program whose ``auto`` chain has
no dia."""


def read(ctx):
    from sparseharness_tpu_torch.ops.registry import AUTO_CHAIN

    if ctx.build_spans is None or "dia" not in AUTO_CHAIN:
        return None
    tries = [s for s in ctx.build_spans if s.name == "build.try"]
    if not tries:
        return None
    return sum(s.seconds for s in tries if s.attrs.get("variant") == "dia")
