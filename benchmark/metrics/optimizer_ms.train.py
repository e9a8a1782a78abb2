"""Device milliseconds a train step in the kernels under torch's own
``Optimizer.step#AdamW.step`` range, in the traced span."""

NAME = "Optimizer.step#AdamW.step"


def read(ctx):
    if ctx.kind != "train" or not ctx.span.ops.get(NAME):
        return None
    return 1e3 * ctx.span.ops[NAME] / ctx.span.steps
