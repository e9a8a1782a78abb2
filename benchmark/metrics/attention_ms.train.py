"""Device milliseconds a train step in the kernels under the program's
``msclip.attention.fwd`` and ``msclip.attention.bwd`` spans (each block's
attention core, forward and backward, whatever implementation runs it),
in the traced span.

A range's device time counts twice each kernel that torch.profiler also
appends to a ``Command Buffer Full`` record, made when the launch queue
fills. On an H100 the train cell's traced steps held 0-0.26 ms a step of
such records, under 0.1% of its 292 ms step."""

NAMES = ("msclip.attention.fwd", "msclip.attention.bwd")


def read(ctx):
    if ctx.kind != "train" or not all(ctx.span.ops.get(n) for n in NAMES):
        return None
    return 1e3 * sum(ctx.span.ops[n] for n in NAMES) / ctx.span.steps
