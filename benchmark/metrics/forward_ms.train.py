"""Device milliseconds a train step in the kernels under the program's
``msclip.train.forward`` span (both towers and the loss), in the traced
span.

A range's device time counts twice each kernel that torch.profiler also
appends to a ``Command Buffer Full`` record, made when the launch queue
fills. On an H100 the train cell's traced steps held 0-0.26 ms a step of
such records, under 0.1% of its 292 ms step."""

NAME = "msclip.train.forward"


def read(ctx):
    if ctx.kind != "train" or not ctx.span.ops.get(NAME):
        return None
    return 1e3 * ctx.span.ops[NAME] / ctx.span.steps
