"""Device milliseconds a train step in the backward's kernels, in the
traced span: the sum over autograd's node ranges
(``autograd::engine::evaluate_function: <node>``). On the card autograd
launches the backward's kernels from its own device thread, and the
profiler charges a kernel to the ranges of the thread that launched it,
so the program's ``msclip.train.backward`` span on the calling thread
holds none of them; the node ranges do not nest, and every kernel of the
backward lies under one of them.

A range's device time counts twice each kernel that torch.profiler also
appends to a ``Command Buffer Full`` record, made when the launch queue
fills. On an H100 the train cell's traced steps held 0-0.26 ms a step of
such records, under 0.1% of its 292 ms step."""

PREFIX = "autograd::engine::evaluate_function:"


def read(ctx):
    if ctx.kind != "train":
        return None
    seconds = sum(s for key, s in ctx.span.ops.items()
                  if key.startswith(PREFIX))
    if not seconds:
        return None
    return 1e3 * seconds / ctx.span.steps
