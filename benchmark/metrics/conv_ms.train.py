"""Device milliseconds a train step in the kernels under torch's
convolution ops, forward (``aten::convolution``) and backward
(``aten::convolution_backward``), in the traced span."""


def read(ctx):
    if ctx.kind != "train":
        return None
    ops = ctx.span.ops
    if "aten::convolution" not in ops:
        return None
    seconds = ops["aten::convolution"] + ops.get(
        "aten::convolution_backward", 0.0)
    return 1e3 * seconds / ctx.span.steps
