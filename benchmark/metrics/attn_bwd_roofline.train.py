"""The attention backward's least time over its kernel's device time in
the traced span of a train cell: each image block's core and each causal
text block's at the cell's batch (``flops.attention_bwd_cost``), against
the device time of the kernels named ``attention_bwd``."""

from benchmark import flops


def read(ctx):
    if ctx.kind != "train" or ctx.peaks is None:
        return None
    seconds, records = ctx.kernel_seconds("attention_bwd")
    if not records:
        return None
    a, pk, b = ctx.arch, ctx.peaks, ctx.traffic["batch"]
    image = flops.roofline_seconds(
        flops.attention_bwd_cost(b, a.seq, a.width, a.heads, False),
        pk["bf16_flops"], pk["hbm_bytes"])
    text = flops.roofline_seconds(
        flops.attention_bwd_cost(b, a.context, a.text_width, a.text_heads,
                                 True), pk["bf16_flops"], pk["hbm_bytes"])
    least = ctx.span.steps * (a.attention_blocks * image
                              + a.text_layers * text)
    return 100.0 * least / seconds
