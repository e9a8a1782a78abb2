"""The attention forward's least time over its kernel's device time in
the traced span of an eval cell: each image-tower block's core at the
cell's batch and sequence (``flops.attention_fwd_cost``), against the
device time of the kernels named ``attention_fwd``."""

from benchmark import flops


def read(ctx):
    if ctx.kind != "eval" or ctx.peaks is None:
        return None
    seconds, records = ctx.kernel_seconds("attention_fwd")
    if not records:
        return None
    a, pk = ctx.arch, ctx.peaks
    cost = flops.attention_fwd_cost(ctx.traffic["batch"], a.seq, a.width,
                                    a.heads, causal=False)
    least = ctx.span.steps * a.attention_blocks * flops.roofline_seconds(
        cost, pk["bf16_flops"], pk["hbm_bytes"])
    return 100.0 * least / seconds
