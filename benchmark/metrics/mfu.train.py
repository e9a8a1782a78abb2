"""The train step's share of the cards' bf16 peak over the traced span:
samples trained times three times their forward operations
(``flops.py``; recomputation not counted), over the span's seconds and
the cards' peak."""

from benchmark import flops


def read(ctx):
    if ctx.kind != "train" or ctx.peaks is None:
        return None
    batch = ctx.traffic["batch"] * ctx.chips
    work = ctx.span.steps * batch * flops.train_flops_per_sample(ctx.arch,
                                                                 batch)
    return 100.0 * work / (ctx.span.window_s * ctx.peaks["bf16_flops"]
                           * ctx.chips)
