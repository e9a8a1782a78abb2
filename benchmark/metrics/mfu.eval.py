"""The eval step's share of the cards' bf16 peak over the traced span:
images scored times the operations an image (``flops.py``), over the
span's seconds and the cards' peak."""

from benchmark import flops


def read(ctx):
    if ctx.kind != "eval" or ctx.peaks is None:
        return None
    images = ctx.span.steps * ctx.traffic["batch"]
    work = images * flops.eval_flops_per_image(ctx.arch,
                                               ctx.traffic["classes"])
    return 100.0 * work / (ctx.span.window_s * ctx.peaks["bf16_flops"]
                           * ctx.chips)
