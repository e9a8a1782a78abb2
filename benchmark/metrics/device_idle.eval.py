"""The share of the traced span of an eval cell in which no operation ran
on the card."""


def read(ctx):
    if ctx.kind != "eval":
        return None
    return 100.0 * (1.0 - ctx.span.busy_s / ctx.span.window_s)
