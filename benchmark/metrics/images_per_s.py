"""Every image scored in the window over the window's seconds, from a
synchronised start to the synchronise that ends it, on the host clock."""


def read(ctx):
    if ctx.kind != "eval":
        return None
    return ctx.outcome.items / ctx.outcome.window_s
