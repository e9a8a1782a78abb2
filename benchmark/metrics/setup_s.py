"""Seconds from the process's start (the launcher's, on several cards) to
the first timed step: imports, the draw, the program's load, the warm-up
of the cell's shapes."""


def read(ctx):
    return ctx.outcome.setup_s
