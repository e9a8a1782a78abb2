"""The 90th percentile of every window step's milliseconds: the gaps
between the CUDA events recorded at consecutive step ends (the first
process's, on several cards)."""

from benchmark.peaks import percentile


def read(ctx):
    return 1e3 * percentile(ctx.outcome.step_s, 90)
