"""Device ms a step of copies: the loopback substrate's gathers and
scatters of ragged shards, casts, concatenations and memsets."""

from perfbench.trace import kind


def read(ctx):
    return ctx.per_step_ms(lambda n: kind(n) == "copy")
