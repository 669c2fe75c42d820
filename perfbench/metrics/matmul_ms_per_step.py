"""Device ms a step of the cuBLAS products (the model layers'
projections, MLP and head), forward, recompute and backward."""

from perfbench.trace import kind


def read(ctx):
    return ctx.per_step_ms(lambda n: kind(n) == "matmul")
