"""Device ms a step of the elementwise work: norms, activations, the
conv, rotary embeddings, the loss and Adam's passes."""

from perfbench.trace import kind


def read(ctx):
    return ctx.per_step_ms(lambda n: kind(n) == "elementwise")
