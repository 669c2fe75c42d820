"""The share of the traced steps in which no operation ran on the card
(layer: the device).  Moves train_tokens_per_s: what the card waits for,
the step waits for."""


def read(ctx):
    w = ctx.window
    return 100.0 * (1.0 - w.busy_s / w.window_s)
