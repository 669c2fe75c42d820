"""Model FLOPs utilisation, in %: the window's model FLOPs (recompute not
counted) over its time and the card's bf16 dense peak."""


def read(win):
    return 100.0 * win.flops / win.seconds / win.peaks["bf16_flop_s"]
