"""Training throughput: every token of every whole step in the window,
over the time from the window's synchronised start to the end of its
last step."""


def read(win):
    return win.tokens / win.seconds
