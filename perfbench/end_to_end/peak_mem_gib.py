"""The most device memory the program held at once, over set-up and the
window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(win):
    return win.peak_bytes / 2 ** 30
