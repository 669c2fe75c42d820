"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the weights, the plan, the engine, the state's
import and the first steps."""


def read(win):
    return win.setup_s
