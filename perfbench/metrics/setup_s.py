"""setup_s (s): process start to the start of the window: imports, the
kernel library (built on a checkout's first run), the weights, the
program's state and the warm-up of the cell's shapes.
"""


def read(run):
    return run.setup_s
