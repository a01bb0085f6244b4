"""mfu.play (%): the FLOPs the configuration needs in the traced window
(positions x net_flops, and 3 x net_flops a learner row) over the
window's wall seconds and 989 TFLOP/s (bf16, dense).
"""

from perfbench import readers


def read(run):
    return readers.mfu(run)
