"""resblock_roofline.selfplay (%): the least time of the residual blocks'
work the configuration needs (blocks x positions, from shapes) over the
device time launched inside the benchmark's span around
ops/resblock.py::fused_resblock (the tap pack included), in the profiled
sub-window.
"""

from perfbench import readers


def read(run):
    return readers.roofline(run)
