"""nbt_gpool_roofline.selfplay (%): the least time of the work of
ops/katago_nbt.py::gpool_pair that the configuration needs (calls a forward x
positions, from shapes: archs/katago_nbt.py::kernel_work) over the device
time launched inside the benchmark's span `nbt_gpool` around it, in the
profiled sub-window.
"""

from perfbench import readers


def read(run):
    return readers.roofline(run, "nbt_gpool")
