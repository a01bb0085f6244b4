"""device_idle_share.selfplay (%): the share of the profiled sub-window in
which no operation ran on the device (1 - the union of its operations'
intervals over the wall time).
"""

from perfbench import readers


def read(run):
    return readers.idle_share(run)
