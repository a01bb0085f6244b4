"""selfplay_ms_per_iter.train (ms): train/actor.py::selfplay_record (the
Gumbel root) between synchronises, over the traced window, per
iteration.
"""

from perfbench import readers


def read(run):
    return readers.timer_ms_per_unit(run, "selfplay")
