"""learner_ms_per_iter.train (ms): parallel/mesh.py::learner_phase between
synchronises, over the traced window, per iteration.
"""

from perfbench import readers


def read(run):
    return readers.timer_ms_per_unit(run, "learner")
