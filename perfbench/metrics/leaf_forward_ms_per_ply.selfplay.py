"""leaf_forward_ms_per_ply.selfplay (ms): the evaluator's leaf-batch calls
(models/evaluator.py::net_evaluator; the root calls, at a batch of
num_envs, apart) between synchronises, over the traced window, per ply.
"""

from perfbench import readers


def read(run):
    return readers.timer_ms_per_unit(run, "leaf_forward")
