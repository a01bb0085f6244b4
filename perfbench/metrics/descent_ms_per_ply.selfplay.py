"""descent_ms_per_ply.selfplay (ms): the capped search's descent
(mcts/search_capped.py::_select_lanes) between synchronises, over the
traced window, per ply.
"""

from perfbench import readers


def read(run):
    return readers.timer_ms_per_unit(run, "descent")
