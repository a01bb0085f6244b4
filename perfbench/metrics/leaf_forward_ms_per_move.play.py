"""leaf_forward_ms_per_move.play (ms): all the evaluator's calls of a move
(root and leaves) between synchronises, over the traced window, per
move.
"""

from perfbench import readers


def read(run):
    return readers.timer_ms_per_unit(run, "forward")
