"""move_s.play (s): the window's seconds over the AI moves completed in
it, what a player waits a move; in the traced run, whose window's timers
synchronise around each evaluation.
"""


def read(run):
    moves = run.totals.get("moves")
    return run.elapsed / moves if moves else None
