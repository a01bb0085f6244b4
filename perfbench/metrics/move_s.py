"""move_s (s): the window's seconds over the AI moves completed in it.
"""


def read(run):
    moves = run.totals.get("moves")
    return run.elapsed / moves if moves else None
