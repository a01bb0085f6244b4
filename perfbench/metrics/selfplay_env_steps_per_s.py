"""selfplay_env_steps_per_s (env-steps/s): every env-step of every ply
completed in the window over the window's seconds.
"""

from perfbench import readers


def read(run):
    return readers.rate(run, "env_steps")
