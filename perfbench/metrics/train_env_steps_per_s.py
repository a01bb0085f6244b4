"""train_env_steps_per_s (env-steps/s): num_envs x plies of every training
iteration (self-play, ring write, learner steps) completed in the window
over the window's seconds.
"""

from perfbench import readers


def read(run):
    return readers.rate(run, "env_steps")
