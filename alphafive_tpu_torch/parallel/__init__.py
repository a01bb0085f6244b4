"""The actor-learner iteration on one device (port of
``alphafive_tpu/parallel/``; the multi-device program is ROADMAP Queue 1
item 15)."""

from alphafive_tpu_torch.parallel.mesh import (TrainCarry, init_carry,
                                               make_train_iteration)

__all__ = ["TrainCarry", "init_carry", "make_train_iteration"]
