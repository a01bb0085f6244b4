"""The data-parallel actor-learner iteration over ``torch.distributed``,
one rank per GPU (port of ``alphafive_tpu/parallel/``): ``mesh.py`` is
the iteration, ``distributed.py`` the process group and its helpers."""

from alphafive_tpu_torch.parallel.mesh import (TrainCarry, init_carry,
                                               make_train_iteration)

__all__ = ["TrainCarry", "init_carry", "make_train_iteration"]
