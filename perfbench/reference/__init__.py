"""The plain reference that decides each run's ``correct``.

Written from the equations of the system under test, in plain PyTorch
(f32, TF32 off) and NumPy, and independent of it: nothing here imports
``jax``, the JAX package or ``alphafive_tpu_torch``.

* ``bundle``: reads a weights bundle (``config.json`` + flax's
  ``model.msgpack``) into numpy trees; the harness hands the same trees
  to the program and to the reference.
* ``net``: the residual policy-value net, its inference forward (batch
  norm by running statistics) and its training forward (batch
  statistics), in blocks of rows.
* ``rules``: one move of freestyle Gomoku or Renju (black's overline,
  double-four and double-three), one board at a time.
* ``learner``: the loss and one optimizer step (clip by global norm 1,
  Adam, decoupled weight decay on kernels, linear warm-up), and a batch
  built from ring rows under the board's symmetries.
* ``search``: the capped PUCT search, followed step by step from the
  program's record of it, and the one-pass Gumbel root.
"""
