"""PyTorch/CUDA port of alphafive_tpu (lockstep Gomoku self-play with a
batched array MCTS and a residual policy-value net).

Each module mirrors the path of its JAX counterpart under
``alphafive_tpu/``, which stays the reference. This package imports torch,
numpy and the standard library only — never jax, flax or msgpack — so it
runs on a host that has none of them. The fused residual block runs as a
hand-written CUDA kernel (``csrc/resblock.cu``) on CUDA tensors and as its
plain PyTorch version on CPU tensors.
"""
