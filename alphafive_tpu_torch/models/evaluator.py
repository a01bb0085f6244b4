"""Leaf evaluators for the array MCTS (port of
``alphafive_tpu/models/evaluator.py``).

An evaluator maps ``(board int8[E, A], to_play int8[E], last int32[E])`` to
``(logits f32[E, A], value f32[E])``. JAX's evaluators also take a PRNG
key; neither of the two ported here uses one, so the port drops it.
``rollout_evaluator`` is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from alphafive_tpu_torch.config import EnvConfig, NetConfig
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.models.resnet import (FusedPolicyValueNet,
                                               PolicyValueNet)


def net_evaluator(env_cfg: EnvConfig, net_cfg: NetConfig, params,
                  batch_stats, device="cpu") -> Callable:
    """Policy-value-net leaf evaluator. ``net_cfg.use_pallas`` selects the
    fused forward (the resblock kernel on CUDA), as it selects the Pallas
    forward in the JAX package."""
    if net_cfg.use_pallas:
        model = FusedPolicyValueNet(env_cfg, net_cfg, params, batch_stats,
                                    device)
    else:
        model = PolicyValueNet.from_flax(env_cfg, net_cfg, params,
                                         batch_stats, device)

    def evaluate(board, to_play, last):
        return model(vector.features(env_cfg, board, to_play, last))

    return evaluate


def uniform_evaluator(env_cfg: EnvConfig) -> Callable:
    """Uniform legal priors, zero values (structural tests)."""

    def evaluate(board, to_play, last):
        e = board.shape[0]
        return (torch.zeros((e, env_cfg.num_actions), dtype=torch.float32,
                            device=board.device),
                torch.zeros((e,), dtype=torch.float32, device=board.device))

    return evaluate
